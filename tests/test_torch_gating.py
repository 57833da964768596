"""repro_torch.core.gating against repro.core.gating: routing and
dispatch positions bitwise (ties included), gate weights and the aux
loss within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gating as jg
from repro_torch.core import gating as tg


def _inputs(seed, T=64, d=32, E=8, tie=False):
    r = np.random.default_rng(seed)
    x = r.standard_normal((T, d)).astype(np.float32)
    w = (r.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    if tie:
        # experts 2 and 5 get the same column: every token's two probs
        # are exactly equal, so top-k must break the tie toward 2
        w[:, 5] = w[:, 2]
    return x, w


def _both(x, w, k):
    got = tg.gate_apply({"w_gate": torch.as_tensor(w)}, torch.as_tensor(x), k)
    want = jg.gate_apply({"w_gate": jnp.asarray(w)}, jnp.asarray(x), k)
    return got, want


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("tie", [False, True])
def test_gate_apply(k, tie):
    x, w = _inputs(k + 10 * tie, tie=tie)
    got, want = _both(x, w, k)
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    np.testing.assert_allclose(got.gate_weights.numpy(),
                               np.asarray(want.gate_weights), atol=1e-6)
    np.testing.assert_allclose(got.router_probs.numpy(),
                               np.asarray(want.router_probs), atol=1e-6)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               atol=1e-6)


def test_exact_tie_breaks_toward_lower_index():
    x, w = _inputs(7, tie=True)
    got, want = _both(x, w, 8)
    idx = got.expert_idx.numpy()
    np.testing.assert_array_equal(idx, np.asarray(want.expert_idx))
    # wherever both tied experts are chosen, 2 precedes 5
    for row in idx:
        where = {int(e): i for i, e in enumerate(row)}
        assert where[2] < where[5]


@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_positions_and_load(k):
    x, w = _inputs(3, T=96, E=4)
    got, want = _both(x, w, k)
    keep = np.random.default_rng(5).random((96, k)) > 0.2
    pos = tg.dispatch_positions(got.expert_idx, torch.as_tensor(keep), 4)
    pos_ref = jg.dispatch_positions(want.expert_idx, jnp.asarray(keep), 4)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_ref))
    load = tg.expert_load(got.expert_idx, torch.as_tensor(keep), 4)
    load_ref = jg.expert_load(want.expert_idx, jnp.asarray(keep), 4)
    np.testing.assert_array_equal(load.numpy(), np.asarray(load_ref))
