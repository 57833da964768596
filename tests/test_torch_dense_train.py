"""Training the dense f32 archs in the port against the JAX reference, on
the CPU: internvl2-2b (a decoder whose batch puts a prefix of patch
embeddings before its tokens), seamless-m4t-large-v2 (an
encoder-decoder whose batch carries encoder frames) and rwkv6-3b (the
WKV6 recurrence; its plain backward is held to ``jax.grad`` in
``test_torch_rwkv.py``).

Reduced configs (2 layers, d 256) computing in f32 (the archs' bf16
compute rounds at other points in the two frameworks: reduced internvl2's
loss differs by 7.7e-4 at bf16), the reference's own weights carried
across by ``repro_torch.convert``. Tolerances: the synthetic batches bit
for bit; the train forward's loss within 1e-5 and every gradient leaf
within 1e-4 of ``jax.grad``'s by its relative norm error (the two
frameworks sum their products in another order); three AdamW steps of
the two launchers at the same flags, both given the f32-compute config,
each loss within 1e-4. The port's side runs on one torch thread
(``test_torch_archs.py``'s fixture).
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import LuffyConfig as JLuffy
from repro.config import ShapeConfig as JShape
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import single_device
from repro.launch import train as jlaunch
from repro.models import model as jmodel
from repro.models import transformer as jtf

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.config import LuffyConfig, ShapeConfig, reduced
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf

from test_torch_archs import _one_torch_thread  # noqa: F401

PREFIX, ENCDEC, RWKV = "internvl2-2b", "seamless-m4t-large-v2", "rwkv6-3b"
B, S = 2, 32
LAUNCH = ["--reduced", "--steps", "3", "--seq-len", str(S),
          "--global-batch", str(B), "--mesh", "none", "--optimizer",
          "adamw"]


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _cfgs(arch):
    return (_f32(jreduced(jget_config(arch), seq_len_hint=S)),
            _f32(reduced(get_config(arch), seq_len_hint=S)))


@pytest.mark.parametrize("arch", [PREFIX, ENCDEC, RWKV])
def test_synthetic_batches_match_reference(arch):
    """``SyntheticLM`` draws the reference's batches bit for bit: keys,
    dtypes, shapes and values, over two steps (internvl2's prefix [B, 8,
    256] and tokens cut to S - 8 with the first 8 labels ignored;
    seamless's enc_input [B, S, 256])."""
    jcfg, tcfg = _cfgs(arch)
    want = JSyntheticLM(jcfg, JShape("train", S, B, "train"))
    got = SyntheticLM(tcfg, ShapeConfig("train", S, B, "train"))
    extra = {PREFIX: "prefix", ENCDEC: "enc_input", RWKV: None}[arch]
    for step in (0, 5):
        w, g = want.batch(step), got.batch(step)
        assert set(g) == set(w) == ({"tokens", "labels", "seq_len"}
                                    | ({extra} if extra else set()))
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if arch == PREFIX:
        P = tcfg.prefix_slots
        assert g["prefix"].shape == (B, P, tcfg.prefix_dim)
        assert g["tokens"].shape == (B, S - P)
        assert (g["labels"][:, :P] == -1).all()


_GRADS = {}


def _grads(arch):
    """The f32 train forward's loss and gradients through both frameworks
    on the reference's synthetic batch of step 0 (cached a module)."""
    if arch in _GRADS:
        return _GRADS[arch]
    jcfg, tcfg = _cfgs(arch)
    params = jmodel.build_model(jcfg).init(jax.random.PRNGKey(3))
    batch = JSyntheticLM(jcfg, JShape("train", S, B, "train")).batch(0)
    jl = JLuffy(enable_condensation=False, enable_migration=False,
                use_kernels=False)

    def f(p):
        return jtf.forward_train(p, jcfg, jl, single_device(),
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jnp.float32(0.5), 8)

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    tparams = convert.from_reference(jax.tree.map(np.asarray, params), tcfg)
    leaves = jax.tree_util.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = ttf.forward_train(
        tparams, tcfg, LuffyConfig(enable_condensation=False,
                                   enable_migration=False),
        {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.tensor(0.5), 8)
    loss.backward()
    want = jax.tree_util.tree_leaves(convert.from_reference(
        jax.tree.map(np.asarray, j_grads), tcfg))
    _GRADS[arch] = (float(j_loss), loss.item(), set(metrics), want,
                    [t.grad for t in leaves])
    return _GRADS[arch]


@pytest.mark.parametrize("arch", [PREFIX, ENCDEC])
def test_forward_train_loss_matches_reference(arch):
    """The loss within 1e-5 of the reference's ``forward_train`` (the
    prefix's positions line up with the ignored labels; the encoder runs
    over the frames); a dense step's metrics are the loss alone."""
    j_loss, t_loss, keys, _, _ = _grads(arch)
    np.testing.assert_allclose(t_loss, j_loss, atol=1e-5, rtol=1e-5)
    assert keys == {"loss"}


@pytest.mark.parametrize("arch", [PREFIX, ENCDEC])
def test_forward_train_grads_match_jax_grad(arch):
    """Every gradient leaf (``prefix_proj`` included, which only the
    prefix or the encoder reaches) within 1e-4 of jitted ``jax.grad``'s
    by its relative norm error."""
    _, _, _, want, got = _grads(arch)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        err = (g - w).norm() / max(w.norm().item(), 1e-12)
        assert err.item() < 1e-4, (tuple(w.shape), err.item())


@pytest.mark.parametrize("arch", [PREFIX, ENCDEC, RWKV])
def test_launcher_losses_match_reference_launcher(arch, monkeypatch,
                                                  tmp_path):
    """``repro_torch.launch.train --device cpu`` against ``python -m
    repro.launch.train`` at the same flags (3 AdamW steps, reduced, one
    device), both launchers given the arch's config computing in f32 and
    the port starting from the reference's initial weights:
    each step's loss within 1e-4. The port's step records carry no MoE
    field and the step time and tokens/s."""
    inits = []

    class Spy:
        def __init__(self, m):
            self._m = m

        def __getattr__(self, name):
            return getattr(self._m, name)

        def init(self, key):
            inits.append(self._m.init(key))
            return inits[-1]

    get_j, get_t = jconfigs.get_config, tconfigs.get_config
    monkeypatch.setattr(jconfigs, "get_config", lambda a: _f32(get_j(a)))
    monkeypatch.setattr(tconfigs, "get_config", lambda a: _f32(get_t(a)))
    build_j = jmodel.build_model
    monkeypatch.setattr(jmodel, "build_model", lambda cfg: Spy(build_j(cfg)))
    log = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, *LAUNCH,
                                      "--log-file", str(log)])
    jlaunch.main()
    want = [r["metrics"]["train/loss"] for r in json.loads(log.read_text())]
    assert len(inits) == 1

    build_t = tmodel.build_model
    monkeypatch.setattr(tmodel, "build_model", lambda cfg, device, seed:
                        build_t(cfg, device=device, params=convert
                                .from_reference(jax.tree.map(
                                    np.asarray, inits[0]), cfg)))
    res = tlaunch.main(["--arch", arch, *LAUNCH, "--device", "cpu"])
    got = [r["loss"] for r in res["steps"]]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]
    for rec in res["steps"]:
        assert not {"bucket", "capacity", "condense_rate",
                    "dispatch_drop"} & set(rec)
        assert rec["step_ms"] > 0 and rec["tokens_per_s"] > 0
    assert all(not k.startswith(("moe/", "condense/", "migrate/", "plan/"))
               for k in res["log"][-1]["metrics"])
