"""The port's checkpoints (repro_torch.checkpoint) against the
reference's format (repro.checkpoint): the port saves the reference's
stacked-layer tree (``convert.to_reference``), so a checkpoint written
by either package restores in the other bit for bit, and ``spec.json``
carries the reference's fields. The train launcher's ``--ckpt`` writes
one that restores to its final parameters."""
import json

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild_model

from repro_torch import checkpoint as tckpt
from repro_torch import convert, optim
from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models.model import build_model


@pytest.fixture(scope="module", params=["moe-gpt2", "hymba-1.5b"])
def trees(request):
    arch = request.param
    tcfg = reduced(get_config(arch))
    params = build_model(tcfg, device="cpu", seed=5).params
    jparams = jbuild_model(jreduced(jget_config(arch))).init(
        jax.random.PRNGKey(1))
    return tcfg, params, jax.tree.map(np.asarray, jparams)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_port_save_reference_restore(trees, tmp_path):
    cfg, params, jnp_params = trees
    ref_tree = convert.to_reference(params, cfg)
    # a small shard limit, so the leaves spread over several shards
    tckpt.save(str(tmp_path), ref_tree, step=7, shard_mb=1)
    assert len(list(tmp_path.glob("shard_*.npz"))) > 1
    got, step = jckpt.restore(str(tmp_path), jnp_params)
    assert step == 7
    want = _leaves(ref_tree)
    got = _leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_reference_save_port_restore(trees, tmp_path):
    cfg, params, jnp_params = trees
    jckpt.save(str(tmp_path), jnp_params, step=3, shard_mb=1)
    like = convert.to_reference(params, cfg)
    got, step = tckpt.restore(str(tmp_path), like)
    assert step == 3
    for a, b in zip(_leaves(got), _leaves(jnp_params)):
        np.testing.assert_array_equal(a, b)
    port = convert.from_reference(got, cfg, device="cpu")
    want = convert.from_reference(jnp_params, cfg, device="cpu")
    for (pa, a), (pb, b) in zip(_port_leaves(port), _port_leaves(want)):
        assert pa == pb and torch.equal(a, b)
    # restore straight onto a device: tensors, the same bits
    on_dev, _ = tckpt.restore(str(tmp_path), like, device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in _flat(on_dev))
    for a, b in zip(_flat(on_dev), _leaves(jnp_params)):
        np.testing.assert_array_equal(a.numpy(), b)


def _port_leaves(tree):
    return list(optim.leaves_with_path(tree))


def _flat(tree):
    return [leaf for _, leaf in tckpt._flatten(tree)]


def test_spec_json_matches_reference_fields(trees, tmp_path):
    cfg, params, _ = trees
    ref_tree = convert.to_reference(params, cfg)
    tckpt.save(str(tmp_path / "port"), ref_tree, step=2)
    jckpt.save(str(tmp_path / "ref"), ref_tree, step=2)
    ours = json.loads((tmp_path / "port" / "spec.json").read_text())
    ref = json.loads((tmp_path / "ref" / "spec.json").read_text())
    assert ours == ref
    assert set(ours) == {"step", "leaves"}
    for e in ours["leaves"]:
        assert set(e) == {"name", "key", "shard", "dtype", "shape", "pspec"}
        assert e["pspec"] is None
    with np.load(tmp_path / "port" / "shard_0.npz") as z, \
            np.load(tmp_path / "ref" / "shard_0.npz") as w:
        assert sorted(z.files) == sorted(w.files)
        for k in z.files:
            np.testing.assert_array_equal(z[k], w[k])


def test_train_launcher_ckpt_restores_final_params(tmp_path, monkeypatch):
    saved = []
    orig = tckpt.save

    def record(path, tree, **kw):
        saved.append((kw["step"], [np.array(x) for x in _flat(tree)]))
        return orig(path, tree, **kw)

    monkeypatch.setattr(tckpt, "save", record)
    res = ttrain.main(["--reduced", "--steps", "2", "--seq-len", "128",
                       "--global-batch", "2", "--device", "cpu",
                       "--ckpt", str(tmp_path), "--ckpt-every", "1"])
    assert [s for s, _ in saved] == [1, 2, 2]
    cfg = res["cfg"]
    like = convert.to_reference(build_model(cfg, device="cpu").params, cfg)
    got, step = jckpt.restore(str(tmp_path), like)
    assert step == 2
    for a, b in zip(_leaves(got), saved[-1][1]):
        np.testing.assert_array_equal(a, b)
    params = convert.from_reference(tckpt.restore(str(tmp_path), like)[0],
                                    cfg)
    fresh = build_model(cfg, device="cpu").params
    changed = [not torch.equal(a, b) for (_, a), (_, b) in
               zip(_port_leaves(params), _port_leaves(fresh))]
    assert any(changed)          # the checkpoint holds trained weights
