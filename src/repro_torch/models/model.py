"""Public model API (counterpart of ``repro/models/model.py``):
``build_model(cfg, device=...)`` returns a :class:`Model`.

The parameters live in nested ``nn.ParameterDict`` / ``nn.ModuleDict`` /
``nn.ModuleList`` containers shaped like the reference's pytree (with the
layer stack unrolled), so ``state_dict`` names read
``layers.3.moe.experts.w_up``; :attr:`Model.params` gives the plain
nested-dict view the functional code takes. The parameters are
trainable (:meth:`Model.forward_train`); serving runs under
``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from repro_torch.config import LuffyConfig, ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.serve import engine


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (there is
    no silent fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    return dev


def _to_module(tree) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_to_module(t) for t in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _to_tree(mod: nn.Module):
    if isinstance(mod, nn.ModuleList):
        return [_to_tree(m) for m in mod]
    if isinstance(mod, nn.ParameterDict):
        return {k: v for k, v in mod.items()}
    return {k: _to_tree(m) for k, m in mod.items()}


class Model(nn.Module):
    """A decoder LM or an encoder-decoder: ``forward_train`` for
    training, ``prefill`` and ``decode_step`` for serving."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.tree = _to_module(params)

    @property
    def params(self) -> dict:
        return _to_tree(self.tree)

    @property
    def device(self) -> torch.device:
        return self.tree["embed"]["table"].device

    def new_cache(self, batch: int, s_max: int, enc_len: int = 0):
        """An empty decode cache (an encoder-decoder's with its cross K/V
        over ``enc_len`` encoder positions)."""
        return engine.cache_struct(self.cfg, batch, s_max, device=self.device,
                                   enc_len=enc_len)

    def admit_slot(self, cache, slot: int, position: int):
        """Recycle ``slot`` of ``cache`` for a request starting at
        ``position``; see :func:`repro_torch.serve.engine.admit_slot`."""
        return engine.admit_slot(cache, slot, position)

    def forward_train(self, batch, threshold, capacity: int, *,
                      luffy: LuffyConfig, dist=None, wire_ef=None):
        """(total loss, metrics) of one batch; see
        :func:`repro_torch.models.transformer.forward_train`."""
        return tf.forward_train(self.params, self.cfg, luffy, batch,
                                threshold, capacity, dist=dist,
                                wire_ef=wire_ef)

    @torch.inference_mode()
    def prefill(self, tokens, s_max: int, *, luffy: LuffyConfig, dist=None,
                plan_cache=None, prefix=None, enc_input=None):
        return engine.prefill(self.params, self.cfg, luffy, tokens, s_max,
                              dist, plan_cache=plan_cache, prefix=prefix,
                              enc_input=enc_input)

    @torch.inference_mode()
    def decode_step(self, cache, tokens, *, luffy: LuffyConfig,
                    plan_cache=None):
        return engine.decode_step(self.params, self.cfg, luffy, cache, tokens,
                                  plan_cache=plan_cache)


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0,
                params: Optional[Any] = None) -> Model:
    """A :class:`Model` on ``device`` (default CUDA, which must exist),
    with ``params`` when given (e.g. from :mod:`repro_torch.convert`),
    else random ones drawn from a generator seeded with ``seed`` on that
    device."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = tf.init_params(cfg, generator=gen, device=dev)
    return Model(cfg, params).to(dev)
