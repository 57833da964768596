"""Hand-written CUDA kernels of repro_torch against their plain PyTorch
versions, on the card. Marked ``gpu``: each test skips, from inside the
test, where there is no CUDA device. This file imports no JAX, so it
runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import expert_ffn as kexp
from repro_torch.kernels import ops, ref

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(E, R, d, F, seed=0):
    r = np.random.default_rng(seed)
    h = r.standard_normal((E, R, d)).astype(np.float32)
    ws = [(r.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((E, d, F), (E, d, F), (E, F, d))]
    return h, ws


@pytest.mark.gpu
@pytest.mark.parametrize("R", [8, 160, 256])
@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_kernel_matches_plain(R, h_dtype, act):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, ws = _inputs(4, R, 256, 512, seed=2)
    before = kexp.expert_ffn.launches
    th = torch.as_tensor(h).to(getattr(torch, h_dtype)).cuda()
    tw = [torch.as_tensor(w).cuda() for w in ws]
    got = ops.expert_ffn(th, *tw, act)
    torch.cuda.synchronize()
    assert kexp.expert_ffn.launches == before + 1
    want = ref.expert_ffn_ref(th, *tw, act)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[h_dtype], rtol=TOL[h_dtype])
