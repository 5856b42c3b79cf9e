"""The port's CUDA kernels against their plain versions on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card of
compute capability >= 9.0. The file imports torch only (no JAX), so it runs
on the machine with the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from _torch_common import TOL, close, randn, require_sm90
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import flash_mha_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _no_plain(monkeypatch):
    """Make the plain versions unreachable from the wrappers."""
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(rms_ops, "rmsnorm_ref", boom)
    monkeypatch.setattr(flash_ops, "flash_mha_ref", boom)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 1536), (4, 1536), (1, 1, 128),
                                   (37, 100), (3, 50, 512), (2, 20, 4, 16),
                                   (5, 8192)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_cuda_vs_plain(shape, dt, monkeypatch):
    require_sm90()
    x = torch.from_numpy(randn(0, shape)).to("cuda", _TDT[dt])
    w = torch.from_numpy(randn(1, shape[-1:])).to("cuda", _TDT[dt])
    want = rmsnorm_ref(x, w, 1e-6)
    _no_plain(monkeypatch)
    before = rmsnorm.launches
    got = rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    close(got, want, TOL[f"rmsnorm_{dt}"])


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (2, 256, 256, 12, 2, 128, True),    # qwen2 heads
    (1, 300, 300, 4, 2, 64, True),      # ragged S
    (1, 300, 300, 4, 2, 64, False),
    (2, 96, 160, 4, 2, 32, True),       # Sq < Sk, top-left
    (2, 160, 96, 4, 2, 32, True),       # Sq > Sk
    (1, 130, 130, 8, 1, 16, True),      # MQA, hd 16
    (2, 64, 200, 3, 3, 128, False),     # MHA, non-causal, Sq != Sk
    (1, 5, 0, 2, 1, 16, True),          # no key at all: rows come out 0
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_cuda_vs_plain(B, Sq, Sk, H, KV, hd, causal, dt, monkeypatch):
    require_sm90()
    q = torch.from_numpy(randn(0, (B, Sq, H, hd))).to("cuda", _TDT[dt])
    k = torch.from_numpy(randn(1, (B, Sk, KV, hd))).to("cuda", _TDT[dt])
    v = torch.from_numpy(randn(2, (B, Sk, KV, hd))).to("cuda", _TDT[dt])
    want = flash_mha_ref(q, k, v, causal=causal)
    _no_plain(monkeypatch)
    before = flash_mha.launches
    got = flash_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    close(got, want, 1e-4 if dt == "f32" else TOL["flash_bf16"])


@pytest.mark.gpu
def test_flash_cuda_rejects_unsupported_head_dim():
    require_sm90()
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_mha(q, q, q)
