"""The fused selective-scan kernel (``csrc/selective_scan.cu``) on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card of
compute capability >= 9.0. The file imports torch only (no JAX), so it runs
on the machine with the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_selective_scan_cuda.py

The kernel against its plain version and the emulation of its loop, at
reduced shapes and at hymba-1.5b's per-layer prefill shape in the serve
cell; its attributes; the model's dispatch (a prefill under
``inference_mode`` takes the kernel once a layer, a train step keeps the
chain around ``ssm_scan``); tokens and logits against the chain; the peak
memory of a prefill against one [B, S, di, n] f32 tensor.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from _torch_common import TOL, close, require_sm90
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.kernels.selective_scan import ops as fused_ops
from repro_torch.kernels.selective_scan.kernel import STATES, selective_scan_kernel_attrs
from repro_torch.kernels.selective_scan.ops import selective_scan_fused
from repro_torch.kernels.selective_scan.ref import (selective_scan_fused_ref,
                                                    selective_scan_fused_tiled)
from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
from repro_torch.models import build_model, mamba as t_mamba
from repro_torch.serve import ServeEngine
from repro_torch.train.data import SyntheticData
from repro_torch.train.loop import init_state, make_train_step

_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
HYMBA = REGISTRY["hymba-1.5b"]
# the kernel against the emulation of its loop: ex2.approx against exp2, a
# fused multiply-add against a product and a sum, in f32
EMUL_TOL = 1e-5


def _inputs(B, S, di, n, dtype, carried, seed, dtr=4):
    """The kernel's inputs as the model hands them over: z the second half
    of a [B, S, 2di] product, B and C slices of one [B, S, dtr + 2n]
    projection (``dtr`` sets their alignment)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    xc = F.silu(r(B, S, di))
    dt = F.softplus(r(B, S, di) - 1.0)
    A = -torch.exp(0.5 * r(di, n))
    proj = r(B, S, dtr + 2 * n)
    Bm, Cm = proj[..., dtr:dtr + n], proj[..., dtr + n:]
    D = 1.0 + 0.1 * r(di)
    z = r(B, S, 2 * di).to(dtype)[..., di:]
    state = r(B, di, n) if carried else None
    return xc, dt, A, Bm, Cm, D, z, state


def _boom(*a, **k):
    raise AssertionError("a CUDA tensor reached the plain version")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 13, 24, 8, False, 4), (3, 9, 40, 16, True, 4),
                                   (1, 1, 16, 16, False, 4), (2, 257, 333, 16, True, 3),
                                   (4, 130, 128, 8, True, 3), (1, 2049, 3200, 16, False, 100)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_kernel_vs_plain_and_emulation(shape, dt, monkeypatch):
    """Reduced shapes (S and di ragged, off and on the 16-step tile, with
    and without a carried state, B and C at odd offsets) against the plain
    version and the emulation."""
    require_sm90()
    B, S, di, n, carried, dtr = shape
    ins = _inputs(B, S, di, n, _TDT[dt], carried, seed=S + di, dtr=dtr)
    want = selective_scan_fused_ref(*ins)
    emul = selective_scan_fused_tiled(*ins) if S * di <= 40_000 else None
    monkeypatch.setattr(fused_ops, "selective_scan_fused_ref", _boom)
    before = selective_scan_fused.launches
    y, last = selective_scan_fused(*ins)
    torch.cuda.synchronize()
    assert selective_scan_fused.launches == before + 1
    assert y.dtype == _TDT[dt] and y.shape == (B, S, di)
    assert last.dtype == torch.float32 and last.shape == (B, di, n)
    close(y, want[0], TOL[f"scan_{dt}"])
    close(last, want[1], TOL["scan_f32"])
    if emul is not None:
        close(y, emul[0], EMUL_TOL if dt == "f32" else TOL["scan_bf16"])
        close(last, emul[1], EMUL_TOL)
    # no atomics: a second call gives the same bits
    y2, last2 = selective_scan_fused(*ins)
    assert torch.equal(y, y2) and torch.equal(last, last2)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_kernel_at_the_serve_cells_layer_shape(dt, monkeypatch):
    """hymba-1.5b's prefill in the serve cell: B 8, S 3,018 + 128 meta,
    di 3,200, n 16, B and C slices of the dt_rank 100 projection."""
    require_sm90()
    ins = _inputs(8, 3146, 3200, 16, _TDT[dt], True, seed=31, dtr=100)
    want = selective_scan_fused_ref(*ins)
    monkeypatch.setattr(fused_ops, "selective_scan_fused_ref", _boom)
    y, last = selective_scan_fused(*ins)
    torch.cuda.synchronize()
    close(y, want[0], TOL[f"scan_{dt}"])
    close(last, want[1], TOL["scan_f32"])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_kernel_attrs(dt):
    """64 registers at most (102,400 threads resident in one wave on 132
    SMs), no spill; shared memory: two stages of x, dt and z for 32 channels
    (rows of 16 steps padded to 20) and of B and C for 16 steps."""
    require_sm90()
    for n in STATES:
        attrs = selective_scan_kernel_attrs(_TDT[dt], n)
        print(f"selective_scan {dt} n {n}: {attrs}")
        assert 0 < attrs["registers"] <= 64 and attrs["spill_bytes"] == 0
        assert attrs["smem_bytes"] == 2 * (3 * 32 * 20 + 2 * 16 * n) * 4


@pytest.mark.gpu
def test_fused_kernel_refuses_what_it_does_not_take():
    require_sm90()
    xc, dt, A, Bm, Cm, D, z, _ = _inputs(1, 8, 16, 16, torch.float32, False, seed=1)
    before = selective_scan_fused.launches
    with pytest.raises(ValueError, match="n = 12"):
        selective_scan_fused(xc, dt, A[:, :12], Bm[..., :12], Cm[..., :12], D, z)
    with pytest.raises(ValueError, match="no backward"):
        selective_scan_fused(xc.requires_grad_(True), dt, A, Bm, Cm, D, z)
    assert selective_scan_fused.launches == before


def _reduced_hymba(seed=0, **changes):
    cfg = dataclasses.replace(HYMBA.reduced(), **changes)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), torch.float32, "cuda")
    return cfg, model, params


def _chain(monkeypatch):
    monkeypatch.setattr(t_mamba, "_takes_fused", lambda *ts: False)


@pytest.mark.gpu
def test_prefill_takes_the_kernel_once_a_layer(monkeypatch):
    """A reduced hymba prefill under ``inference_mode``: n_layers launches
    of the fused kernel, none of ``ssm_scan``; logits and the cache's states
    against the chain's on the same card."""
    require_sm90()
    cfg, model, params = _reduced_hymba()
    toks = torch.randint(0, cfg.vocab_size, (2, 30), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    before = selective_scan_fused.launches, ssm_scan_batched.launches
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": toks}, 48)
    torch.cuda.synchronize()
    assert selective_scan_fused.launches == before[0] + cfg.n_layers
    assert ssm_scan_batched.launches == before[1]
    _chain(monkeypatch)
    with torch.inference_mode():
        lg_chain, cache_chain = model.prefill(params, {"tokens": toks}, 48)
    assert ssm_scan_batched.launches == before[1] + cfg.n_layers
    close(lg, lg_chain, TOL["model_f32"])
    for seg, seg_chain in zip(cache["segments"], cache_chain["segments"]):
        close(seg["ssm"], seg_chain["ssm"], TOL["model_f32"])


@pytest.mark.gpu
def test_serve_engine_tokens_equal_the_chains(monkeypatch):
    require_sm90()
    cfg, model, params = _reduced_hymba(2)
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy()
               for n in (5, 26, 12, 30)]

    def run():
        eng = ServeEngine(model, params, smax=48)
        for p in prompts:
            eng.submit(p, 6)
        return eng.run(batch_size=2)

    before = selective_scan_fused.launches
    fused = run()
    assert selective_scan_fused.launches > before
    _chain(monkeypatch)
    mid = selective_scan_fused.launches
    assert run() == fused
    assert selective_scan_fused.launches == mid


@pytest.mark.gpu
def test_train_step_keeps_the_chain():
    """A hymba train step runs the scan's forward and backward kernels, and
    never the fused kernel."""
    require_sm90()
    cfg, model, _ = _reduced_hymba()
    state = init_state(model, torch.Generator(device="cuda").manual_seed(0),
                       dtype=torch.float32, device="cuda")
    batch = SyntheticData(cfg, SHAPES["train_4k"], seed=2, batch_override=2, seq_override=16,
                          device="cuda").batch_at(0)
    before = (selective_scan_fused.launches, ssm_scan_batched.launches,
              ssm_scan_batched.bwd_launches)
    state, m = make_train_step(model)(state, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(torch.as_tensor(m["loss"])))
    assert selective_scan_fused.launches == before[0]
    assert ssm_scan_batched.launches >= before[1] + cfg.n_layers
    assert ssm_scan_batched.bwd_launches == before[2] + cfg.n_layers


@pytest.mark.gpu
def test_prefill_peak_memory_stays_below_one_state_tensor(monkeypatch):
    """A reduced hymba prefill at S 1,000 with hymba-1.5b's 16 states: the
    fused path's peak above the model's own memory stays below one
    [B, S + meta, di, n] f32 tensor; the chain's (a, bu and h) lies above it."""
    require_sm90()
    cfg, model, params = _reduced_hymba(ssm_state=HYMBA.ssm_state)
    B, S = 4, 1000
    toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))
    one = B * (S + cfg.n_meta_tokens) * cfg.ssm_expand * cfg.d_model * cfg.ssm_state * 4

    def peak():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = model.prefill(params, {"tokens": toks}, S + 16)
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base

    fused = peak()
    _chain(monkeypatch)
    chain = peak()
    print(f"prefill peak above the model: fused {fused} B, chain {chain} B, "
          f"one [B,S,di,n] f32 tensor {one} B")
    assert fused < one < chain
