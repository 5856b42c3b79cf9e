"""The fused selective scan (``kernels/selective_scan``) on the CPU.

Its plain version and the emulation of the kernel's loop against the chain
the model keeps (``models/mamba.py``: ``_ssm_states`` and the readout) and
against ``repro.models.mamba.mamba_mix`` through JAX, on the scan inputs
the port's own conv, projections and softplus make; the dispatch that
keeps the chain for CPU tensors, under autograd and for DTensors; the
wrapper's capture task. The kernel itself runs only on the card
(``tests/test_torch_selective_scan_cuda.py``).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from _torch_common import TOL, close, randn
from repro.models import mamba as jax_mamba
from repro_torch.graph.capture import TaskRecorder
from repro_torch.kernels.selective_scan import ops as fused_ops
from repro_torch.kernels.selective_scan.ops import selective_scan_fused
from repro_torch.kernels.selective_scan.ref import (STEPS, selective_scan_fused_ref,
                                                    selective_scan_fused_tiled)
from repro_torch.models import mamba as t_mamba

DTR, K = 4, 4
# the emulation against the plain version: exp against exp2 of a product
# rounded once more, and another order of the C sum, in f32
EMUL_TOL = 1e-5

# (B, S, di, n, carried state, z and y dtype): S off the group of STEPS steps
# and the kernel's 16-step tile (13, 7, 9, 5, 37) and on the group (8), di off
# the kernel's 32-channel block (24, 20, 40, 16, 33), both n the kernel is
# built for, with and without a carried state, f32 and bf16 z / y
CASES = {
    "S13_di24_n8_f32": (2, 13, 24, 8, False, torch.float32),
    "S7_di20_n8_state_f32": (2, 7, 20, 8, True, torch.float32),
    "S9_di40_n16_state_bf16": (3, 9, 40, 16, True, torch.bfloat16),
    "S8_di16_n16_bf16": (1, 8, 16, 16, False, torch.bfloat16),
    "S5_di33_n16_state_f32": (2, 5, 33, 16, True, torch.float32),
    "S1_di24_n8_bf16": (2, 1, 24, 8, False, torch.bfloat16),
    "S37_di40_n16_state_f32": (2, 37, 40, 16, True, torch.float32),
}


def _weights(seed, di, n):
    return dict(
        conv_w=0.1 * randn(seed, (di, K)),
        w_x=randn(seed + 1, (di, DTR + 2 * n)) / di ** 0.5,
        w_dt=randn(seed + 2, (DTR, di)) / DTR ** 0.5,
        b_dt=0.1 * randn(seed + 3, (di,)),
        a_log=0.1 * randn(seed + 4, (di, n)),
        d_skip=1.0 + 0.1 * randn(seed + 5, (di,)),
    )


def _mix_args(p, x_in, z, cast):
    return (cast(x_in), cast(z), *(cast(p[k]) for k in
                                   ("conv_w", "w_x", "w_dt", "b_dt", "a_log", "d_skip")))


def _scan_inputs(p, x_in, conv, n):
    """xc, dt, A, Bm, Cm, D as ``mamba_mix`` makes them (f32)."""
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    xc, _ = t_mamba._causal_depthwise_conv(torch.from_numpy(x_in), t["conv_w"],
                                           None if conv is None else torch.from_numpy(conv))
    xc = F.silu(xc.float())
    dt, Bm, Cm = t_mamba._dt_and_bc(xc, torch.float32, t["w_x"], t["w_dt"], t["b_dt"], n, DTR)
    return xc, dt, -torch.exp(t["a_log"]), Bm, Cm, t["d_skip"]


@pytest.mark.parametrize("case", list(CASES))
def test_fused_scan_matches_chain_and_jax(case):
    """The plain version and the kernel's loop against the chain and the
    JAX package: y and the last state."""
    B, S, di, n, carried, dtype = CASES[case]
    seed = 100 + sum(map(ord, case))
    p = _weights(seed, di, n)
    x_in, z = randn(seed + 6, (B, S, di)), randn(seed + 7, (B, S, di))
    conv = randn(seed + 8, (B, di, K - 1)) if carried else None
    ssm = randn(seed + 9, (B, di, n)) if carried else None
    # z as the kernel's dtype holds it; the references read the same values
    z = torch.from_numpy(z).to(dtype).float().numpy()

    kw = dict(n_state=n, dt_rank=DTR)
    jstate = jax_mamba.MambaState(jnp.asarray(conv), jnp.asarray(ssm)) if carried else None
    jmix = jax.jit(functools.partial(jax_mamba.mamba_mix, return_state=True, **kw))
    jout, jst = jmix(*_mix_args(p, x_in, z, jnp.asarray), state=jstate)
    tstate = (t_mamba.MambaState(torch.from_numpy(conv), torch.from_numpy(ssm))
              if carried else None)
    chain, cst = t_mamba.mamba_mix(*_mix_args(p, x_in, z, torch.from_numpy), state=tstate,
                                   return_state=True, **kw)

    xc, dt, A, Bm, Cm, D = _scan_inputs(p, x_in, conv, n)
    zt = torch.from_numpy(z).to(dtype)
    st = None if ssm is None else torch.from_numpy(ssm)
    tol = TOL["scan_f32"] if dtype == torch.float32 else TOL["scan_bf16"]
    plain = selective_scan_fused_ref(xc, dt, A, Bm, Cm, D, zt, st)
    emul = selective_scan_fused_tiled(xc, dt, A, Bm, Cm, D, zt, st)
    for y, last in (plain, emul):
        assert y.dtype == dtype and y.shape == (B, S, di)
        assert last.dtype == torch.float32 and last.shape == (B, di, n)
        close(y, chain, tol)
        close(y, jout, tol)
        close(last, cst.ssm, TOL["scan_f32"])
        close(last, jst.ssm, TOL["scan_f32"])
    close(emul[0].float(), plain[0].float(), EMUL_TOL if dtype == torch.float32 else tol)
    close(emul[1], plain[1], EMUL_TOL)
    # the wrapper takes the plain version on the CPU, without a launch
    before = selective_scan_fused.launches
    y, last = selective_scan_fused(xc, dt, A, Bm, Cm, D, zt, st)
    assert torch.equal(y, plain[0]) and torch.equal(last, plain[1])
    assert selective_scan_fused.launches == before


def test_emulation_walks_groups_with_a_ragged_tail():
    """S off the group size: the steps past S leave the state as it was, so
    the last state equals the plain version's, and splitting the sequence
    at a group edge and carrying the state gives the whole call's result."""
    B, S, di, n = 2, 2 * STEPS + 3, 20, 16
    g = torch.Generator().manual_seed(7)
    xc = torch.randn(B, S, di, generator=g)
    dt = F.softplus(torch.randn(B, S, di, generator=g))
    A = -torch.exp(0.1 * torch.randn(di, n, generator=g))
    Bm, Cm = torch.randn(B, S, n, generator=g), torch.randn(B, S, n, generator=g)
    D, z = torch.randn(di, generator=g), torch.randn(B, S, di, generator=g)
    whole = selective_scan_fused_tiled(xc, dt, A, Bm, Cm, D, z)
    y0, h0 = selective_scan_fused_tiled(xc[:, :STEPS], dt[:, :STEPS], A, Bm[:, :STEPS],
                                        Cm[:, :STEPS], D, z[:, :STEPS])
    y1, h1 = selective_scan_fused_tiled(xc[:, STEPS:], dt[:, STEPS:], A, Bm[:, STEPS:],
                                        Cm[:, STEPS:], D, z[:, STEPS:], h0)
    assert torch.equal(torch.cat([y0, y1], 1), whole[0]) and torch.equal(h1, whole[1])
    close(whole[1], selective_scan_fused_ref(xc, dt, A, Bm, Cm, D, z)[1], EMUL_TOL)


def test_fused_wrapper_is_one_capture_task():
    B, S, di, n = 2, 6, 20, 8
    xc, dt = torch.randn(B, S, di), F.softplus(torch.randn(B, S, di))
    A, D = -torch.rand(di, n), torch.randn(di)
    Bm, Cm, z = torch.randn(B, S, n), torch.randn(B, S, n), torch.randn(B, S, di)
    rec = TaskRecorder()
    with rec:
        y, last = selective_scan_fused(xc, dt, A, Bm, Cm, D, z)
    assert [(t.name, t.engine, t.elems) for t in rec.tasks] == \
        [("selective_scan.0", "vector", B * S * di * n)]
    assert rec.tasks[0].bytes_out == 4 * (y.numel() + last.numel())
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan_fused(*(t.to("meta") for t in (xc, dt, A, Bm, Cm, D, z)))


def _dtensor_world():
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    started = dryrun._fake_world(1)
    return started, make_mesh((1, 1), ("data", "model"), "cpu")


@pytest.mark.parametrize("mode", ["cpu", "cpu_autograd", "dtensor"])
def test_dispatch_keeps_the_chain(mode, monkeypatch):
    """CPU tensors (with and without a gradient) and DTensors take the chain
    around ``ssm_scan``: the fused wrapper is never called, and the result
    is the chain's."""
    B, S, di, n = 2, 6, 24, 8
    p = _weights(3, di, n)
    x_in, z = randn(9, (B, S, di)), randn(10, (B, S, di))
    args = list(_mix_args(p, x_in, z, torch.from_numpy))
    kw = dict(n_state=n, dt_rank=DTR)
    with torch.no_grad():
        want = t_mamba.mamba_mix(*args, **kw)

    def boom(*a, **k):
        raise AssertionError("the fused path was taken")
    monkeypatch.setattr(t_mamba, "selective_scan_fused", boom)
    chain_calls = []
    states = t_mamba._ssm_states
    monkeypatch.setattr(t_mamba, "_ssm_states",
                        lambda *a: chain_calls.append(1) or states(*a))

    if mode == "cpu":
        with torch.inference_mode():
            assert not t_mamba._takes_fused(*args)
            got = t_mamba.mamba_mix(*args, **kw)
        assert torch.equal(got, want)
    elif mode == "cpu_autograd":
        args = [a.requires_grad_(True) for a in args]
        assert not t_mamba._takes_fused(*args)
        got = t_mamba.mamba_mix(*args, **kw)
        got.sum().backward()
        assert all(a.grad is not None for a in args[2:])
        close(got, want, TOL["scan_f32"])
    else:
        from torch.distributed.tensor import DTensor, Replicate

        started, mesh = _dtensor_world()
        try:
            dargs = [DTensor.from_local(a, mesh, [Replicate(), Replicate()], run_check=False)
                     for a in args]
            with torch.no_grad():
                assert not t_mamba._takes_fused(*dargs)
                got = t_mamba.mamba_mix(*dargs, **kw)
            assert isinstance(got, DTensor)
            close(got.to_local(), want, TOL["scan_f32"])
        finally:
            if started:
                torch.distributed.destroy_process_group()
    assert chain_calls == [1]


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before any launch; on the CPU they are reached through
    the launch path's own function."""
    B, S, di = 1, 4, 8
    xc, dt, z = torch.randn(B, S, di), torch.rand(B, S, di), torch.randn(B, S, di)
    D = torch.randn(di)
    for n, err in ((12, "n = 12"), (8, None)):
        A, Bm, Cm = -torch.rand(di, n), torch.randn(B, S, n), torch.randn(B, S, n)
        if err is None:
            fused_ops._check(xc, dt, A, Bm, Cm, D, z, None)
        else:
            with pytest.raises(ValueError, match=err):
                fused_ops._check(xc, dt, A, Bm, Cm, D, z, None)
    with pytest.raises(TypeError, match="must be f32"):
        fused_ops._check(xc.double(), dt, A, Bm, Cm, D, z, None)
    with pytest.raises(ValueError, match="want Cm"):
        fused_ops._check(xc, dt, A, Bm, Cm[:, :2], D, z, None)
    with pytest.raises(ValueError, match="empty input"):
        fused_ops._check(xc[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0], D, z[:, :0], None)
