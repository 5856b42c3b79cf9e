"""Parity of the port's distributed layer with the JAX package's, on the CPU.

The sharding rules and the specs of every architecture (parameters, cache,
train state, batch) on the production meshes, 16x16 and 2x16x16, spec for
spec as strings: the JAX package's from an ``AbstractMesh``, the port's from
a ``DeviceMesh`` over torch's fake process group (one process standing for
rank 0 of 512; no collective runs). The guards of ``constrain`` and the
MoE's expert-parallel pieces (``_bucket_by``, ``_moe_ep_local`` on one
shard, capacity drops) against the JAX functions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as JP

from _torch_common import close, randn
from repro.configs import REGISTRY as JAX_REGISTRY, SHAPES as JAX_SHAPES
from repro.launch.programs import rules_for_arch as jax_rules_for_arch
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.train.loop import batch_pspecs as jax_batch_pspecs, state_pspecs as jax_state_pspecs
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.distributed.sharding import (P, constrain, logical_to_placements,
                                              logical_to_pspec, placements, rules_for, use_rules)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.programs import build_program, rules_for_arch
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.models.layers import param_placements
from repro_torch.train.loop import batch_pspecs, state_pspecs
from torch.distributed.tensor import DTensor, Replicate, Shard

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    """The port's production meshes over a fake world of 512 ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield {multi: make_production_mesh(multi_pod=multi) for multi in (False, True)}
    finally:
        dist.destroy_process_group()


def _jax_mesh(multi):
    shape, axes = MESHES[multi]
    try:
        return AbstractMesh(shape, axes)
    except TypeError:                       # older jaxlib: ((name, size), ...)
        return AbstractMesh(tuple(zip(axes, shape)))


def _jax_specs(tree):
    return [str(s) for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_specs(tree):
    if isinstance(tree, P):
        return [str(tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_specs(tree[k])]
    return [s for t in tree for s in _port_specs(t)]


def _table(rules):
    return {k: (tuple(v) if isinstance(v, (tuple, list)) else v) for k, v in rules.table.items()}


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
def test_rules_tables_match_jax_for_every_arch(meshes, multi, serving):
    for name, cfg in REGISTRY.items():
        want = jax_rules_for_arch(JAX_REGISTRY[name], _jax_mesh(multi), serving=serving)
        got = rules_for_arch(cfg, meshes[multi], serving=serving)
        assert _table(got) == _table(want), name
        assert (got.moe_impl, got.ep_axis) == (want.moe_impl, want.ep_axis), name
        for logical in got.table:
            assert got.axis_size(logical) == want.axis_size(logical), (name, logical)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_specs_match_jax_spec_for_spec(meshes, multi, arch):
    """Parameter, cache, train-state and batch specs of every arch and every
    shape, as strings, in tree order."""
    jm, tm = _jax_mesh(multi), meshes[multi]
    jcfg, tcfg = JAX_REGISTRY[arch], REGISTRY[arch]
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    for serving in (False, True):
        jr = jax_rules_for_arch(jcfg, jm, serving=serving)
        tr = rules_for_arch(tcfg, tm, serving=serving)
        assert _port_specs(tmodel.pspecs(tr)) == _jax_specs(jmodel.pspecs(jr))
        for compress in (False, True):
            assert (_port_specs(state_pspecs(tmodel, tr, compress=compress))
                    == _jax_specs(jax_state_pspecs(jmodel, jr, compress=compress)))
        for sname, shape in SHAPES.items():
            assert (_port_specs(batch_pspecs(tmodel, shape, tr))
                    == _jax_specs(jax_batch_pspecs(jmodel, JAX_SHAPES[sname], jr))), sname
            B, S = shape.global_batch, shape.seq_len
            assert (_port_specs(tmodel.cache_pspecs(B, S, tr))
                    == _jax_specs(jmodel.cache_pspecs(B, S, jr))), sname


def test_placements_put_a_tuple_axis_on_every_mesh_dim(meshes):
    """A spec is by tensor dim, placements by mesh dim: batch -> ('pod',
    'data') is Shard(0) on both, in mesh order."""
    mesh = meshes[True]
    rules = rules_for(mesh, n_heads=32, d_ff=1024)
    spec = logical_to_pspec(("batch", None, "ff"), rules)
    assert str(spec) == "PartitionSpec(('pod', 'data'), None, 'model')"
    assert placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert logical_to_placements(("kv_heads", "heads"), rules) == [Replicate(), Replicate(),
                                                                  Shard(1)]
    assert str(P(("data",), None)) == str(JP(("data",), None))


def test_program_and_param_placements(meshes):
    """A program's input placements are its specs by mesh dim, leaf for
    leaf: qwen3-moe's expert leaves [L, E, d, f] split E over 'model' (and
    d over 'data' when training: FSDP)."""
    cfg = REGISTRY["qwen3-moe-30b-a3b"]
    mesh = meshes[False]
    train = build_program(cfg, SHAPES["train_4k"], mesh)
    serve = build_program(cfg, SHAPES["prefill_32k"], mesh)
    st_pl, batch_pl = train.in_placements
    assert st_pl["params"]["segments"][0]["we_gate"] == [Shard(2), Shard(1)]
    assert st_pl["opt"]["step"] == [Replicate(), Replicate()]
    assert batch_pl["tokens"] == [Shard(0), Replicate()]
    assert serve.in_placements[0]["segments"][0]["we_gate"] == [Replicate(), Shard(1)]
    assert param_placements(serve.model.template(), serve.rules) == serve.in_placements[0]
    assert serve.out_placements[0] == [Shard(0), Shard(1)]     # logits: batch, vocab


# -- the reference's own cases (tests/test_distributed.py) -------------------

def test_rules_divisibility_head_tp(meshes):
    mesh = meshes[False]
    r_yes = rules_for(mesh, n_heads=64, d_ff=25600)
    assert r_yes.table["heads"] == "model" and r_yes.table["act_seq"] is None
    r_no = rules_for(mesh, n_heads=9, d_ff=1536)
    assert r_no.table["heads"] is None and r_no.table["act_seq"] == "model"


def test_rules_fsdp_flag(meshes):
    assert rules_for(meshes[False], fsdp=True).table["embed"] == "data"
    assert rules_for(meshes[False], fsdp=False).table["embed"] is None


def test_param_pspecs_guard(meshes):
    """Non-divisible dims are left unsharded in parameter specs (smollm: 9
    heads, 3 kv heads)."""
    cfg = REGISTRY["smollm-135m"]
    rules = rules_for(meshes[False], n_heads=cfg.n_heads, d_ff=cfg.d_ff)
    model = build_model(cfg)
    sizes = {"data": 16, "model": 16}
    from repro_torch.models.layers import map_templates
    pairs = []
    map_templates(lambda t: pairs.append(t), model.template())
    specs = []

    def collect(tree):
        if isinstance(tree, P):
            specs.append(tree)
        elif isinstance(tree, dict):
            for k in sorted(tree):
                collect(tree[k])
        else:
            for t in tree:
                collect(t)

    collect(model.pspecs(rules))
    assert len(specs) == len(pairs)
    for t, spec in zip(pairs, specs):
        for dim, part in zip(t.shape, tuple(spec) + (None,) * 8):
            if part is not None:
                n = int(np.prod([sizes[a] for a in ((part,) if isinstance(part, str) else part)]))
                assert dim % n == 0, (t.shape, spec)


def _on_mesh(shape, mesh):
    """A DTensor of ``shape``, replicated, over the fake mesh."""
    return DTensor.from_local(torch.zeros(shape), mesh, [Replicate()] * mesh.ndim)


def test_constrain_guard_and_rightmost_wins(meshes):
    mesh = meshes[False]
    sp = rules_for(mesh, n_heads=64, d_ff=25600, sp_residual=True)
    with use_rules(sp):
        # [B, S(act_seq -> model), ff(-> model)]: the rightmost dim keeps 'model'
        x = constrain(_on_mesh((32, 64, 256), mesh), "batch", "act_seq", "ff")
        assert list(x.placements) == [Shard(0), Shard(2)]
        # batch 8 does not divide over 16 data ranks: unsharded
        y = constrain(_on_mesh((8, 64, 32), mesh), "batch", "act_seq", None)
        assert list(y.placements) == [Replicate(), Shard(1)]
        with pytest.raises(ValueError):
            constrain(_on_mesh((8, 64), mesh), "batch", "act_seq", None)


def test_constrain_is_the_identity_outside_rules():
    x = torch.randn(4, 8, 16)
    assert constrain(x, "batch", "act_seq", None) is x


# -- expert parallelism on one shard ------------------------------------------

def _moe_arrays(seed, T, d, E, f, router_scale=0.3):
    x = randn(seed, (T, d))
    wr = randn(seed + 1, (d, E)) * router_scale
    wg, wu, wd = (randn(seed + i, s) * 0.3 for i, s in
                  ((2, (E, d, f)), (3, (E, d, f)), (4, (E, f, d))))
    return x, wr, wg, wu, wd


@pytest.mark.parametrize("n_buckets,cap", [(4, 8), (3, 2), (5, 1)])
def test_bucket_by_matches_jax(n_buckets, cap):
    rng = np.random.default_rng(n_buckets * 10 + cap)
    dest = rng.integers(0, n_buckets, 40).astype(np.int32)
    src = np.arange(40, dtype=np.int32)
    want_slot, want_valid = jax_moe._bucket_by(jnp.asarray(dest), n_buckets, cap, jnp.asarray(src))
    got_slot, got_valid = t_moe._bucket_by(torch.from_numpy(dest).long(), n_buckets, cap,
                                           torch.from_numpy(src))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(want_slot))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.5])
def test_moe_ep_local_matches_jax(capacity_factor):
    """The single-shard EP body equals the JAX one (same slots, so the same
    pairs dropped) within 2e-5, and the dense oracle where nothing drops."""
    T, d, E, f, k = 24, 16, 8, 32, 2
    arrays = _moe_arrays(5, T, d, E, f)
    kw = dict(k=k, n_experts=E, capacity_factor=capacity_factor)
    want = jax_moe._moe_ep_local(*map(jnp.asarray, arrays), axis_name=None, **kw)
    got = t_moe._moe_ep_local(*map(torch.from_numpy, arrays), axis_name=None, **kw)
    close(got, want, 2e-5)
    if capacity_factor >= E / k:
        close(got, t_moe.moe_dense(*map(torch.from_numpy, arrays), k=k), 2e-5)


def test_moe_ep_local_records_what_capacity_drops():
    T, d, E, f, k = 64, 8, 4, 8, 2
    arrays = _moe_arrays(7, T, d, E, f)
    t_moe.DROP_STATS = []
    try:
        t_moe._moe_ep_local(*map(torch.from_numpy, arrays), k=k, n_experts=E,
                            capacity_factor=0.5, axis_name=None)
        (pairs, kept), = t_moe.DROP_STATS
    finally:
        t_moe.DROP_STATS = None
    assert pairs == T * k and 0 < int(kept) < pairs


def test_moe_capacity_drops_tokens():
    """The reference's case: uniform routing, capacity << demand, some tokens
    contribute nothing, in both packages alike (onehot and EP)."""
    T, d, E, f, k = 64, 8, 2, 8, 2
    x, _, wg, wu, wd = _moe_arrays(2, T, d, E, f)
    wr = np.zeros((d, E), np.float32)      # uniform routing -> both experts hit capacity
    arrays = (x, wr, wg, wu, wd)
    for fn in ("moe_onehot", "_moe_ep_local"):
        extra = {"axis_name": None} if fn == "_moe_ep_local" else {}
        full, tight = (getattr(t_moe, fn)(*map(torch.from_numpy, arrays), k=k, n_experts=E,
                                           capacity_factor=cf, **extra) for cf in (64.0, 0.25))
        dropped = np.mean(np.all(tight.numpy() == 0.0, axis=-1))
        assert dropped > 0.2, fn
        assert not np.allclose(full.numpy(), tight.numpy()), fn
        want = getattr(jax_moe, fn)(*map(jnp.asarray, arrays), k=k, n_experts=E,
                                    capacity_factor=0.25, **extra)
        close(tight, want, 2e-5)


def test_moe_ffn_dispatches_as_the_reference(meshes):
    """EP when the sequence splits over the EP axis, one-hot when it does not
    (decode), the dense oracle without rules."""
    calls = []
    orig = {n: getattr(t_moe, n) for n in ("moe_ep", "moe_onehot", "moe_dense")}

    def spy(name):
        def f(x, *a, **kw):
            calls.append(name)
            return torch.zeros(x.shape)
        return f

    cfg = dataclasses.replace(REGISTRY["qwen3-moe-30b-a3b"].reduced(), n_experts=16)
    rules = rules_for_arch(cfg, meshes[False], serving=True)
    assert rules.moe_impl == "ep" and rules.ep_axis == "model"
    w = [torch.zeros(1)] * 4
    kw = dict(k=2, n_experts=16, capacity_factor=1.25)
    try:
        for n in orig:
            setattr(t_moe, n, spy(n))
        with use_rules(rules):
            t_moe.moe_ffn(torch.zeros(2, 32, 4), *w, **kw)
            t_moe.moe_ffn(torch.zeros(2, 1, 4), *w, **kw)
        t_moe.moe_ffn(torch.zeros(2, 3, 4), *w, **kw)
    finally:
        for n, f in orig.items():
            setattr(t_moe, n, f)
    assert calls == ["moe_ep", "moe_onehot", "moe_dense"]
