"""Guards of the port's boundary: it imports neither JAX nor ``repro``, its
config records equal the reference's, it never runs on the CPU unless asked,
and the bf16 bridge is lossless."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import build_model as jax_build_model
from repro_torch.bridge import (params_from_numpy, tensor_from_numpy,
                                tensor_to_numpy)
from repro_torch.configs import REGISTRY, get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
import torch.distributed as dist
assert not dist.is_initialized(), "importing the port started a process group"
print(len(names), " ".join(sorted(names)))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split()[1:])
    for mod in ("repro_torch.device", "repro_torch.bridge",
                "repro_torch.kernels._build",
                "repro_torch.kernels.rmsnorm.ops",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.ssm_scan.ops", "repro_torch.models.mamba",
                "repro_torch.models.moe", "repro_torch.models.ssm",
                "repro_torch.models.model", "repro_torch.serve.engine",
                "repro_torch.launch.serve", "repro_torch.core.vectorized",
                "repro_torch.sweep.runner", "repro_torch.kernels.list_schedule.ops",
                "repro_torch.graph.ingest", "repro_torch.hw.chip",
                "repro_torch.exec.pool", "repro_torch.exec.spool",
                "repro_torch.exec.worker", "repro_torch.obs.perfetto",
                "repro_torch.graph.stackem", "repro_torch.sweep.__main__",
                "repro_torch.train.optim", "repro_torch.train.loop",
                "repro_torch.train.compress", "repro_torch.train.data",
                "repro_torch.train.checkpoint", "repro_torch.launch.train",
                "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
                "repro_torch.launch.programs", "repro_torch.launch.dryrun"):
        assert mod in names


@pytest.mark.parametrize("script", ["chip_smoke.py", "step_rounding.py", "flash_race.py"])
def test_card_scripts_import_no_jax_or_repro(script):
    """The scripts run on the card import neither JAX nor ``repro``, at the
    top or inside any function."""
    import ast

    with open(os.path.join(os.path.dirname(SRC), script)) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert names and "torch" in names
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")], names


@pytest.mark.parametrize("script", ["torch_quickstart.py", "torch_serve_lm.py",
                                    "torch_train_lm.py", "torch_npu_analysis.py"])
def test_port_examples_import_no_jax_or_repro(script):
    """The port's examples import the port and neither JAX nor ``repro``,
    at the top or inside any function."""
    import ast

    with open(os.path.join(os.path.dirname(SRC), "examples", script)) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert any(m.split(".")[0] == "repro_torch" for m in names), names
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")], names


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_configs_equal_reference_records(arch):
    mine, ref = REGISTRY[arch], JAX_REGISTRY[arch]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    for prop in ("hd", "padded_vocab", "n_self_layers"):
        assert getattr(mine, prop) == getattr(ref, prop)
    assert get_config(arch.replace("-", "_")) is mine


def test_shape_records_equal_reference():
    from repro.configs import SHAPES as JAX_SHAPES, get_shape as jax_get_shape, \
        skip_reason as jax_skip_reason
    from repro_torch.configs import SHAPES, applicable, get_shape, skip_reason

    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JAX_SHAPES[name])
        assert shape.program == JAX_SHAPES[name].program
        assert get_shape(name) is shape and jax_get_shape(name) is JAX_SHAPES[name]
        for arch in REGISTRY:
            assert skip_reason(REGISTRY[arch], shape) == \
                jax_skip_reason(JAX_REGISTRY[arch], JAX_SHAPES[name])
            assert applicable(REGISTRY[arch], shape) == (skip_reason(REGISTRY[arch], shape)
                                                         is None)
    with pytest.raises(KeyError):
        get_shape("train_8k")


@pytest.mark.parametrize("arch", sorted(a for a, c in REGISTRY.items()
                                         if c.family not in ("dense", "hybrid", "moe")))
def test_build_model_refuses_families_not_ported(arch):
    """The archs of the families that were refused until the ssm, vlm and
    audio families were ported: each builds now, with the reference's
    segments; only a family the reference does not know is refused."""
    from repro.models.model import plan_segments as jax_plan_segments

    model = build_model(REGISTRY[arch])
    assert [(s.kind, s.n, s.scanned, s.causal, s.inner) for s in model.segments] == \
        [(s.kind, s.n, s.scanned, s.causal, s.inner)
         for s in jax_plan_segments(JAX_REGISTRY[arch])]
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(REGISTRY[arch], family="diffusion"))


def test_default_device_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "qwen2-1.5b", "--reduced"])
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train("smollm-135m", reduced=True, steps=1)
    from repro_torch.train.loop import init_state
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(build_model(REGISTRY["smollm-135m"].reduced()), torch.Generator())
    from repro_torch.sweep.__main__ import main as sweep_main
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_main(["run", "dvfs_bw", "--workers", "0", "--no-cache",
                    "--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()
    assert resolve_device("cpu") == torch.device("cpu")


def test_bf16_uint16_bridge_round_trips():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((7, 33)),
                    jnp.bfloat16)
    bits = np.asarray(x).view(np.uint16)
    t = tensor_from_numpy(bits)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    np.testing.assert_array_equal(tensor_to_numpy(t), bits)


def test_bf16_params_bridge_path_for_path():
    jcfg = JAX_REGISTRY["qwen3-32b"].reduced()
    jparams = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a).view(np.uint16), jparams)
    params = params_from_numpy(build_model(REGISTRY["qwen3-32b"].reduced()), tree)
    seg, jseg = params["segments"][0], jparams["segments"][0]
    assert set(seg) == set(jseg)
    for key in seg:
        assert seg[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(seg[key].float().numpy(),
                                      np.asarray(jseg[key].astype(jnp.float32)))
    with pytest.raises(KeyError):
        params_from_numpy(build_model(REGISTRY["qwen2-1.5b"].reduced()), tree)
