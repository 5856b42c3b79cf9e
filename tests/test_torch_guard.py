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
                "repro_torch.models.model", "repro_torch.serve.engine",
                "repro_torch.launch.serve", "repro_torch.core.vectorized",
                "repro_torch.sweep.runner", "repro_torch.kernels.list_schedule.ops",
                "repro_torch.graph.ingest", "repro_torch.hw.chip",
                "repro_torch.exec.pool", "repro_torch.exec.spool",
                "repro_torch.exec.worker", "repro_torch.obs.perfetto"):
        assert mod in names


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_configs_equal_reference_records(arch):
    mine, ref = REGISTRY[arch], JAX_REGISTRY[arch]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    for prop in ("hd", "padded_vocab", "n_self_layers"):
        assert getattr(mine, prop) == getattr(ref, prop)
    assert get_config(arch.replace("-", "_")) is mine


@pytest.mark.parametrize("arch", sorted(a for a, c in REGISTRY.items()
                                         if c.family not in ("dense", "hybrid")))
def test_build_model_refuses_families_not_ported(arch):
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(REGISTRY[arch])


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "qwen2-1.5b", "--reduced"])
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
