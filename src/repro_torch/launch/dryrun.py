"""Dry-run driver: every (architecture x input-shape x mesh) cell with no
allocation.

Counterpart of ``repro/launch/dryrun.py``. For each cell it builds the
production program (``launch.programs.build_program``) over the production
mesh and runs it once on fake tensors in place of XLA's lower and compile:
the process starts torch's fake process group (backend ``"fake"``, one
process standing for rank 0 of the 256 or 512), every argument is a DTensor
whose local shard is a fake CPU tensor (``FakeTensorMode``: shapes and
dtypes, no storage), and the collectives do nothing. It writes a JSON
artifact per cell with the reference's keys where a counterpart exists:

  memory_analysis  per-device argument and output bytes (the local shards
                   of the program's inputs and outputs) and the peak bytes
                   of live storage during the run (``DeviceCounter``: each
                   storage from its first tensor to the last, views counted
                   once with what they view);
  cost_analysis    ``flops``: the product FLOPs one device runs (the
                   formulas of ``torch.utils.flop_counter``; a DTensor op
                   counted at its output's local share, divided again over
                   each mesh dim it leaves a pending sum on, so a product
                   split on its contracted dim counts its local part; ops on
                   local shards counted as they run). XLA's count of an
                   SPMD-partitioned module is per device too, but counts
                   elementwise work as well;
  param_count, active_param_count, status ok / skip / fail (``skip_reason``).

The kernel wrappers run their plain versions here, because the caller chose
fake CPU tensors, not the card; flash attention's plain version takes its
query rows in chunks, as the reference's ``attention`` does, so no cell
holds more than one chunk's scores; the scan's, which would step every
token for no value, gives way to a stand-in of the kernel's allocations
(``_ScanShape``). In place of the
reference's HLO text, each forward cell (prefill, decode, encode) written
to a directory saves its capture (``graph/capture.py``: the task list one
device runs, the format of ``configs/torch_graphs/``) beside its JSON as
``<arch>__<shape>__<mesh>.tasks.json.gz``, named in the cell's ``capture``;
``--no-hlo`` and ``run_cell(..., save_hlo=False)`` leave it out, as the
reference's leave out its HLO. Train cells have none: the recorder sees a
train step's forward only, its backward running later through autograd
(the kernels' backward, on the card, through ctypes), so such a capture
would not be the program the card runs.

Usage (the whole grid, 10 archs x 4 shapes x 2 meshes, in 8 processes):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out benchmarks/artifacts/dryrun_torch --jobs 8
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import multiprocessing
import os
import time
import traceback
import unittest.mock
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import REGISTRY, SHAPES, get_config, get_shape, skip_reason
from ..distributed.sharding import full_on_mesh
from ..graph.capture import TaskRecorder, dumps, gzip_bytes
from ..train.optim import tree_leaves
from .mesh import PRODUCTION_SHAPES, make_mesh
from .programs import build_program

__all__ = ["run_cell", "main", "DeviceCounter", "local_bytes", "run_program_fake",
           "capture_fake"]

MESH_TAGS = {False: "pod16x16", True: "pod2x16x16"}


class DeviceCounter(TorchDispatchMode):
    """Per device: product FLOPs (a DTensor op at its output's local share,
    over each mesh dim holding a pending sum once more divided; a plain op,
    a local shard's, as it is) and the peak bytes of live storage (each
    storage that an op's output or a tensor handed to ``hold`` lies in,
    counted once at its size from the first tensor on it to the moment the
    last tensor on it that this counter saw goes: a view, which at this
    level of dispatch carries no ``_base``, adds nothing)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.live = self.peak = 0
        self._refs: Dict[int, list] = {}     # storage -> [tensors seen on it, bytes]

    def hold(self, tensors) -> None:
        for t in tensors:
            self._track(t)

    def _track(self, t) -> None:
        local = t._local_tensor if isinstance(t, DTensor) else t     # the shard itself
        if not isinstance(local, torch.Tensor):
            return
        try:
            st = local.untyped_storage()
            key, n = st._cdata, st.nbytes()
        except (RuntimeError, NotImplementedError):         # a tensor without storage
            key, n = id(local), local.numel() * local.element_size()
        ref = self._refs.get(key)
        if ref is None:
            self._refs[key] = [1, n]
            self.live += n
            self.peak = max(self.peak, self.live)
        else:
            ref[0] += 1
        weakref.finalize(local, self._free, key)

    def _free(self, key: int) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            del self._refs[key]
            self.live -= ref[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if formula is not None:
            n = float(formula(*args, **kwargs, out_val=out))
            o = outs[0]
            if isinstance(o, DTensor):
                n *= o.to_local().numel() / max(o.numel(), 1)
                for i, p in enumerate(o.placements):
                    if p.is_partial():
                        n /= o.device_mesh.size(i)
            self.flops += n
        for o in outs:
            if isinstance(o, torch.Tensor):
                self._track(o)
        return out


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of tensors."""
    shards = (t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree))
    return sum(t.numel() * t.element_size() for t in shards if isinstance(t, torch.Tensor))


def _fake_args(abstract, specs, mesh):
    """The program's arguments as DTensors of fake local shards."""
    if isinstance(abstract, dict):
        return {k: _fake_args(v, specs[k], mesh) for k, v in abstract.items()}
    if isinstance(abstract, (list, tuple)):
        return type(abstract)(_fake_args(v, s, mesh) for v, s in zip(abstract, specs))
    if not isinstance(abstract, torch.Tensor):
        return abstract
    return full_on_mesh(abstract.shape, 0, abstract.dtype, "cpu", specs, mesh)


class _ScanShape(torch.autograd.Function):
    """The scan kernel's allocations, nothing computed: its output and
    gradients in a's dtype, where the plain version would step every token
    of fake shards for no value."""

    @staticmethod
    def forward(ctx, a, b):
        return torch.empty_like(a)

    @staticmethod
    def backward(ctx, g):
        return torch.empty_like(g), torch.empty_like(g)


def _scan_shapes():
    """The ssm_scan wrapper's call on local shards, as ``_ScanShape``."""
    from ..kernels.ssm_scan import ops

    return unittest.mock.patch.object(ops, "_local", _ScanShape.apply)


def run_program_fake(prog, record: bool = False) -> Dict:
    """Run ``prog`` once on fake shards; its per-device bytes, peak and
    product FLOPs, and the seconds the run took; with ``record``, also its
    capture (``tasks``: the recorder sees the local ops and collectives
    below the counter's DTensor ops). The scan kernel's calls take the
    stand-in ``_ScanShape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = prog.rules.mesh
    rec = TaskRecorder() if record else contextlib.nullcontext()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = _fake_args(prog.abstract_args, prog.in_specs, mesh)
        arg_bytes = local_bytes(args)
        counter = DeviceCounter()
        counter.hold(t for t in tree_leaves(args) if isinstance(t, torch.Tensor))
        t0 = time.time()
        with rec, counter, _scan_shapes():
            out = prog.fn(*args)
        run_s = time.time() - t0
        out_bytes = local_bytes(out)
    r = {"argument_size_in_bytes": int(arg_bytes), "output_size_in_bytes": int(out_bytes),
         "peak_memory_in_bytes": int(counter.peak), "flops": counter.flops, "run_s": run_s}
    if record:
        r["tasks"] = rec.tasks
    return r


def capture_fake(cfg, shape, mesh_shape) -> list:
    """The capture of ``build_program(cfg, shape, mesh)`` on fake CPU
    tensors under torch's fake process group of the mesh's ranks (this
    process stands for rank 0): the tasks one device runs."""
    started = _fake_world(math.prod(mesh_shape))
    try:
        prog = build_program(cfg, shape, make_mesh(tuple(mesh_shape), ("data", "model"), "cpu"))
        return run_program_fake(prog, record=True)["tasks"]
    finally:
        if started:
            dist.destroy_process_group()


def _fake_world(n: int) -> bool:
    """Start the fake process group of ``n`` ranks unless a group is up;
    True when this call started it."""
    if dist.is_initialized():
        if dist.get_world_size() < n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; "
                               f"the mesh needs {n}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return True


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Optional[str] = None,
             save_hlo: bool = True, verbose: bool = True, mesh_shape=None,
             **program_kw) -> Dict:
    """One cell (``arch`` and ``shape_name`` may be records, such as a
    reduced config). With ``out_dir`` and ``save_hlo`` a forward cell's
    capture is written beside its JSON (the reference writes its HLO text
    there); a train cell has none (the module's docstring says why).
    ``mesh_shape`` ((shape, axes)) replaces the production mesh (tests: a
    1x1 mesh over a real one-rank group)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    shp, axes = mesh_shape or PRODUCTION_SHAPES[multi_pod]
    mesh_tag = MESH_TAGS[multi_pod] if mesh_shape is None else "x".join(map(str, shp))
    n_dev = math.prod(shp)
    cell = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_tag,
            "program": shape.program, "devices": n_dev}

    reason = skip_reason(cfg, shape)
    if reason:
        cell.update(status="skip", skip_reason=reason)
        _write(cell, out_dir)
        if verbose:
            print(f"[skip] {cfg.name} x {shape.name} x {mesh_tag}: {reason}")
        return cell

    t0 = time.time()
    started = False
    try:
        started = _fake_world(n_dev)
        mesh = make_mesh(shp, axes, "cpu")
        prog = build_program(cfg, shape, mesh, **program_kw)
        t_build = time.time() - t0
        record = bool(out_dir and save_hlo) and shape.kind != "train"
        r = run_program_fake(prog, record=record)
        mem = {k: r[k] for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                 "peak_memory_in_bytes")}
        if record:
            cell["capture"] = f"{_stem(cell)}.tasks.json.gz"
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, cell["capture"]), "wb") as f:
                f.write(gzip_bytes(dumps(r["tasks"])))
        cell.update(status="ok", build_s=round(t_build, 2), run_s=round(r["run_s"], 2),
                    cost_analysis={"flops": r["flops"]}, memory_analysis=mem,
                    param_count=cfg.param_count(),
                    active_param_count=cfg.active_param_count())
        if verbose:
            print(f"[ok]   {cfg.name} x {shape.name} x {mesh_tag} "
                  f"(build {t_build:.1f}s, run {r['run_s']:.1f}s)")
            print(f"       memory_analysis: {mem}")
            print(f"       cost_analysis: flops={r['flops']:.3e} (per device)")
    except Exception as e:
        cell.update(status="fail", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[FAIL] {cfg.name} x {shape.name} x {mesh_tag}: {type(e).__name__}: {e}")
    finally:
        if started:
            dist.destroy_process_group()
    _write(cell, out_dir)
    return cell


def _cell_job(arch: str, shape: str, multi: bool, out_dir: str, save_hlo: bool,
              program_kw: Dict) -> Dict:
    return run_cell(arch, shape, multi, out_dir, save_hlo=save_hlo, **program_kw)


def _stem(cell: Dict) -> str:
    return f"{cell['arch']}__{cell['shape']}__{cell['mesh']}"


def _write(cell: Dict, out_dir: Optional[str]):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, _stem(cell) + ".json"), "w") as f:
        json.dump(cell, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--out", default="benchmarks/artifacts/dryrun_torch")
    p.add_argument("--no-hlo", action="store_true",
                   help="do not write the cells' captures (the reference: their HLO)")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--remat-policy", default="full", choices=["full", "save-attn"],
                   help="activation-checkpoint policy")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--jobs", type=int, default=1,
                   help="run the cells in this many worker processes, each cell in a "
                        "fresh one with its own fake process group")
    args = p.parse_args(argv)
    program_kw = {}
    if args.remat_policy != "full":
        program_kw["model_kw"] = {"remat_policy": args.remat_policy}
    if args.microbatches > 1:
        program_kw["microbatches"] = args.microbatches

    archs = list(REGISTRY) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results, todo = [], []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = MESH_TAGS[multi]
                if args.skip_existing:
                    f = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
                    if os.path.exists(f):
                        with open(f) as fh:
                            prev = json.load(fh)
                        if prev.get("status") in ("ok", "skip"):
                            print(f"[cached] {arch} x {shape} x {tag}: {prev['status']}")
                            results.append(prev)
                            continue
                todo.append((arch, shape, multi, args.out, not args.no_hlo, program_kw))
    if args.jobs > 1 and len(todo) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(args.jobs, len(todo)), maxtasksperchild=1) as pool:
            results += pool.starmap(_cell_job, todo, chunksize=1)
    else:
        results += [_cell_job(*job) for job in todo]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\n=== dry-run summary: {n_ok} ok, {n_skip} structural skips, "
          f"{n_fail} FAILED of {len(results)} cells ===")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
