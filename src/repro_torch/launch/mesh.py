"""Mesh construction for the production pods.

Counterpart of ``repro/launch/mesh.py``, over ``torch.distributed``:
a mesh is a ``DeviceMesh`` built with ``init_device_mesh`` over the default
process group, which the caller starts (``init_process_group``) with as many
ranks as the mesh has devices. Every constructor is a FUNCTION: importing
this module touches no process group and no device.

Production topology (as the reference sizes it):
  single pod : 16 x 16  = 256 devices, axes (data, model)
  multi-pod  : 2 x 16 x 16 = 512 devices, axes (pod, data, model)
A world of 256 or 512 ranks exists here only under torch's fake process
group (backend ``"fake"``), which the dry-run starts in one process.
"""
from __future__ import annotations

from typing import Tuple

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_mesh", "single_device_mesh",
           "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu") -> DeviceMesh:
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """1x1 mesh with the standard axis names, over a world of one rank."""
    return make_mesh((1, 1), ("data", "model"), device_type)
