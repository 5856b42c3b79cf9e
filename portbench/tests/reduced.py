"""Cells at a size the CPU holds, for the tests: the configuration's widths
cut to the program's own ``reduced()`` scale, float32 unless asked, and
short traffic.

Each size is a data file beside this module, found by name, so a new
configuration or loop brings its own: ``sizes/configs/<reference>.json``
(the keys that replace the configuration's, by its ``reference``) and
``sizes/loops/<loop>.json`` (``traffic``, the keys that replace the mix's,
and ``faults``, the planted faults a cell of that loop can have).
"""
from pathlib import Path
from typing import Dict, List

from portbench.harness.common import load_json
from portbench.harness.runner import resolve

SIZES = Path(__file__).resolve().parent / "sizes"


def _sizes(kind: str, name: str) -> Dict:
    path = SIZES / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no test size for {kind[:-1]} {name!r}: add {path}")
    return load_json(path)


def reduced_spec(cell: str, dtype: str = "float32", bench=None):
    spec = resolve(cell, bench)
    spec["cfg"] = {**spec["cfg"], **_sizes("configs", spec["cfg"]["reference"]), "dtype": dtype}
    spec["traffic"] = {**spec["traffic"], **_sizes("loops", spec["traffic"]["loop"])["traffic"]}
    return spec


def faults(loop: str) -> List[str]:
    """The planted faults a cell of ``loop`` can have."""
    return _sizes("loops", loop)["faults"]
