#!/usr/bin/env python
"""Regenerate the captured torch-program fixtures under
``src/repro_torch/configs/torch_graphs/``.

Each fixture is the task list one device runs in one of the port's own
programs, ``repro_torch.launch.programs.build_program(arch, shape, mesh)``,
recorded by ``repro_torch.graph.capture`` (the counterpart of
``tools/gen_hlo_fixtures.py``'s compiled HLO, for the same three
programs: ``repro_torch.graph.torch_ingest.CAPTURES``). Each program runs
once at full width and depth on fake CPU tensors under torch's fake
process group of the mesh's ranks: nothing is allocated or downloaded,
and no weights are needed. The task list is written as gzipped JSON
(``<fixture>.tasks.json.gz``, mtime 0, so the same capture gives the same
bytes) beside a ``manifest.json`` entry with the generation parameters,
the hand-built twin, the HLO counterpart, the analytic deviation band
against the twin and the SHA-256 of the decompressed JSON.

Needs torch (CPU), not jax. From the repo root:

    python tools/gen_torch_fixtures.py [--out src/repro_torch/configs/torch_graphs]

Bands are kept from an existing manifest (measured numbers: PERF.md); a
new fixture starts with the permissive default and is tightened after
``python -m repro_torch.sweep crosscheck-hlo
src/repro_torch/configs/torch_graphs/crosscheck.json --device cpu``.
"""
import argparse
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

DEFAULT_BAND = [0.2, 5.0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "src", "repro_torch", "configs",
                                                  "torch_graphs"))
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.graph.capture import dumps, gzip_bytes
    from repro_torch.graph.torch_ingest import CAPTURES
    from repro_torch.launch.dryrun import capture_fake

    os.makedirs(args.out, exist_ok=True)
    man_path = os.path.join(args.out, "manifest.json")
    old: dict = {"fixtures": {}}
    if os.path.exists(man_path):
        with open(man_path) as f:
            old = json.load(f)

    fixtures = {}
    for name, arch, seq, batch, kind, mesh_shape, twin in CAPTURES:
        cfg = get_config(arch)
        text = dumps(capture_fake(cfg, ShapeSpec(f"fx_{name}", seq, batch, kind), mesh_shape))
        fname = f"{name}.tasks.json.gz"
        with open(os.path.join(args.out, fname), "wb") as f:
            f.write(gzip_bytes(text))
        prev = old.get("fixtures", {}).get(name, {})
        fixtures[name] = {
            "file": fname,
            "sha256": hashlib.sha256(text).hexdigest(),
            "arch": arch,
            "shape": {"seq_len": seq, "global_batch": batch, "kind": kind},
            "mesh": list(mesh_shape),
            "layers": cfg.n_layers,
            "phase": kind,
            "pod_size": 0,
            "twin": twin,
            "hlo": name,
            "band": prev.get("band", list(DEFAULT_BAND)),
        }
        print(f"{name}: {len(text) / 1024:.0f} KB of JSON -> {fname}")

    with open(man_path, "w") as f:
        json.dump({"generator": "tools/gen_torch_fixtures.py", "fixtures": fixtures}, f,
                  indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {man_path} ({len(fixtures)} fixtures)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
