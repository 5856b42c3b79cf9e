"""Serving example on the PyTorch port: batched requests through the
ServeEngine, including a straggler that exceeds its decode deadline and
gets re-queued.

The counterpart of ``examples/serve_lm.py`` at its sizes (reduced
qwen2-1.5b, random weights from a seed). It runs on the CUDA card by
default; ``--device cpu`` runs the plain versions of the kernels.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs "
                   "the plain versions")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = REGISTRY["qwen2-1.5b"].reduced()
    model = build_model(cfg, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(0), torch.float32, device)
    eng = ServeEngine(model, params, smax=96)

    rng = np.random.default_rng(7)
    normal = [eng.submit(rng.integers(0, cfg.vocab_size, 10), max_new=12)
              for _ in range(5)]
    straggler = eng.submit(rng.integers(0, cfg.vocab_size, 10), max_new=64,
                           deadline_steps=8)

    t0 = time.time()
    with torch.no_grad():
        out = eng.run(batch_size=3)
    dt = time.time() - t0
    tok = sum(len(v) for v in out.values())
    print(f"{len(out)} completed, {len(eng.evicted)} evicted after retries, "
          f"{tok} tokens in {dt:.2f}s")
    for rid in normal:
        print(f"  req {rid}: {out[rid][:8]}...")
    # eng.completed, not out: out also holds the tokens an evicted straggler made
    print(f"  straggler {straggler}: "
          f"{'completed' if straggler in eng.completed else 'evicted (deadline)'}")


if __name__ == "__main__":
    main()
