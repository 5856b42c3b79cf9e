"""Serving entry point: batched generation with the ServeEngine on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --reduced --device cpu --dtype float32

Same options as the JAX package's ``launch/serve.py``, plus ``--device`` (default
``cuda``; raises when no GPU is present) and ``--dtype``. Parameters are
drawn from seed 0; no weights are downloaded.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device, resolve_dtype
from ..models import build_model
from ..serve import ServeEngine

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new", type=int, default=12)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--smax", type=int, default=128)
    p.add_argument("--deadline", type=int, default=0,
                   help="straggler deadline (decode steps); 0 = none")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", help="bfloat16 | float32")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    dtype = resolve_dtype(args.dtype)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, dtype, device)
    eng = ServeEngine(model, params, smax=args.smax)
    rng = np.random.default_rng(0)
    rids = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, rng.integers(4, 16))
        rids.append(eng.submit(prompt, max_new=args.max_new,
                               deadline_steps=args.deadline or None))
    t0 = time.perf_counter()
    out = eng.run(batch_size=args.batch)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    print(f"[serve] {cfg.name} on {device}: {len(out)}/{args.requests} requests, "
          f"{total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s), "
          f"evicted={len(eng.evicted)}")
    for rid in rids[:3]:
        if rid in out:
            print(f"  req {rid}: {out[rid]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
