"""Training entry point with checkpoint/restart fault tolerance, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 4 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --device cpu --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Counterpart of the JAX package's ``launch/train.py``: the same options,
plus ``--device`` (default the card; raises when no GPU is present),
``--seed`` and ``--layers`` (the arch at its full width with its depth cut
to N layers, for a model whose train state does not fit the card at full
depth: ``--arch qwen3-moe-30b-a3b --layers 4``). Synthetic data with a
checkpointed cursor: kill the process at any step and re-launch with the
same ``--ckpt-dir`` to resume from the newest complete checkpoint with
bit-identical batches. Parameters are drawn from the seed; no weights are
downloaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config
from ..configs.base import ShapeSpec
from ..device import resolve_device
from ..models import build_model
from ..train import (CheckpointManager, SyntheticData, init_state, latest_step,
                     make_train_step, restore_checkpoint, schedule_for)
from ..train.optim import tree_leaves

__all__ = ["main", "train"]


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          reduced: bool = False, layers: int | None = None, ckpt_dir: str = "",
          save_every: int = 25, microbatches: int = 1, compress: bool = False,
          dtype: torch.dtype = torch.float32, log_every: int = 10, peak_lr: float = 3e-4,
          seed: int = 0, device=None):
    """Run ``steps`` train steps (resuming from ``ckpt_dir`` when it holds a
    checkpoint). Returns the final state and one record per step run:
    loss, grad_norm and lr as floats, and the step's host wall time in
    seconds (``step_s``, after a device synchronize). The reference returns
    the losses alone. ``layers`` cuts the depth to that many layers."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, remat=True)
    shape = ShapeSpec("cli", seq, batch, "train")
    data = SyntheticData(cfg, shape, seed=seed, device=device)
    step_fn = make_train_step(
        model, microbatches=microbatches, compress=compress,
        lr_schedule=schedule_for(cfg, peak_lr=peak_lr, warmup=max(steps // 20, 1),
                                 total=steps))

    def fresh():
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_state(model, gen, dtype=dtype, compress=compress, device=device)

    start = 0
    state = None
    mgr = CheckpointManager(ckpt_dir, save_every=save_every) if ckpt_dir else None
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            state, cursor, _ = restore_checkpoint(ckpt_dir, last, fresh())
            start = cursor
            print(f"[resume] restored step {last}, data cursor {cursor}")
    if state is None:
        state = fresh()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"[train] {cfg.name} on {device}: {n_params/1e6:.1f}M params, "
          f"batch={batch} seq={seq} steps {start}->{steps}")

    history = []
    t0 = time.perf_counter()
    for s in range(start, steps):
        t1 = time.perf_counter()
        state, metrics = step_fn(state, data.batch_at(s))
        rec = {k: float(v) for k, v in metrics.items()}       # synchronizes
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec["step_s"] = time.perf_counter() - t1
        history.append(rec)
        if s % log_every == 0 or s == steps - 1:
            dt = time.perf_counter() - t0
            tps = (s - start + 1) * batch * seq / max(dt, 1e-9)
            print(f"  step {s:5d}  loss {rec['loss']:.4f}  lr {rec['lr']:.2e}  "
                  f"gnorm {rec['grad_norm']:.3f}  ({tps:,.0f} tok/s)")
        if mgr is not None:
            mgr.maybe_save(s + 1, state, data_cursor=s + 1, meta={"arch": cfg.name})
    if mgr is not None:
        mgr.wait()
    return state, history


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--save-every", type=int, default=25)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--compress", action="store_true", help="int8 EF gradient compression")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs "
                   "the plain versions")
    args = p.parse_args(argv)
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          reduced=args.reduced, layers=args.layers, ckpt_dir=args.ckpt_dir, save_every=args.save_every,
          microbatches=args.microbatches, compress=args.compress, peak_lr=args.lr,
          seed=args.seed, device=args.device,
          dtype=torch.bfloat16 if args.bf16 else torch.float32)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
