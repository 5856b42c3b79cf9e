"""End-to-end driver on the PyTorch port: train SmolLM-135M on synthetic
data, with periodic checkpoints and a kill-and-resume demonstration.

The counterpart of ``examples/train_lm.py``: the same options, plus
``--device`` (the CUDA card by default; ``cpu`` runs the plain versions of
the kernels) and ``--reduced`` (the arch's reduced() config, a CPU-sized
model). Checkpoints go to ``--ckpt-dir`` (by default under the temporary
directory); a second run with the same directory and more ``--steps``
resumes from the newest checkpoint with its data cursor.

Full run (~135M params):
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300

Smoke run on the CPU:
  PYTHONPATH=src python examples/torch_train_lm.py --steps 8 --seq 64 --batch 2 \\
      --reduced --device cpu
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.launch.train import train


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train_lm"))
    p.add_argument("--fresh", action="store_true")
    p.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs "
                   "the plain versions")
    args = p.parse_args(argv)
    if args.fresh and os.path.isdir(args.ckpt_dir):
        shutil.rmtree(args.ckpt_dir)

    state, history = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=args.reduced, ckpt_dir=args.ckpt_dir,
        save_every=max(args.steps // 6, 1), log_every=max(args.steps // 30, 1),
        device=args.device)
    losses = [r["loss"] for r in history]
    if not losses:
        print(f"\nnothing to run: the newest checkpoint in {args.ckpt_dir} is at step "
              f"{args.steps} or later")
        return
    k = max(len(losses) // 10, 1)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"\nloss: first-{k}-avg {first:.4f} -> last-{k}-avg {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    print(f"checkpoints in {args.ckpt_dir} — rerun the same command to "
          f"resume from the latest one (fault-tolerance path).")


if __name__ == "__main__":
    main()
