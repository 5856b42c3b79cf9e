"""Quickstart on the PyTorch port: the two halves of this repo.

  (A) the workload framework — build an assigned architecture, train a few
      steps, prefill + decode;
  (B) TPU-EM — compile a CNN workload to an event-simulated NPU, get
      timing + power, and replay a step through the vectorized sweeper
      (one list-schedule kernel launch on the card).

The counterpart of ``examples/quickstart.py`` at its sizes. It runs on the
CUDA card by default; ``--device cpu`` runs the plain versions of the
kernels.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.core.vectorized import from_tasks, params_of, schedule_many
from repro_torch.device import resolve_device
from repro_torch.graph.compiler import CompileOptions, compile_ops
from repro_torch.graph.workloads import mobilenet_v2
from repro_torch.hw.chip import System
from repro_torch.hw.presets import paper_skew
from repro_torch.models import build_model
from repro_torch.power.powerem import PowerEM
from repro_torch.train import SyntheticData, init_state, make_train_step


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs "
                   "the plain versions")
    p.add_argument("--steps", type=int, default=5, help="train steps of part (A)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    print("=== (A) workload framework ===")
    cfg = REGISTRY["smollm-135m"].reduced()
    model = build_model(cfg)
    state = init_state(model, torch.Generator(device=device).manual_seed(0),
                       dtype=torch.float32, device=device)
    data = SyntheticData(cfg, SHAPES["train_4k"], batch_override=4, seq_override=64,
                         device=device)
    step = make_train_step(model)
    for s in range(args.steps):
        state, m = step(state, data.batch_at(s))
        print(f"  train step {s}: loss {float(m['loss']):.4f}")

    prompt = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12))).to(device)}
    with torch.no_grad():
        logits, cache = model.prefill(state["params"], prompt, smax=64)
        tok = logits.argmax(-1)[:, None]
        out = []
        for _ in range(8):
            logits, cache = model.decode_step(state["params"], cache, tok)
            tok = logits.argmax(-1)[:, None]
            out.append(int(tok[0, 0]))
    print(f"  greedy decode: {out}")

    print("\n=== (B) TPU-EM: event-simulated NPU ===")
    hw = paper_skew()                       # 2K-MAC NPU-scale config
    ops = mobilenet_v2()
    cw = compile_ops(ops, hw, CompileOptions(n_tiles=2))
    sysm = System(hw, n_tiles=2)
    rep = sysm.run_workload(cw.tasks)
    print(f"  MobileNetV2 on 2 tiles: {rep.makespan_ns/1e6:.3f} ms "
          f"({1e9/rep.makespan_ns:.0f} inf/s), {len(cw.tasks)} tasks")
    for mod in ("tile0.mxu", "tile0.vpu", "dma", "hbm"):
        print(f"    {mod:10s} utilization {rep.utilization(mod)*100:5.1f}%")

    pem = PowerEM(hw, n_tiles=2)
    prep = pem.analyze(sysm.tracer, pti_ns=20_000)
    print(f"  Power-EM: avg {prep.avg_w:.2f} W, peak {prep.peak_w:.2f} W, "
          f"{prep.energy_j()*1e3:.3f} mJ/inference")

    arrays = from_tasks(cw.tasks)
    pm = np.stack([params_of(hw.replace(clock_ghz=f))
                   for f in (0.4, 0.7, 1.0, 1.3)])
    res = schedule_many(arrays, pm, device=device)
    print(f"  vectorized 4-freq sweep (one list-schedule launch on {device.type}): "
          f"{[f'{t/1e6:.2f}ms' for t in res]}")
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
