"""The paper's analysis workflow end-to-end (Figs 5-9 in one script):
computation scaling, frequency scaling, memory-BW scaling, power profile
and a DVFS policy pick — all on the event-simulated NPU.

  PYTHONPATH=src python examples/npu_analysis.py
"""
import numpy as np

from repro_torch.graph.compiler import CompileOptions, compile_ops
from repro_torch.graph.workloads import resnet50
from repro_torch.hw.chip import System, simulate
from repro_torch.hw.presets import paper_skew
from repro_torch.power.dvfs import choose_operating_point, sweep
from repro_torch.power.powerem import PowerEM

ops = resnet50()

print("== computation scaling (Fig 5) ==")
base = None
for n_mxu, tag in ((1, "2K MACs"), (2, "4K MACs")):
    for nt in (1, 2, 4):
        cfg = paper_skew(n_mxu=n_mxu)
        cw = compile_ops(ops, cfg, CompileOptions(n_tiles=nt))
        t = simulate(cw.tasks, cfg, n_tiles=nt).makespan_ns
        fps = 1e9 / t
        base = base or fps
        print(f"  {tag} x {nt} tile(s): {fps:7.1f} inf/s "
              f"({fps/base:.2f}x)")

print("== memory-BW scaling (Fig 7) ==")
for bw in (8, 17, 34, 68):
    cfg = paper_skew(hbm_gbps=float(bw))
    cw = compile_ops(ops, cfg, CompileOptions(n_tiles=2))
    t = simulate(cw.tasks, cfg, n_tiles=2).makespan_ns
    print(f"  DDR {bw:3d} GB/s: {1e9/t:7.1f} inf/s")

print("== frequency scaling + power (Figs 6/9) ==")
cfg = paper_skew()
pts = sweep(lambda c: compile_ops(ops, c, CompileOptions(n_tiles=2)).tasks,
            cfg, [0.4, 0.6, 0.8, 1.0, 1.2], n_tiles=2)
for p in pts:
    print(f"  {p.freq_ghz:.1f} GHz @ {p.volt:.3f} V: {p.inf_per_s:7.1f} "
          f"inf/s, {p.avg_w:6.2f} W avg, {p.inf_per_j:6.1f} inf/J")
pick = choose_operating_point(pts, min_inf_per_s=0.6 * pts[-1].inf_per_s)
print(f"  DVFS pick for 60% of peak perf: {pick.freq_ghz} GHz "
      f"({pick.avg_w:.2f} W)")

print("== power profile (Fig 8) ==")
cfg = paper_skew()
cw = compile_ops(ops, cfg, CompileOptions(n_tiles=2))
sysm = System(cfg, n_tiles=2)
sysm.run_workload(cw.tasks)
rep = PowerEM(cfg, n_tiles=2).analyze(sysm.tracer, pti_ns=50_000)
mods = [m for m in rep.series if not m.startswith("tile1")]
print("  PTI " + " ".join(f"{m:>10s}" for m in mods))
for b in range(min(6, len(rep.total_series))):
    print(f"  {b:3d} " + " ".join(f"{rep.series[m][b]:10.2f}" for m in mods))
print(f"  avg {rep.avg_w:.2f} W  peak {rep.peak_w:.2f} W")
