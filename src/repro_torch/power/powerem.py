"""Power-EM mode: joint performance/power analysis (paper §5).

A hierarchical **power-node tree** (from a config dict, the yaml analog) is
bonded to the performance models through the shared activity ``Tracer``:
each node names the tracer-module prefix it measures and its *maximum
activity* per Table 2 (DMA/NOC: max transfer BW; CB/DDR: max access bytes;
DPU/DSP: ideal op count). Per user-defined **power-trace interval (PTI)**,
utilization = measured / max activity, and

    P(node, pti) = P_lkg(T, V_adj) + (Cdyn_idle + Cdyn_active*util)*F*V_adj^2

with V_adj from the characterized VF curve. Peak/average power, per-module
transient profiles (Fig 8) and joint perf/power sweeps (Fig 9) all read
from this.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from ..core import SampleArrays, Tracer
from ..core.trace import pti_bins
from ..hw.presets import HwConfig
from .characterization import DEFAULT_CHARS, NOMINAL_TEMP_C, PowerChar

__all__ = ["PowerNode", "build_power_tree", "PowerEM", "PowerReport",
           "analytic_power_w", "pod_power_w"]


@dataclass
class PowerNode:
    name: str
    char: PowerChar
    module_prefix: str            # tracer module prefix this node measures
    activity_kind: str            # "ops" | "bytes"
    max_rate_per_ns: float        # Table-2 maximum activity per ns
    scale: float = 1.0            # char fraction (tile-level split)
    children: List["PowerNode"] = field(default_factory=list)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def build_power_tree(cfg: HwConfig, n_tiles: int = 1) -> PowerNode:
    """Chip power hierarchy bonded to the System's tracer module names.

    Characterization constants are the v5e-reference values; area-dependent
    nodes scale with the configured hardware size (MACs, lanes, capacities,
    BW) so down-skewed NPU configs draw NPU-scale power."""
    import dataclasses as _dc

    ref = HwConfig()  # v5e reference the DEFAULT_CHARS were sized for

    def sized(c: PowerChar, ratio: float) -> PowerChar:
        r = max(min(ratio, 4.0), 1e-3)
        return _dc.replace(c, p_lkg0_w=c.p_lkg0_w * r,
                           c_dyn_idle_nf=c.c_dyn_idle_nf * r,
                           c_dyn_active_nf=c.c_dyn_active_nf * r)

    ch = dict(DEFAULT_CHARS)
    ch["mxu"] = sized(ch["mxu"], n_tiles * cfg.macs / ref.macs)
    ch["vpu"] = sized(ch["vpu"], n_tiles * cfg.vpu_flops_per_cycle
                      / ref.vpu_flops_per_cycle)
    ch["vmem"] = sized(ch["vmem"], n_tiles * cfg.vmem_bytes / ref.vmem_bytes)
    ch["hbm"] = sized(ch["hbm"], cfg.hbm_gbps / ref.hbm_gbps)
    ch["dma"] = sized(ch["dma"], cfg.dma_channels / ref.dma_channels)
    ch["ici"] = sized(ch["ici"], cfg.ici_link_gbps / ref.ici_link_gbps)
    ch["noc"] = sized(ch["noc"], cfg.ici_link_gbps / ref.ici_link_gbps)
    tile_scale = 1.0 / n_tiles
    tiles = []
    for i in range(n_tiles):
        t = PowerNode(
            name=f"tile{i}", char=ch["top"], module_prefix=f"tile{i}",
            activity_kind="ops", max_rate_per_ns=1.0, scale=0.0,
            children=[
                PowerNode(f"tile{i}.mxu", ch["mxu"], f"tile{i}.mxu", "ops",
                          max_rate_per_ns=cfg.macs * cfg.clock_ghz,
                          scale=tile_scale),
                PowerNode(f"tile{i}.vpu", ch["vpu"], f"tile{i}.vpu", "ops",
                          max_rate_per_ns=cfg.vpu_flops_per_cycle
                          * cfg.clock_ghz, scale=tile_scale),
                PowerNode(f"tile{i}.vmem", ch["vmem"], f"tile{i}.vmem",
                          "bytes",
                          max_rate_per_ns=cfg.vmem_ports
                          * cfg.vmem_port_bytes_per_cycle * cfg.clock_ghz,
                          scale=tile_scale),
            ])
        tiles.append(t)
    root = PowerNode(
        name="chip", char=ch["top"], module_prefix="", activity_kind="ops",
        max_rate_per_ns=1.0, scale=1.0,
        children=tiles + [
            PowerNode("hbm", ch["hbm"], "hbm", "bytes",
                      max_rate_per_ns=cfg.hbm_gbps),
            PowerNode("dma", ch["dma"], "dma", "bytes",
                      max_rate_per_ns=cfg.hbm_gbps),
            PowerNode("noc", ch["noc"], "noc", "bytes",
                      max_rate_per_ns=cfg.ici_link_gbps * cfg.ici_links),
            PowerNode("ici", ch["ici"], "ici", "bytes",
                      max_rate_per_ns=cfg.ici_link_gbps * cfg.ici_links),
        ])
    return root


def analytic_power_w(cfg: HwConfig, util: Dict[str, float], *,
                     n_tiles: int = 1, freq_ghz: Optional[float] = None,
                     temp_c: float = NOMINAL_TEMP_C) -> float:
    """Whole-run average chip power from coarse per-module utilizations.

    The sweep pre-screen has no tracer — only the analytic scheduler's
    per-engine-class busy fractions. This walks the same characterized
    power tree as ``PowerEM`` but applies one flat utilization per module
    family (keys of ``util``: ``mxu``/``vpu``/``vmem``/``hbm``/``dma``/
    ``ici``/``noc``; missing keys default to 0). Used to rank grid points
    (Pareto energy axis); the event-engine refinement replaces it with the
    PTI-resolved number.
    """
    f = freq_ghz if freq_ghz is not None else cfg.clock_ghz
    tree = build_power_tree(cfg, n_tiles)
    total = 0.0
    for node in tree.walk():
        if node.scale <= 0.0 and node.children:
            continue
        family = node.name.rsplit(".", 1)[-1] if "." in node.name \
            else node.name
        u = util.get(family, 0.0) if node.name != "chip" else 1.0
        total += node.scale * node.char.total_w(f, u, temp_c)
    return total


def pod_power_w(cfg: HwConfig, util: Dict[str, float], *, chips: int,
                n_tiles: int = 1, freq_ghz: Optional[float] = None,
                temp_c: float = NOMINAL_TEMP_C) -> float:
    """Fleet-level average power for ``chips`` identical devices.

    Serving fleets and pod campaigns run symmetric SPMD programs: every
    chip executes the same per-device schedule, so one chip's analytic
    power under the shared utilization profile scales linearly to the
    whole fleet. (DCN switches and host machines are out of scope, as
    they are for the per-chip power tree.)
    """
    if chips < 1:
        raise ValueError(f"need chips >= 1, got {chips}")
    return chips * analytic_power_w(cfg, util, n_tiles=n_tiles,
                                    freq_ghz=freq_ghz, temp_c=temp_c)


@dataclass
class PowerReport:
    pti_ns: float
    t_end_ns: float
    series: Dict[str, List[float]]      # node -> watts per PTI
    util: Dict[str, List[float]]        # node -> utilization per PTI

    @property
    def total_series(self) -> List[float]:
        n = max((len(v) for v in self.series.values()), default=0)
        out = [0.0] * n
        for v in self.series.values():
            for i, x in enumerate(v):
                out[i] += x
        return out

    @property
    def avg_w(self) -> float:
        s = self.total_series
        return sum(s) / len(s) if s else 0.0

    @property
    def peak_w(self) -> float:
        return max(self.total_series, default=0.0)

    def energy_j(self) -> float:
        return self.avg_w * self.t_end_ns * 1e-9


class PowerEM:
    """Bond a power tree to a finished simulation's tracer and integrate."""

    def __init__(self, cfg: HwConfig, *, n_tiles: int = 1,
                 freq_ghz: Optional[float] = None,
                 temp_c: float = NOMINAL_TEMP_C,
                 tree: Optional[PowerNode] = None):
        self.cfg = cfg
        self.freq = freq_ghz if freq_ghz is not None else cfg.clock_ghz
        self.temp = temp_c
        self.tree = tree or build_power_tree(cfg, n_tiles)

    def analyze(self, tracer: Union[Tracer, SampleArrays], *,
                pti_ns: float = 10_000.0,
                t_end_ns: Optional[float] = None,
                power_gating: bool = False,
                gate_after_idle_ptis: int = 2,
                gate_residual: float = 0.3) -> PowerReport:
        """Per-PTI joint analysis, vectorized over interval arrays.

        Accepts either a live ``Tracer`` or its ``SampleArrays`` export
        (the form ``core.fastsim`` synthesizes). Activity is binned with
        one ``np.add.at`` per node and the affine per-node power curve is
        applied array-wise — arithmetic replicates the reference loop
        operation for operation, so records are byte-identical to the
        pre-vectorization implementation (locked by a test).

        ``power_gating`` implements the paper's §6.2 future work (active
        power-state management): a module idle for ``gate_after_idle_ptis``
        consecutive PTIs drops to a gated state — idle dynamic power off,
        leakage scaled by ``gate_residual`` (retention rails). Wake is
        charged one PTI of full idle power (state-transition cost); its
        sequential idle-run state keeps that path on the scalar loop.
        """
        sa = tracer if isinstance(tracer, SampleArrays) \
            else tracer.sample_arrays()
        horizon = t_end_ns if t_end_ns is not None else sa.makespan()
        series: Dict[str, List[float]] = {}
        util: Dict[str, List[float]] = {}
        for node in self.tree.walk():
            if node.scale <= 0.0 and node.children:
                continue  # pure grouping node
            acts = pti_bins(sa, sa.module_ids_with_prefix(node.module_prefix),
                            node.activity_kind, pti_ns, t_end=horizon)
            max_per_pti = node.max_rate_per_ns * pti_ns
            # frequency scaling moves compute capacity with F
            if node.activity_kind == "ops":
                max_per_pti *= self.freq / self.cfg.clock_ghz
            if max_per_pti > 0:
                u_arr = np.minimum(acts / max_per_pti, 1.0)
            else:
                u_arr = np.zeros_like(acts)
            us = u_arr.tolist()
            if power_gating:
                ws = []
                idle_run = 0
                gated = False
                for u in us:
                    if u <= 0.0:
                        idle_run += 1
                    else:
                        if gated:
                            idle_run = 0  # wake-up: full power this PTI
                        gated = False
                        idle_run = 0
                    if not gated and idle_run >= gate_after_idle_ptis:
                        gated = True
                    if gated and u <= 0.0:
                        v = node.char.vf.f2v(self.freq, self.temp)
                        ws.append(node.scale * gate_residual
                                  * node.char.leakage_w(self.temp, v))
                        continue
                    ws.append(node.scale * node.char.total_w(
                        self.freq, u, self.temp))
            else:
                # affine per-node power: same expression tree as
                # PowerChar.total_w, applied array-wise (bitwise-equal)
                ch = node.char
                v = ch.vf.f2v(self.freq, self.temp)
                leak = ch.leakage_w(self.temp, v)
                c_nf = ch.c_dyn_idle_nf + ch.c_dyn_active_nf * \
                    np.minimum(np.maximum(u_arr, 0.0), 1.0)
                ws = (node.scale * (leak + c_nf * self.freq * v * v)).tolist()
            series[node.name] = ws
            util[node.name] = us
        return PowerReport(pti_ns=pti_ns, t_end_ns=horizon, series=series,
                           util=util)
