"""Hardware configuration records (the paper's hierarchical yaml configs).

``HwConfig`` carries every tunable the scaling analyses sweep: MAC array
geometry (computation scaling, Fig 5), clock (frequency scaling, Fig 6),
HBM bandwidth/latency (memory-BW scaling, Fig 7), VMEM capacity/ports, DMA
channels/compression, ICI/DCN links. ``from_yaml``/``to_yaml`` round-trip
the hierarchy exactly as §3.3 "Parameter Configuration" describes.

The v5e preset is the TPU-adaptation reference point: 4x(128x128) MXU
@940MHz -> 197 bf16 TFLOP/s, 16 GiB HBM2e @819 GB/s, 128 MiB VMEM,
4 ICI links x ~50 GB/s/dir, DCN 25 GB/s.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

__all__ = ["HwConfig", "V5E", "V5E_HALF_MACS", "paper_skew", "from_dict",
           "to_dict", "PRESETS", "resolve_preset"]


@dataclass(frozen=True)
class HwConfig:
    name: str = "tpu-v5e"
    # clock / voltage operating point
    clock_ghz: float = 0.94
    # MXU (DPU analog): n_mxu systolic arrays of rows x cols MACs
    n_mxu: int = 4
    mxu_rows: int = 128
    mxu_cols: int = 128
    mxu_fill_overlap: bool = True     # pipelined fill between blocks
    # vector unit (DSP analog): lanes x sublanes, flops/lane/cycle
    vpu_lanes: int = 128
    vpu_sublanes: int = 8
    vpu_flops_per_lane: float = 2.0
    # VMEM (compute buffer analog)
    vmem_bytes: int = 128 * 2**20
    vmem_ports: int = 4
    vmem_port_bytes_per_cycle: int = 1024
    vmem_block_budget: int = 12 * 2**20   # working set per MXU block set
    # HBM (DDR analog)
    hbm_bytes: int = 16 * 2**30
    hbm_gbps: float = 819.0
    hbm_channels: int = 16
    hbm_burst_bytes: int = 512
    hbm_page_bytes: int = 2048
    hbm_banks: int = 16
    hbm_t_hit_ns: float = 25.0
    hbm_t_miss_ns: float = 55.0
    hbm_page_policy: str = "open"     # open | closed
    # DMA (tensor-aware, multi-channel)
    dma_channels: int = 8
    dma_desc_overhead_ns: float = 250.0
    dma_max_request_bytes: int = 1 * 2**20
    dma_compression: bool = False
    dma_compression_ratio: float = 0.6    # compressed/raw (activations)
    dma_decomp_ns_per_kb: float = 1.0
    # ICI (inter-chip NOC analog)
    ici_links: int = 4
    ici_link_gbps: float = 50.0
    ici_latency_ns: float = 1000.0
    router_arbitration: str = "rr"    # rr | priority
    # DCN (cross-pod)
    dcn_gbps: float = 25.0
    dcn_latency_ns: float = 10_000.0
    # scheduling
    queue_depth: int = 16
    pipeline_depth: int = 2           # double buffering between stages

    # -- derived ------------------------------------------------------------
    @property
    def macs(self) -> int:
        return self.n_mxu * self.mxu_rows * self.mxu_cols

    @property
    def peak_tflops(self) -> float:
        """bf16 peak: 2 flops/MAC/cycle."""
        return 2 * self.macs * self.clock_ghz * 1e9 / 1e12

    @property
    def vpu_flops_per_cycle(self) -> float:
        return self.vpu_lanes * self.vpu_sublanes * self.vpu_flops_per_lane

    @property
    def hbm_bytes_per_ns(self) -> float:
        return self.hbm_gbps  # GB/s == bytes/ns

    @property
    def ici_bytes_per_ns(self) -> float:
        return self.ici_link_gbps

    @property
    def cycle_ns(self) -> float:
        return 1.0 / self.clock_ghz

    def replace(self, **kw) -> "HwConfig":
        return dataclasses.replace(self, **kw)


V5E = HwConfig()

# the paper's Fig-5 style "2K MAC" variant (half the MXUs)
V5E_HALF_MACS = V5E.replace(name="tpu-v5e-half", n_mxu=2)


def paper_skew(**kw) -> HwConfig:
    """NPU-scale config for the paper's §4 analyses (the paper notes its
    data uses deliberately skewed configs, not product KPIs). Sized like
    the VPU compute tile: a 2K-MAC array, small CB, DDR-class memory —
    at this scale the CNN workloads reproduce the paper's tile/MAC/BW
    scaling behaviors."""
    base = V5E.replace(
        name="npu-2k",
        clock_ghz=1.0,
        n_mxu=1, mxu_rows=32, mxu_cols=64,          # 2K MACs ("2K" config)
        vpu_lanes=64, vpu_sublanes=2,
        vmem_bytes=2 * 2**20, vmem_ports=2, vmem_port_bytes_per_cycle=128,
        vmem_block_budget=512 * 2**10,
        hbm_gbps=34.0, hbm_channels=4, hbm_page_bytes=4096,
        hbm_t_hit_ns=30.0, hbm_t_miss_ns=70.0,
        dma_channels=4, dma_desc_overhead_ns=400.0,
        ici_link_gbps=16.0, ici_latency_ns=300.0,
        queue_depth=8,
    )
    return base.replace(**kw)


# named base points for declarative sweep specs (repro_torch.sweep)
PRESETS: Dict[str, Any] = {
    "v5e": lambda **kw: V5E.replace(**kw) if kw else V5E,
    "v5e-half": lambda **kw: V5E_HALF_MACS.replace(**kw) if kw
    else V5E_HALF_MACS,
    "paper_skew": paper_skew,
}


def resolve_preset(name: str, **overrides) -> HwConfig:
    """Preset name + field overrides -> HwConfig (sweep-spec entrypoint)."""
    try:
        factory = PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown hw preset {name!r}; "
                       f"have {sorted(PRESETS)}") from None
    return factory(**overrides)


def to_dict(cfg: HwConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_dict(d: Dict[str, Any]) -> HwConfig:
    return HwConfig(**d)
