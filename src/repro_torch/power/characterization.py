"""Power characterization data (paper §5.1).

Per power node:  P_total = P_lkg + P_dyn
  P_lkg = P_lkg0 * LkgRatio_LUT(T, V) / LkgRatio_LUT(T0, V0)
  P_dyn = (Cdyn_idle + Cdyn_active * utilization) * F * V_adj^2,
  V_adj = f2v(F, T)                                  (characterized VF curve)

The paper extracts Cdyn/leakage from PrimePower runs on the backend
implementation; no silicon backend exists here, so the default set below is
an invented-but-self-consistent characterization for the v5e-like target
(sums to a ~200W chip at peak) — the *machinery* (LUTs, VF curves, fitting)
is the reproduction target, and ``fit_table``-style validation lives in
tests. All values are per *chip*; tile-level nodes divide by tile count.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Tuple


__all__ = ["LeakageLUT", "VFCurve", "PowerChar", "DEFAULT_CHARS",
           "NOMINAL_TEMP_C", "NOMINAL_FREQ_GHZ"]

NOMINAL_TEMP_C = 60.0
NOMINAL_FREQ_GHZ = 0.94


@dataclass(frozen=True)
class LeakageLUT:
    """Leakage ratio grid over (temp C, voltage V) — bilinear interp."""

    temps: Tuple[float, ...] = (25.0, 60.0, 85.0, 105.0)
    volts: Tuple[float, ...] = (0.6, 0.75, 0.9, 1.05)
    # ratios[i][j] at (temps[i], volts[j]); leakage grows ~exp in T and ~V^2
    ratios: Tuple[Tuple[float, ...], ...] = (
        (0.45, 0.62, 0.85, 1.15),
        (0.72, 1.00, 1.38, 1.86),
        (1.10, 1.52, 2.10, 2.84),
        (1.55, 2.15, 2.96, 4.00),
    )

    def lookup(self, temp: float, volt: float) -> float:
        ts, vs = self.temps, self.volts
        t = min(max(temp, ts[0]), ts[-1])
        v = min(max(volt, vs[0]), vs[-1])
        i = min(bisect.bisect_right(ts, t) - 1, len(ts) - 2)
        j = min(bisect.bisect_right(vs, v) - 1, len(vs) - 2)
        ft = (t - ts[i]) / (ts[i + 1] - ts[i])
        fv = (v - vs[j]) / (vs[j + 1] - vs[j])
        r = self.ratios
        return ((1 - ft) * (1 - fv) * r[i][j] + (1 - ft) * fv * r[i][j + 1]
                + ft * (1 - fv) * r[i + 1][j] + ft * fv * r[i + 1][j + 1])


@dataclass(frozen=True)
class VFCurve:
    """f2v: piecewise-linear minimum voltage vs frequency, + temp adder."""

    freqs_ghz: Tuple[float, ...] = (0.3, 0.5, 0.7, 0.94, 1.1, 1.25)
    volts: Tuple[float, ...] = (0.60, 0.65, 0.70, 0.75, 0.85, 0.95)
    temp_coeff_v_per_c: float = 0.0004   # hot silicon needs a little more V

    def f2v(self, freq_ghz: float, temp_c: float = NOMINAL_TEMP_C) -> float:
        fs, vs = self.freqs_ghz, self.volts
        f = min(max(freq_ghz, fs[0]), fs[-1])
        i = min(bisect.bisect_right(fs, f) - 1, len(fs) - 2)
        frac = (f - fs[i]) / (fs[i + 1] - fs[i])
        v = vs[i] + frac * (vs[i + 1] - vs[i])
        return v + self.temp_coeff_v_per_c * (temp_c - NOMINAL_TEMP_C)


@dataclass(frozen=True)
class PowerChar:
    """One module's characterization (PrimePower-extraction stand-in)."""

    p_lkg0_w: float            # leakage @ (T0, V0)
    c_dyn_idle_nf: float       # clock-tree etc., workload-independent
    c_dyn_active_nf: float     # at utilization=1 (synthetic max workload)
    lut: LeakageLUT = LeakageLUT()
    vf: VFCurve = VFCurve()

    def leakage_w(self, temp_c: float, volt: float) -> float:
        base = self.lut.lookup(NOMINAL_TEMP_C, self.vf.f2v(NOMINAL_FREQ_GHZ))
        return self.p_lkg0_w * self.lut.lookup(temp_c, volt) / base

    def dynamic_w(self, freq_ghz: float, utilization: float,
                  temp_c: float = NOMINAL_TEMP_C) -> float:
        v = self.vf.f2v(freq_ghz, temp_c)
        c_nf = self.c_dyn_idle_nf + self.c_dyn_active_nf * min(
            max(utilization, 0.0), 1.0)
        # P = C * F * V^2 ; nF * GHz = watts per V^2
        return c_nf * freq_ghz * v * v

    def total_w(self, freq_ghz: float, utilization: float,
                temp_c: float = NOMINAL_TEMP_C) -> float:
        v = self.vf.f2v(freq_ghz, temp_c)
        return self.leakage_w(temp_c, v) + self.dynamic_w(
            freq_ghz, utilization, temp_c)


# invented characterization: ~200W chip at peak, ~45W idle+leakage
# (per-chip; Power-EM divides tile-level nodes by n_tiles)
DEFAULT_CHARS: Dict[str, PowerChar] = {
    "mxu": PowerChar(p_lkg0_w=6.0, c_dyn_idle_nf=14.0, c_dyn_active_nf=160.0),
    "vpu": PowerChar(p_lkg0_w=2.0, c_dyn_idle_nf=5.0, c_dyn_active_nf=38.0),
    "vmem": PowerChar(p_lkg0_w=3.0, c_dyn_idle_nf=6.0, c_dyn_active_nf=30.0),
    "hbm": PowerChar(p_lkg0_w=4.0, c_dyn_idle_nf=8.0, c_dyn_active_nf=52.0),
    "dma": PowerChar(p_lkg0_w=0.8, c_dyn_idle_nf=1.5, c_dyn_active_nf=9.0),
    "noc": PowerChar(p_lkg0_w=0.7, c_dyn_idle_nf=1.5, c_dyn_active_nf=7.0),
    "ici": PowerChar(p_lkg0_w=1.5, c_dyn_idle_nf=3.0, c_dyn_active_nf=16.0),
    "top": PowerChar(p_lkg0_w=5.0, c_dyn_idle_nf=10.0, c_dyn_active_nf=12.0),
}
