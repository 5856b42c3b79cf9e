"""Post-optimization HLO parser: the workload-ingestion front door of TPU-EM.

The paper's VPU-EM "interfaces directly with AI frameworks ... linking
in-house NPU graph compilers". Our compiler is XLA/GSPMD: this module parses
``compiled.as_text()`` (the scheduled, SPMD-partitioned, per-device HLO) and
produces:

  * trip-count-aware aggregate cost: dot/conv FLOPs, vector-unit element ops,
    an HBM-traffic estimate (fusion-level read+write), per-collective payload
    bytes with decoded replica groups (incl. iota format) and cross-pod
    detection — the three roofline terms come straight from this;
  * a dependency-carrying task list (``extract_tasks``) in scheduled order,
    which the event-driven simulator replays through the hardware models.

Why not ``compiled.cost_analysis()``: XLA's HloCostAnalysis visits a while
body ONCE — scanned-layer models under-count by the layer count. This parser
multiplies while bodies by their parsed trip counts (constant in the loop
condition), validated against cost_analysis on unrolled modules in tests.
"""
from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["parse_module", "summarize", "HloModule", "HloComputation",
           "HloInstr", "Collective", "Summary", "TaskSpec",
           "extract_tasks"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1, "token": 0,
    "opaque": 0,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute", "all-reduce-start", "all-gather-start",
                  "collective-permute-start")

TRIVIAL_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "partition-id", "replica-id", "iota", "copy-done",
    "all-reduce-done", "all-gather-done", "collective-permute-done",
    "opt-barrier",
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

# dtypes we have already warned about (warn ONCE per dtype token, not per
# shape): a missing DTYPE_BYTES entry silently zeroes every byte estimate
# that touches the shape, which ingestion would propagate into HBM/payload
# totals — make the gap loud without flooding the log
_WARNED_DTYPES: set = set()


def _shapes_of(type_str: str) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for m in _SHAPE_RE.finditer(type_str):
        dt = m.group(1)
        if dt not in DTYPE_BYTES:
            if dt not in _WARNED_DTYPES:
                _WARNED_DTYPES.add(dt)
                warnings.warn(
                    f"hlo_parser: unknown dtype {dt!r} in {type_str!r}; "
                    f"its shapes are dropped from every byte/element "
                    f"estimate — add it to DTYPE_BYTES",
                    stacklevel=2)
            continue
        dims = tuple(int(x) for x in m.group(2).split(",") if x)
        out.append((dt, dims))
    return out


def _bytes_of(shapes: Sequence[Tuple[str, Tuple[int, ...]]]) -> int:
    total = 0
    for dt, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        total += n * DTYPE_BYTES[dt]
    return total


def _elems_of(shapes: Sequence[Tuple[str, Tuple[int, ...]]]) -> int:
    total = 0
    for _, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        total += n
    return total


@dataclass
class HloInstr:
    name: str
    opcode: str
    out_shapes: List[Tuple[str, Tuple[int, ...]]]
    operands: List[str]
    attrs: str
    root: bool = False
    raw_operands: str = ""   # literal payload (constants carry values here)


@dataclass
class HloComputation:
    name: str
    instrs: List[HloInstr] = field(default_factory=list)
    table: Dict[str, List[Tuple[str, Tuple[int, ...]]]] = field(
        default_factory=dict)


@dataclass
class HloModule:
    name: str
    computations: Dict[str, HloComputation]
    entry: str


_COMP_HEAD = re.compile(
    r"^(ENTRY\s+)?%?([\w\.\-]+)\s+\((.*)\)\s*->\s*(.+)\s*\{\s*$")
_INSTR = re.compile(r"^\s+(ROOT\s+)?%?([\w\.\-]+)\s+=\s+(.*)$")
_OPERAND_NAME = re.compile(r"%([\w\.\-]+)")


def _split_rhs(rhs: str) -> Tuple[str, str, str, str]:
    """rhs = 'TYPE opcode(operands), attrs' -> (type, opcode, operands, attrs)."""
    i = 0
    if rhs.startswith("("):  # tuple type: balanced parens
        depth = 0
        for j, ch in enumerate(rhs):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    i = j + 1
                    break
        type_str = rhs[:i]
    else:
        i = rhs.index(" ")
        type_str = rhs[:i]
        # layout suffix like {1,0} belongs to the type
        rest = rhs[i:].lstrip()
        while rest.startswith("{"):
            j = rest.index("}")
            type_str += rest[: j + 1]
            rest = rest[j + 1:].lstrip()
            i = rhs.index(rest, i) if rest else len(rhs)
        if not rest:
            return type_str, "", "", ""
        rhs = rhs[: rhs.rindex(rest)] + rest  # normalize (no-op)
        i = rhs.rindex(rest)
    rest = rhs[i:].strip()
    p = rest.find("(")
    if p < 0:
        return type_str, rest, "", ""
    opcode = rest[:p].strip()
    depth = 0
    for j in range(p, len(rest)):
        if rest[j] == "(":
            depth += 1
        elif rest[j] == ")":
            depth -= 1
            if depth == 0:
                return type_str, opcode, rest[p + 1: j], rest[j + 1:]
    return type_str, opcode, rest[p + 1:], ""


def parse_module(text: str) -> HloModule:
    lines = text.split("\n")
    mod_name = "module"
    if lines and lines[0].startswith("HloModule"):
        mod_name = lines[0].split(",")[0].split()[1]
    comps: Dict[str, HloComputation] = {}
    entry = ""
    cur: Optional[HloComputation] = None
    for line in lines:
        if cur is None:
            m = _COMP_HEAD.match(line)
            if m:
                cur = HloComputation(m.group(2))
                if m.group(1):
                    entry = m.group(2)
                # header params: "name: type, name: type"
                params = m.group(3)
                for pm in re.finditer(r"([\w\.\-]+):\s*((?:\([^)]*\)|[^,])+)",
                                      params):
                    cur.table[pm.group(1)] = _shapes_of(pm.group(2))
            continue
        if line.strip() == "}":
            comps[cur.name] = cur
            cur = None
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        root, name, rhs = bool(m.group(1)), m.group(2), m.group(3)
        type_str, opcode, operands_str, attrs = _split_rhs(rhs)
        # strip metadata tail (big) but keep functional attrs
        operands = []
        # top-level comma split of operands
        depth = 0
        start = 0
        for j, ch in enumerate(operands_str):
            if ch in "({[":
                depth += 1
            elif ch in ")}]":
                depth -= 1
            elif ch == "," and depth == 0:
                operands.append(operands_str[start:j])
                start = j + 1
        if operands_str.strip():
            operands.append(operands_str[start:])
        names = []
        for op in operands:
            mm = list(_OPERAND_NAME.finditer(op))
            if mm:
                names.append(mm[-1].group(1))
        instr = HloInstr(name, opcode, _shapes_of(type_str), names, attrs,
                         root, raw_operands=operands_str)
        cur.instrs.append(instr)
        cur.table[name] = instr.out_shapes
    if cur is not None:
        comps[cur.name] = cur
    if not entry and comps:
        entry = list(comps)[-1]
    return HloModule(mod_name, comps, entry)


# ---------------------------------------------------------------------------
# replica-group decoding
# ---------------------------------------------------------------------------

_IOTA_RG = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_EXPL_RG = re.compile(r"replica_groups=\{\{([\d,{}\s]*)\}\}")


def decode_replica_groups(attrs: str) -> Optional[np.ndarray]:
    m = _IOTA_RG.search(attrs)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        reshape = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(reshape)))
        ids = ids.reshape(reshape)
        if m.group(4):
            perm = [int(x) for x in m.group(4).split(",")]
            ids = ids.transpose(perm)
        return ids.reshape(g, s)
    m = _EXPL_RG.search(attrs)
    if m:
        groups = [
            [int(x) for x in grp.split(",") if x.strip()]
            for grp in m.group(1).split("},{")
        ]
        width = max(len(g) for g in groups)
        return np.array([g + [-1] * (width - len(g)) for g in groups])
    return None


def _collective_io(op: str, out_b: float, opnd_b: float
                   ) -> Tuple[float, float]:
    """``(payload_bytes, out_bytes)`` of one collective instruction.

    Async ``*-start`` ops type their output as a tuple carrying BOTH the
    operand aliases and the result buffers (the ``-done`` peels the
    result off), so the raw output-byte count double-counts the payload
    — an ``all-reduce-start`` over N bytes parses as a 2N-byte output.
    Subtract the operand bytes to recover the result size; a backend
    that types ``-start`` as a bare array (no operand alias in the
    tuple) yields ``out_eff == 0`` and the operand size wins the max,
    which is the same payload the sync op would report.
    """
    out_eff = max(out_b - opnd_b, 0.0) if op.endswith("-start") else out_b
    return max(out_eff, opnd_b), out_eff


# ---------------------------------------------------------------------------
# cost aggregation
# ---------------------------------------------------------------------------

@dataclass
class Collective:
    op: str
    payload_bytes: int
    group_size: int
    n_groups: int
    count: float          # trip-scaled occurrence count
    crosses_pod: bool
    name: str = ""

    @property
    def total_bytes(self) -> float:
        return self.payload_bytes * self.count


@dataclass
class Summary:
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    vector_elems: float = 0.0
    hbm_bytes: float = 0.0
    collectives: List[Collective] = field(default_factory=list)
    op_counts: Dict[str, float] = field(default_factory=dict)
    unparsed_while: int = 0

    @property
    def flops(self) -> float:
        return self.dot_flops + self.conv_flops

    def collective_bytes(self, *, cross_pod: Optional[bool] = None) -> float:
        return sum(c.total_bytes for c in self.collectives
                   if cross_pod is None or c.crosses_pod == cross_pod)

    def link_bytes(self, *, cross_pod: Optional[bool] = None) -> float:
        """Per-device link traffic under ring schedules:
        all-reduce 2(n-1)/n, all-gather/reduce-scatter (n-1)/n, all-to-all
        (n-1)/n, permute 1x."""
        total = 0.0
        for c in self.collectives:
            if cross_pod is not None and c.crosses_pod != cross_pod:
                continue
            n = max(c.group_size, 1)
            if n == 1:
                continue
            if c.op.startswith("all-reduce"):
                f = 2 * (n - 1) / n
            elif c.op.startswith("collective-permute"):
                f = 1.0
            else:
                f = (n - 1) / n
            total += c.payload_bytes * c.count * f
        return total


class _Analyzer:
    def __init__(self, mod: HloModule, pod_size: int = 0,
                 free_converts: bool = True):
        self.mod = mod
        self.pod_size = pod_size
        self.free_converts = free_converts
        self.memo: Dict[Tuple[str, bool], Summary] = {}
        self.raw_trips: Dict[str, int] = {}

    # -- helpers -----------------------------------------------------------
    def _called(self, attrs: str, key: str) -> Optional[str]:
        m = re.search(key + r"=%?([\w\.\-]+)", attrs)
        return m.group(1) if m else None

    def _io_bytes(self, comp: HloComputation, ins: HloInstr) -> Tuple[float, float]:
        """(read, write) HBM-traffic estimate with slice/in-place semantics:
        a (dynamic-)slice/gather reads only the slice it produces; a
        dynamic-update-slice (incl. DUS-rooted fusions — XLA aliases these
        in place) reads/writes only the update region, not the buffer."""
        out_b = _bytes_of(ins.out_shapes)
        op = ins.opcode
        if op in ("dynamic-slice", "slice", "gather"):
            return float(out_b), float(out_b)
        if op == "dynamic-update-slice":
            upd = _bytes_of(comp.table.get(ins.operands[1], [])) \
                if len(ins.operands) > 1 else out_b
            return float(upd), float(upd)
        opnd_b = sum(_bytes_of(comp.table.get(o, [])) for o in ins.operands)
        if op in ("fusion", "call"):
            called = self._called(ins.attrs, "calls") or \
                self._called(ins.attrs, "to_apply")
            sub = self.mod.computations.get(called) if called else None
            if sub is not None:
                # refine reads: (dynamic-)slices/gathers of fusion params
                # read only their slice; resolve through trivial unary
                # chains (bitcast/reshape/copy/convert) back to the param
                alias: Dict[str, str] = {}
                for si in sub.instrs:
                    if si.opcode in ("bitcast", "reshape", "copy",
                                     "convert") and len(si.operands) == 1:
                        src = si.operands[0]
                        alias[si.name] = alias.get(src, src)
                sliced_params = {}
                for si in sub.instrs:
                    if si.opcode in ("dynamic-slice", "slice", "gather") and \
                            si.operands:
                        src = si.operands[0]
                        src = alias.get(src, src)
                        if src in sliced_params:
                            sliced_params[src] += _bytes_of(si.out_shapes)
                        else:
                            sliced_params[src] = _bytes_of(si.out_shapes)
                # map positional params (parameter(N) carries N) to operands
                param_names: Dict[int, str] = {}
                for si in sub.instrs:
                    if si.opcode == "parameter":
                        m = re.match(r"\s*(\d+)\s*$", si.raw_operands)
                        if m:
                            param_names[int(m.group(1))] = si.name
                reads = 0.0
                for idx, oname in enumerate(ins.operands):
                    pname = param_names.get(idx)
                    full = _bytes_of(comp.table.get(oname, []))
                    if pname is not None and pname in sliced_params:
                        reads += min(full, sliced_params[pname])
                    else:
                        reads += full
                # refine writes: a fusion containing a dynamic-update-slice
                # whose buffer is a same-sized fusion operand is an in-place
                # update (XLA aliases it): traffic = update region only,
                # and the buffer operand is not actually read in full
                dus_updates = 0
                for si in sub.instrs:
                    if si.opcode == "dynamic-update-slice" and \
                            len(si.operands) > 1:
                        dus_updates += _bytes_of(
                            sub.table.get(si.operands[1], []))
                if dus_updates and any(
                        _bytes_of(comp.table.get(o, [])) == out_b
                        for o in ins.operands):
                    reads = max(reads - out_b, 0.0) + float(dus_updates)
                    return reads, float(dus_updates)
                return reads, float(out_b)
        return float(opnd_b), float(out_b)

    def _trip(self, cond_name: str, body_name: str) -> int:
        cond = self.mod.computations.get(cond_name)
        if cond is None:
            return 1
        # find scalar s32 constants in the condition computation; a jax scan
        # lowers to `i = 0; while (i < L)`, so the compare constant is L
        consts = []
        for ins in cond.instrs:
            if ins.opcode == "constant" and ins.out_shapes and \
                    ins.out_shapes[0][1] == ():
                m = re.match(r"\s*(\d+)\s*$", ins.raw_operands)
                if m:
                    consts.append(int(m.group(1)))
        if consts:
            return max(consts)
        return 1

    def _fusion_gemm(self, called: Optional[str], depth: int = 0
                     ) -> Optional[Tuple[int, int, int, float]]:
        """Dominant inner dot/convolution geometry of a fusion/call
        computation: ``(m, n, k, flops)`` of the highest-FLOP
        contraction found (recursing through nested fusions), or None
        when the computation contains no contraction."""
        comp = self.mod.computations.get(called) if called else None
        if comp is None or depth > 4:
            return None
        best: Optional[Tuple[int, int, int, float]] = None
        for ins in comp.instrs:
            g = None
            if ins.opcode == "dot":
                g = _dot_mnk(comp, ins)
            elif ins.opcode == "convolution":
                g = _conv_mnk(comp, ins)
            elif ins.opcode in ("fusion", "call"):
                sub = self._called(ins.attrs, "calls") or \
                    self._called(ins.attrs, "to_apply")
                gf = self._fusion_gemm(sub, depth + 1)
                if gf and (best is None or gf[3] > best[3]):
                    best = gf
                continue
            if g is not None:
                cand = (*g, 2.0 * g[0] * g[1] * g[2])
                if best is None or cand[3] > best[3]:
                    best = cand
        return best

    def _dot_flops(self, comp: HloComputation, ins: HloInstr) -> float:
        out_elems = _elems_of(ins.out_shapes)
        lhs = comp.table.get(ins.operands[0]) if ins.operands else None
        m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.attrs)
        k = 1
        if lhs and m and m.group(1):
            dims = lhs[0][1]
            for c in m.group(1).split(","):
                ci = int(c)
                if ci < len(dims):
                    k *= dims[ci]
        return 2.0 * out_elems * k

    def _conv_flops(self, comp: HloComputation, ins: HloInstr) -> float:
        out_elems = _elems_of(ins.out_shapes)
        rhs = comp.table.get(ins.operands[1]) if len(ins.operands) > 1 else None
        if not rhs:
            return 2.0 * out_elems
        kernel_elems = 1
        for d in rhs[0][1]:
            kernel_elems *= d
        # divide by output-feature dim (approx: largest dim of kernel)
        of = max(rhs[0][1]) if rhs[0][1] else 1
        return 2.0 * out_elems * max(kernel_elems // max(of, 1), 1)

    # -- main recursion ------------------------------------------------------
    def analyze(self, comp_name: str, in_fusion: bool = False) -> Summary:
        key = (comp_name, in_fusion)
        if key in self.memo:
            return self.memo[key]
        comp = self.mod.computations.get(comp_name)
        s = Summary()
        if comp is None:
            self.memo[key] = s
            return s
        # placeholder to break recursion cycles (shouldn't occur in HLO)
        self.memo[key] = s
        for ins in comp.instrs:
            op = ins.opcode
            s.op_counts[op] = s.op_counts.get(op, 0) + 1
            if op in TRIVIAL_OPS:
                continue
            if op == "convert" and self.free_converts:
                # TPU semantics: dtype conversion is fused into the
                # producer/consumer (MXU output stage / VPU op) — the
                # CPU backend's materialized f32<->bf16 round-trips would
                # not exist in the target's program
                continue
            out_b = _bytes_of(ins.out_shapes)
            opnd_b = sum(
                _bytes_of(comp.table.get(o, [])) for o in ins.operands)
            rd, wr = self._io_bytes(comp, ins)
            io_b = rd + wr
            if op == "while":
                cond = self._called(ins.attrs, "condition")
                body = self._called(ins.attrs, "body")
                trip = self._trip(cond, body) if cond else 1
                if trip <= 0:
                    trip = 1
                    s.unparsed_while += 1
                for sub_name in (body, cond):
                    if not sub_name:
                        continue
                    sub = self.analyze(sub_name, in_fusion)
                    _accumulate(s, sub, trip)
                continue
            if op == "conditional":
                branches = re.search(r"branch_computations=\{([^}]*)\}",
                                     ins.attrs)
                best = None
                if branches:
                    for b in branches.group(1).split(","):
                        sub = self.analyze(b.strip().lstrip("%"), in_fusion)
                        if best is None or sub.flops > best.flops:
                            best = sub
                # true/false computations (binary conditional)
                for keyname in ("true_computation", "false_computation"):
                    cn = self._called(ins.attrs, keyname)
                    if cn:
                        sub = self.analyze(cn, in_fusion)
                        if best is None or sub.flops > best.flops:
                            best = sub
                if best:
                    _accumulate(s, best, 1.0)
                if not in_fusion:
                    s.hbm_bytes += io_b
                continue
            if op == "fusion" or op == "call":
                called = self._called(ins.attrs, "calls") or \
                    self._called(ins.attrs, "to_apply")
                if called:
                    sub = self.analyze(called, True)
                    s.dot_flops += sub.dot_flops
                    s.conv_flops += sub.conv_flops
                    s.vector_elems += sub.vector_elems
                    # collectives can't be fused; ignore sub.hbm (fused)
                if not in_fusion:
                    s.hbm_bytes += io_b
                continue
            if any(op.startswith(c) for c in
                   ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")):
                if op.endswith("-done"):
                    continue
                groups = decode_replica_groups(ins.attrs)
                gsize = int(groups.shape[1]) if groups is not None else 1
                ngroups = int(groups.shape[0]) if groups is not None else 1
                crosses = False
                if groups is not None and self.pod_size:
                    pods = groups // self.pod_size
                    crosses = bool(np.any(pods.max(axis=1) != pods.min(axis=1)))
                payload, out_eff = _collective_io(op, out_b, opnd_b)
                s.collectives.append(Collective(
                    op=op.replace("-start", ""), payload_bytes=payload,
                    group_size=gsize, n_groups=ngroups, count=1.0,
                    crosses_pod=crosses, name=ins.name))
                if not in_fusion:
                    s.hbm_bytes += opnd_b + out_eff
                continue
            if op == "dot":
                s.dot_flops += self._dot_flops(comp, ins)
                if not in_fusion:
                    s.hbm_bytes += io_b
                continue
            if op == "convolution":
                s.conv_flops += self._conv_flops(comp, ins)
                if not in_fusion:
                    s.hbm_bytes += io_b
                continue
            if op == "dynamic-update-slice":
                # in-place: vector work = the update region, not the buffer
                upd = _elems_of(comp.table.get(ins.operands[1], [])) \
                    if len(ins.operands) > 1 else _elems_of(ins.out_shapes)
                s.vector_elems += max(upd, 1)
                if not in_fusion:
                    s.hbm_bytes += io_b
                continue
            if op in ("reduce", "reduce-window", "sort", "scatter", "gather",
                      "select-and-scatter", "dynamic-slice",
                      "pad", "concatenate", "slice",
                      "broadcast", "transpose", "reshape", "convert", "copy",
                      "select", "compare", "add", "subtract", "multiply",
                      "divide", "exponential", "tanh", "rsqrt", "sqrt",
                      "maximum", "minimum", "log", "custom-call",
                      "rng-bit-generator", "reverse", "clamp", "map",
                      "reduce-precision", "copy-start"):
                s.vector_elems += max(_elems_of(ins.out_shapes), 1)
                if not in_fusion:
                    s.hbm_bytes += io_b
                continue
            # default: treat as vector work
            s.vector_elems += max(_elems_of(ins.out_shapes), 1)
            if not in_fusion:
                s.hbm_bytes += io_b
        self.memo[key] = s
        return s


def _accumulate(dst: Summary, src: Summary, factor: float):
    dst.dot_flops += src.dot_flops * factor
    dst.conv_flops += src.conv_flops * factor
    dst.vector_elems += src.vector_elems * factor
    dst.hbm_bytes += src.hbm_bytes * factor
    dst.unparsed_while += src.unparsed_while
    for c in src.collectives:
        dst.collectives.append(Collective(
            op=c.op, payload_bytes=c.payload_bytes, group_size=c.group_size,
            n_groups=c.n_groups, count=c.count * factor,
            crosses_pod=c.crosses_pod, name=c.name))
    for k, v in src.op_counts.items():
        dst.op_counts[k] = dst.op_counts.get(k, 0) + v * factor


def summarize(text: str, *, pod_size: int = 0,
              free_converts: bool = True) -> Summary:
    """Full-module trip-count-aware cost summary (per device).

    ``free_converts`` (default) applies TPU semantics to dtype converts —
    the CPU backend materializes f32<->bf16 round-trips around dots that
    the TPU target fuses away; counting them would distort the memory and
    vector terms of bf16 programs (recorded in EXPERIMENTS.md)."""
    mod = parse_module(text)
    return _Analyzer(mod, pod_size=pod_size,
                     free_converts=free_converts).analyze(mod.entry)


# ---------------------------------------------------------------------------
# task extraction for the event simulator
# ---------------------------------------------------------------------------

def _dot_mnk(comp: HloComputation, ins: HloInstr
             ) -> Optional[Tuple[int, int, int]]:
    """GEMM view of a dot: k = product of lhs contracting dims, n = the
    trailing output dim (rhs non-contracting), m = out_elems / n (batch
    dims fold into m — a batched GEMM walks the array batch-by-batch)."""
    if not ins.out_shapes:
        return None
    out_elems = _elems_of(ins.out_shapes)
    lhs = comp.table.get(ins.operands[0]) if ins.operands else None
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.attrs)
    k = 1
    if lhs and m and m.group(1):
        dims = lhs[0][1]
        for c in m.group(1).split(","):
            ci = int(c)
            if ci < len(dims):
                k *= dims[ci]
    dims = ins.out_shapes[0][1]
    n = dims[-1] if dims else 1
    return (max(out_elems // max(n, 1), 1), max(int(n), 1), max(int(k), 1))


def _conv_mnk(comp: HloComputation, ins: HloInstr
              ) -> Optional[Tuple[int, int, int]]:
    """im2col GEMM view of a convolution, consistent with
    ``_Analyzer._conv_flops``: n = output features (approx: the largest
    kernel dim), k = kernel elems per output feature."""
    out_elems = _elems_of(ins.out_shapes)
    rhs = comp.table.get(ins.operands[1]) if len(ins.operands) > 1 else None
    if not rhs or not rhs[0][1]:
        return (max(int(out_elems), 1), 1, 1)
    ke = 1
    for d in rhs[0][1]:
        ke *= d
    of = max(rhs[0][1])
    return (max(out_elems // max(of, 1), 1), max(int(of), 1),
            max(ke // max(of, 1), 1))


@dataclass
class TaskSpec:
    """One schedulable unit for TPU-EM (engine-mapped HLO instruction)."""

    name: str
    engine: str            # "mxu" | "vector" | "dma" | "ici"
    flops: float = 0.0
    elems: float = 0.0
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    collective: Optional[Collective] = None
    deps: Tuple[int, ...] = ()
    # GEMM view of the dominant contraction for "mxu" tasks (m, n, k);
    # None when the engine is not mxu or no dot/conv was found. For
    # fusions this is the geometry of the highest-FLOP inner dot — the
    # task's total ``flops`` may exceed 2*m*n*k when several dots fused.
    gemm: Optional[Tuple[int, int, int]] = None


def extract_tasks(text: str, *, pod_size: int = 0,
                  max_tasks: int = 2_000_000,
                  free_converts: bool = True) -> List[TaskSpec]:
    """Flatten the entry computation (expanding while loops by trip count)
    into an engine-mapped task DAG in scheduled order."""
    mod = parse_module(text)
    an = _Analyzer(mod, pod_size=pod_size, free_converts=free_converts)
    tasks: List[TaskSpec] = []

    def emit(comp_name: str, prefix: str, entry_deps: Tuple[int, ...]):
        comp = mod.computations.get(comp_name)
        if comp is None:
            return entry_deps
        local: Dict[str, int] = {}
        last: Tuple[int, ...] = entry_deps
        for ins in comp.instrs:
            if len(tasks) >= max_tasks:
                return last
            op = ins.opcode
            if op in TRIVIAL_OPS:
                continue
            if op == "convert" and free_converts:
                # alias through: consumers depend on the convert's operand
                src = ins.operands[0] if ins.operands else None
                if src in local:
                    local[ins.name] = local[src]
                continue
            deps = tuple(sorted({local[o] for o in ins.operands
                                 if o in local})) or entry_deps
            if op == "while":
                cond = an._called(ins.attrs, "condition")
                body = an._called(ins.attrs, "body")
                trip = an._trip(cond, body) if cond else 1
                carry = deps
                for it in range(max(trip, 1)):
                    carry = emit(body, f"{prefix}{ins.name}[{it}].", carry)
                    if len(tasks) >= max_tasks:
                        break
                if carry:
                    local[ins.name] = carry[-1]
                continue
            out_b = _bytes_of(ins.out_shapes)
            opnd_b = sum(_bytes_of(comp.table.get(o, []))
                         for o in ins.operands)
            rd, wr = an._io_bytes(comp, ins)
            if any(op.startswith(c) for c in
                   ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")):
                groups = decode_replica_groups(ins.attrs)
                gsize = int(groups.shape[1]) if groups is not None else 1
                crosses = False
                if groups is not None and pod_size:
                    pods = groups // pod_size
                    crosses = bool(np.any(pods.max(axis=1) != pods.min(axis=1)))
                payload, out_eff = _collective_io(op, out_b, opnd_b)
                coll = Collective(op=op.replace("-start", ""),
                                  payload_bytes=payload,
                                  group_size=gsize,
                                  n_groups=int(groups.shape[0]) if groups is not None else 1,
                                  count=1.0, crosses_pod=crosses,
                                  name=ins.name)
                t = TaskSpec(prefix + ins.name, "ici", bytes_in=opnd_b,
                             bytes_out=out_eff, collective=coll, deps=deps)
            elif op == "dot":
                t = TaskSpec(prefix + ins.name, "mxu",
                             flops=an._dot_flops(comp, ins),
                             bytes_in=rd, bytes_out=wr, deps=deps,
                             gemm=_dot_mnk(comp, ins))
            elif op == "convolution":
                t = TaskSpec(prefix + ins.name, "mxu",
                             flops=an._conv_flops(comp, ins),
                             bytes_in=rd, bytes_out=wr, deps=deps,
                             gemm=_conv_mnk(comp, ins))
            elif op in ("fusion", "call"):
                called = an._called(ins.attrs, "calls") or \
                    an._called(ins.attrs, "to_apply")
                sub = an.analyze(called, True) if called else Summary()
                engine = "mxu" if sub.flops > 0 else "vector"
                g = an._fusion_gemm(called) if engine == "mxu" else None
                t = TaskSpec(prefix + ins.name, engine, flops=sub.flops,
                             elems=sub.vector_elems, bytes_in=rd,
                             bytes_out=wr, deps=deps,
                             gemm=g[:3] if g else None)
            elif op in ("copy", "copy-start", "transpose", "reshape",
                        "broadcast", "concatenate", "slice",
                        "dynamic-slice", "dynamic-update-slice"):
                t = TaskSpec(prefix + ins.name, "dma", bytes_in=rd,
                             bytes_out=wr, deps=deps)
            else:
                t = TaskSpec(prefix + ins.name, "vector",
                             elems=max(_elems_of(ins.out_shapes), 1),
                             bytes_in=rd, bytes_out=wr, deps=deps)
            tasks.append(t)
            local[ins.name] = len(tasks) - 1
            last = (len(tasks) - 1,)
        return last

    emit(mod.entry, "", ())
    return tasks
