"""Operator-level workloads for TPU-EM analyses.

Two families:

* The paper's own CNN-era benchmark models (Table 1 / Figs 5-9):
  MobileNet v2 (224), ResNet50 (224), Tiny YOLO v2 (416) as explicit op
  lists built from their public layer specs. Variants: ``_C`` (DMA
  compression), ``_S`` (sparsity acceleration), ``_SC`` (both) — matching
  the paper's accuracy-characterization grid.

* LM-family workloads derived from an ``ArchConfig`` (per-device op list
  for one layer stack step) — used to cross-check the HLO-extracted task
  graphs and to run Fig-5-style scaling on modern workloads.

Ops are engine-agnostic records; ``graph.compiler`` maps them to tiles,
inserts DMA tasks + barriers, and applies variant effects.

LM workloads carry an **inference phase**:

* ``phase="prefill"`` (default) — one forward pass over ``seq`` prompt
  tokens per sequence; compute-bound at realistic sizes (big GEMMs,
  weights amortized over ``seq * batch`` tokens).
* ``phase="decode"`` — ONE autoregressive step: ``batch`` new tokens
  (m=batch GEMVs against the full weight set) attending over a
  ``kv_len``-token KV cache. The cache lives in HBM, so its read/append
  traffic is emitted with ``Op.stream=True`` (never VMEM-resident) —
  this is the memory-bound, latency-dominated regime; flops/byte
  collapses from O(seq) to O(batch).

Worked example — the decode op-list shape::

    >>> from repro_torch.configs import get_config
    >>> ops = lm_layer_ops(get_config("qwen3-32b"), batch=8,
    ...                    phase="decode", kv_len=4096, tp_shards=2)
    >>> [(o.name, o.kind) for o in ops][:6]
    [('qkv', 'matmul'), ('kv_append', 'eltwise'), ('scores', 'matmul'),
     ('softmax', 'softmax'), ('pv', 'matmul'), ('attn_out', 'matmul')]
    >>> next(o for o in ops if o.name == "qkv").m     # m = batch GEMVs
    8
    >>> next(o for o in ops if o.name == "scores").n  # contracts the cache
    4096

MoE archs additionally take ``ep_shards`` (expert parallelism): with
``ep_shards > 1`` the experts are sharded over an EP group and the op
list carries ``alltoall`` dispatch/combine collectives — the op-list
mirror of ``models/moe.py``'s ``moe_ep`` shard_map path (capacity-
bucketed tokens exchanged with ``jax.lax.all_to_all``).

**Full-model workloads** (``lm_model_ops``) compose ``lm_layer_ops``
into the paper's "full model performance ... at scale in minutes"
object (§2.3): ``layers`` sequential copies of the layer op list (each
layer's weights re-streamed from HBM, each layer's KV traffic emitted)
plus a model head (final norm + vocab-sharded LM head), placed on a
``hw.pod.PodShape`` (DP x EP x TP over pods). Placement semantics:

* ``batch`` is the **global** batch; DP shards it (``batch/dp_shards``
  sequences per chip). Inference phases need **no** DP collective —
  replicas are independent — while ``phase="train"`` appends a DP
  gradient all-reduce over the per-device weight-shard bytes (the
  gradient/none split per phase).
* TP all-reduces, EP all-to-alls, and the DP gradient all-reduce carry
  ``Op.cross_pod`` from ``PodShape.crosses_pod(axis)``: a collective
  whose ring leaves the pod is paced by DCN instead of ICI when
  ``graph.compiler`` lowers it onto the fabric (symmetric replay: one
  paced chip, ring collectives — see the ``hw/pod.py`` docstring).
* ``phase="train"`` models a step as the standard 3x-forward shape:
  forward + dgrad (same GEMMs, TP/EP collectives re-run) + wgrad (same
  GEMMs, no collectives, no weight re-read) per layer.

Parameterized workload names (``resolve_workload``) encode all of this:

    lm/<arch>/s<seq>b<batch>tp<tp>[ep<ep>]          prefill (one layer)
    lm/<arch>/decode/kv<kv_len>b<batch>tp<tp>[ep<ep>]  decode (one layer)
    lm/<arch>/L<layers>/[train/|decode/]...[dp<dp>][pod<chips>]  full model

e.g. ``lm/qwen3-32b/decode/kv4096b8tp2`` (one decode layer) or
``lm/qwen3-32b/L64/decode/kv4096b16tp4dp4pod8`` (the full 64-layer
model, global batch 16 over DP=4, TP=4, on 8-chip pods) or
``lm/qwen3-32b/L64/train/s1024b8tp4dp2``.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..configs.base import ArchConfig
from ..hw.pod import PodShape

__all__ = ["Op", "mobilenet_v2", "resnet50", "tiny_yolo_v2", "WORKLOADS",
           "lm_layer_ops", "lm_model_ops", "ModelParts", "model_parts",
           "lm_workload_name", "lm_grid_names", "parse_lm_name",
           "resolve_workload", "is_workload", "workload_flops",
           "workload_bytes"]


@dataclass(frozen=True)
class Op:
    name: str
    kind: str              # conv | dwconv | matmul | pool | eltwise | act |
    #                        softmax | global_pool | allreduce | alltoall
    # GEMM view (conv is im2col'd): out[M,N] = in[M,K] @ w[K,N]
    m: int = 0
    n: int = 0
    k: int = 0
    # element counts for vector ops
    elems: float = 0.0
    vec_kind: str = "generic"
    # tensor footprints (bytes, at dtype_bytes=1 int8 unless overridden)
    in_bytes: float = 0.0
    out_bytes: float = 0.0
    w_bytes: float = 0.0
    sparsity: float = 0.0  # fraction of MACs skippable by sparsity HW
    group: int = 1         # collective group size (allreduce/alltoall ops)
    stream: bool = False   # force HBM streaming even when the working set
    #                        fits VMEM (KV-cache reads/appends: the cache
    #                        lives in HBM across decode steps)
    cross_pod: bool = False  # collective ring leaves the ICI domain and
    #                          is paced by DCN (set from PodShape)

    @property
    def flops(self) -> float:
        if self.kind in ("conv", "matmul"):
            return 2.0 * self.m * self.n * self.k
        return self.elems


def _conv(name, hw_in, cin, cout, k, stride=1, act_sparsity=0.35) -> Op:
    ho = hw_in // stride
    m = ho * ho
    kk = k * k * cin
    return Op(name=name, kind="conv", m=m, n=cout, k=kk,
              in_bytes=hw_in * hw_in * cin, out_bytes=ho * ho * cout,
              w_bytes=k * k * cin * cout, sparsity=act_sparsity)


def _dwconv(name, hw_in, c, k, stride=1) -> Op:
    ho = hw_in // stride
    return Op(name=name, kind="dwconv", elems=ho * ho * c * k * k,
              vec_kind="mul",
              in_bytes=hw_in * hw_in * c, out_bytes=ho * ho * c,
              w_bytes=k * k * c)


def _pool(name, hw_in, c, k=2, stride=2) -> Op:
    ho = hw_in // stride
    return Op(name=name, kind="pool", elems=ho * ho * c * k * k,
              vec_kind="reduce",
              in_bytes=hw_in * hw_in * c, out_bytes=ho * ho * c)


def _eltwise(name, hw, c) -> Op:
    return Op(name=name, kind="eltwise", elems=hw * hw * c, vec_kind="add",
              in_bytes=2 * hw * hw * c, out_bytes=hw * hw * c)


def _fc(name, cin, cout) -> Op:
    return Op(name=name, kind="matmul", m=1, n=cout, k=cin,
              in_bytes=cin, out_bytes=cout, w_bytes=cin * cout)


def mobilenet_v2(res: int = 224) -> List[Op]:
    ops: List[Op] = [_conv("stem", res, 3, 32, 3, 2)]
    hw = res // 2
    cin = 32
    # (expansion t, out channels c, repeats n, stride s) — the public config
    stages = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    bi = 0
    for t, c, n, s in stages:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            pre = f"b{bi}"
            if t != 1:
                ops.append(_conv(f"{pre}.expand", hw, cin, hidden, 1))
            ops.append(_dwconv(f"{pre}.dw", hw, hidden, 3, stride))
            hw2 = hw // stride
            ops.append(_conv(f"{pre}.project", hw2, hidden, c, 1))
            if stride == 1 and cin == c:
                ops.append(_eltwise(f"{pre}.res", hw2, c))
            hw, cin = hw2, c
            bi += 1
    ops.append(_conv("head", hw, cin, 1280, 1))
    ops.append(Op("gap", "global_pool", elems=hw * hw * 1280,
                  vec_kind="reduce", in_bytes=hw * hw * 1280,
                  out_bytes=1280))
    ops.append(_fc("fc", 1280, 1000))
    return ops


def resnet50(res: int = 224) -> List[Op]:
    ops: List[Op] = [_conv("stem", res, 3, 64, 7, 2),
                     _pool("stem.pool", res // 2, 64, 3, 2)]
    hw = res // 4
    cin = 64
    stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
    bi = 0
    for width, n, s in stages:
        for i in range(n):
            stride = s if i == 0 else 1
            pre = f"b{bi}"
            ops.append(_conv(f"{pre}.c1", hw, cin, width, 1))
            hw2 = hw // stride
            ops.append(_conv(f"{pre}.c2", hw, width, width, 3, stride))
            ops.append(_conv(f"{pre}.c3", hw2, width, width * 4, 1))
            if i == 0:
                ops.append(_conv(f"{pre}.down", hw, cin, width * 4, 1,
                                 stride))
            ops.append(_eltwise(f"{pre}.res", hw2, width * 4))
            hw, cin = hw2, width * 4
            bi += 1
    ops.append(Op("gap", "global_pool", elems=hw * hw * cin,
                  vec_kind="reduce", in_bytes=hw * hw * cin, out_bytes=cin))
    ops.append(_fc("fc", cin, 1000))
    return ops


def tiny_yolo_v2(res: int = 416) -> List[Op]:
    ops: List[Op] = []
    hw = res
    cin = 3
    for i, c in enumerate([16, 32, 64, 128, 256, 512]):
        ops.append(_conv(f"c{i}", hw, cin, c, 3))
        stride = 2 if i < 5 else 1
        if i < 5:
            ops.append(_pool(f"p{i}", hw, c, 2, 2))
            hw //= 2
        else:
            ops.append(_pool(f"p{i}", hw, c, 2, 1))
        cin = c
    ops.append(_conv("c6", hw, cin, 1024, 3))
    ops.append(_conv("c7", hw, 1024, 1024, 3))
    ops.append(_conv("out", hw, 1024, 125, 1))
    return ops


WORKLOADS = {
    "mobilenet_v2": mobilenet_v2,
    "resnet50": resnet50,
    "tiny_yolo_v2": tiny_yolo_v2,
}


def lm_layer_ops(cfg: ArchConfig, *, seq: int = 0, batch: int,
                 dtype_bytes: int = 2, tp_shards: int = 1,
                 phase: str = "prefill", kv_len: int = 0,
                 ep_shards: int = 1) -> List[Op]:
    """Per-device op list for ONE transformer layer (forward): qkv/attn/out
    + FFN or MoE. TP sharding divides head and ff dims.

    ``phase="prefill"`` processes ``seq`` tokens per sequence (one
    forward pass over the prompt; ``kv_len`` must stay 0). ``phase=
    "decode"`` emits ONE autoregressive step: ``T = batch`` new tokens
    (m=batch GEMVs), a per-layer KV-cache append, and score/pv GEMMs
    contracting over the ``kv_len``-token cache whose HBM read traffic
    (``batch * n_kv_heads/tp * kv_len * hd`` bytes per side, GQA-aware)
    is forced to stream (``Op.stream``).

    MoE archs: ``ep_shards > 1`` shards experts over an EP group and
    adds ``alltoall`` dispatch/combine collectives (tokens bucketed per
    peer at ``capacity_factor``, as in ``models.moe.moe_ep``); with
    ``ep_shards == 1`` experts stay tensor-sharded over TP and the
    combine is the Megatron ``mlp_allreduce``.
    """
    if phase not in ("prefill", "decode"):
        raise ValueError(f"phase must be prefill|decode, got {phase!r}")
    if phase == "decode":
        if kv_len < 1:
            raise ValueError("decode phase needs kv_len >= 1")
        if seq not in (0, 1):
            raise ValueError("decode phase processes one token per "
                             "sequence; leave seq unset")
    else:
        if seq < 1:
            raise ValueError("prefill phase needs seq >= 1")
        if kv_len:
            raise ValueError("kv_len only applies to phase='decode'")
    if ep_shards > 1 and not cfg.is_moe:
        raise ValueError(f"ep_shards > 1 needs a MoE arch, "
                         f"got {cfg.name} ({cfg.family})")
    d = cfg.d_model
    H = max(cfg.n_heads // tp_shards, 1)
    KV = max(cfg.n_kv_heads // max(tp_shards, 1), 1)
    hd = cfg.hd
    decode = phase == "decode"
    # tokens processed this step (per device): the whole prompt in
    # prefill, one new token per sequence in decode
    T = batch if decode else seq * batch
    ctx = kv_len if decode else seq     # attention context length
    # bytes of K (or V) cache read per step: GQA reads kv heads only
    kv_side = batch * KV * ctx * hd * dtype_bytes
    ops = [
        Op("qkv", "matmul", m=T, n=(H + 2 * KV) * hd, k=d,
           in_bytes=T * d * dtype_bytes,
           out_bytes=T * (H + 2 * KV) * hd * dtype_bytes,
           w_bytes=d * (H + 2 * KV) * hd * dtype_bytes),
    ]
    if decode:
        # append this step's K,V rows to the HBM-resident cache
        ops.append(Op("kv_append", "eltwise", elems=2 * T * KV * hd,
                      vec_kind="copy",
                      in_bytes=2 * T * KV * hd * dtype_bytes,
                      out_bytes=2 * T * KV * hd * dtype_bytes, stream=True))
    ops += [
        Op("scores", "matmul", m=T * H, n=ctx, k=hd,
           in_bytes=(T * H * hd * dtype_bytes + kv_side) if decode
           else 2 * T * H * hd * dtype_bytes,
           out_bytes=T * H * ctx * 4, stream=decode),
        Op("softmax", "softmax", elems=T * H * ctx, vec_kind="softmax",
           in_bytes=T * H * ctx * 4, out_bytes=T * H * ctx * dtype_bytes),
        Op("pv", "matmul", m=T * H, n=hd, k=ctx,
           in_bytes=T * H * ctx * dtype_bytes + (kv_side if decode else 0),
           out_bytes=T * H * hd * dtype_bytes, stream=decode),
        Op("attn_out", "matmul", m=T, n=d, k=H * hd,
           in_bytes=T * H * hd * dtype_bytes, out_bytes=T * d * dtype_bytes,
           w_bytes=H * hd * d * dtype_bytes),
    ]
    if cfg.is_moe:
        k_top, E = cfg.experts_per_token, cfg.n_experts
        cf = cfg.capacity_factor
        f = cfg.d_ff
        ep = max(ep_shards, 1)
        # ep==1: experts tensor-sharded over TP (Megatron expert-TP,
        # tokens replicated). ep>1: experts owned by EP peers; every
        # peer contributes T local tokens, so per-expert capacity sees
        # the whole group's assignments (ep * T * k / E).
        E_local = max(E // (ep if ep > 1 else tp_shards), 1)
        cap = int(max(ep, 1) * T * k_top / E * cf) + 1 if ep > 1 \
            else int(T * k_top / E * cf) + 1
        # capacity-bucketed token exchange to the expert owners (mirrors
        # models.moe.moe_ep: send buffer [ep, cap, d]); dispatch and
        # combine move the same bytes
        a2a_bytes = int(T * k_top * cf + 1) * d * dtype_bytes
        ops.append(
            Op("router", "matmul", m=T, n=E, k=d,
               in_bytes=T * d * dtype_bytes, out_bytes=T * E * 4,
               w_bytes=d * E * dtype_bytes))
        if ep > 1:
            ops.append(Op("moe_dispatch", "alltoall",
                          in_bytes=a2a_bytes, out_bytes=a2a_bytes,
                          group=ep))
        ops += [
            Op("experts_up", "matmul", m=E_local * cap, n=2 * f, k=d,
               in_bytes=E_local * cap * d * dtype_bytes,
               out_bytes=E_local * cap * 2 * f * dtype_bytes,
               w_bytes=E_local * 2 * d * f * dtype_bytes),
            Op("experts_down", "matmul", m=E_local * cap, n=d, k=f,
               in_bytes=E_local * cap * f * dtype_bytes,
               out_bytes=E_local * cap * d * dtype_bytes,
               w_bytes=E_local * f * d * dtype_bytes),
        ]
        if ep > 1:
            ops.append(Op("moe_combine", "alltoall",
                          in_bytes=a2a_bytes, out_bytes=a2a_bytes,
                          group=ep))
    elif cfg.d_ff:
        f = cfg.d_ff // max(tp_shards, 1)
        ops += [
            Op("ffn_up", "matmul", m=T, n=2 * f, k=d,
               in_bytes=T * d * dtype_bytes, out_bytes=T * 2 * f * dtype_bytes,
               w_bytes=2 * d * f * dtype_bytes),
            Op("silu", "act", elems=T * f, vec_kind="sigmoid",
               in_bytes=T * 2 * f * dtype_bytes,
               out_bytes=T * f * dtype_bytes),
            Op("ffn_down", "matmul", m=T, n=d, k=f,
               in_bytes=T * f * dtype_bytes, out_bytes=T * d * dtype_bytes,
               w_bytes=f * d * dtype_bytes),
        ]
    if tp_shards > 1:
        # Megatron-style TP: one all-reduce after the attention output
        # projection and one after the MLP/MoE down projection (the MoE
        # combine is the EP alltoall instead when ep_shards > 1)
        ar_bytes = T * d * dtype_bytes
        i_attn = next(i for i, o in enumerate(ops) if o.name == "attn_out")
        ops.insert(i_attn + 1, Op("attn_allreduce", "allreduce",
                                  in_bytes=ar_bytes, out_bytes=ar_bytes,
                                  group=tp_shards))
        if not (cfg.is_moe and ep_shards > 1):
            ops.append(Op("mlp_allreduce", "allreduce",
                          in_bytes=ar_bytes, out_bytes=ar_bytes,
                          group=tp_shards))
    ops.append(Op("norms", "eltwise", elems=2 * T * d, vec_kind="rsqrt",
                  in_bytes=T * d * dtype_bytes, out_bytes=T * d * dtype_bytes))
    return ops


# -- full-model composition -------------------------------------------------

_MODEL_PHASES = ("prefill", "decode", "train")
# op kind -> parallelism axis its collective group lives on
_COLLECTIVE_AXIS = {"allreduce": "tp", "alltoall": "ep"}


def _place(ops: List[Op], pod: PodShape) -> List[Op]:
    """Stamp ``cross_pod`` onto collectives per the pod placement."""
    return [dataclasses.replace(o, cross_pod=pod.crosses_pod(
        _COLLECTIVE_AXIS[o.kind])) if o.kind in _COLLECTIVE_AXIS else o
        for o in ops]


def _lm_body_ops(cfg: ArchConfig, *, seq: int, local_batch: int, phase: str,
                 kv_len: int, tp_shards: int, ep_shards: int, pod: PodShape,
                 dtype_bytes: int) -> List[Op]:
    """One layer of the full model (per-device, placed on ``pod``).

    ``train`` is the standard 3x-forward step shape: forward + dgrad
    (same GEMMs and TP/EP collectives, backward through the layer) +
    wgrad (same GEMMs, no collectives, produces rather than reads
    weights). Inference phases are ``lm_layer_ops`` verbatim.
    """
    if phase == "train":
        fwd = lm_layer_ops(cfg, seq=seq, batch=local_batch,
                           tp_shards=tp_shards, ep_shards=ep_shards,
                           dtype_bytes=dtype_bytes)
        body = list(fwd)
        body += [dataclasses.replace(o, name="dgrad." + o.name)
                 for o in fwd]
        body += [dataclasses.replace(o, name="wgrad." + o.name, w_bytes=0.0)
                 for o in fwd if o.kind not in _COLLECTIVE_AXIS]
    else:
        body = lm_layer_ops(cfg, seq=seq, batch=local_batch, phase=phase,
                            kv_len=kv_len, tp_shards=tp_shards,
                            ep_shards=ep_shards, dtype_bytes=dtype_bytes)
    return _place(body, pod)


def _lm_head_ops(cfg: ArchConfig, *, T: int, phase: str, layers: int,
                 tp_shards: int, pod: PodShape, dtype_bytes: int,
                 layer_w_bytes: float) -> List[Op]:
    """Once-per-model ops: final norm + vocab-sharded LM head (logits
    stay TP-sharded, no collective), plus — train only, the DP
    "gradient" semantics — one gradient all-reduce over the per-device
    weight-shard bytes. Inference DP replicas are independent: "none".
    """
    d = cfg.d_model
    V = max(cfg.padded_vocab // max(tp_shards, 1), 1)
    ops = [
        Op("final_norm", "eltwise", elems=T * d, vec_kind="rsqrt",
           in_bytes=T * d * dtype_bytes, out_bytes=T * d * dtype_bytes),
        Op("lm_head", "matmul", m=T, n=V, k=d,
           in_bytes=T * d * dtype_bytes, out_bytes=T * V * 4,
           w_bytes=d * V * dtype_bytes),
    ]
    if phase == "train" and pod.dp > 1:
        grad_bytes = layers * layer_w_bytes + d * V * dtype_bytes
        ops.append(Op("grad_allreduce", "allreduce", in_bytes=grad_bytes,
                      out_bytes=grad_bytes, group=pod.dp,
                      cross_pod=pod.crosses_pod("dp")))
    return ops


def _model_args(cfg: ArchConfig, *, layers: int, batch: int, seq: int,
                phase: str, kv_len: int, dp_shards: int, tp_shards: int,
                ep_shards: int, pod_chips: int) -> Tuple[int, int, PodShape]:
    """Validate full-model parameters; return (local_batch, T, pod)."""
    if phase not in _MODEL_PHASES:
        raise ValueError(f"phase must be prefill|decode|train, "
                         f"got {phase!r}")
    if layers < 1:
        raise ValueError(f"full model needs layers >= 1, got {layers}")
    if dp_shards < 1 or batch % dp_shards:
        raise ValueError(f"global batch {batch} must divide over "
                         f"dp_shards={dp_shards}")
    if phase == "train" and (seq < 1 or kv_len):
        raise ValueError("train phase needs seq >= 1 and no kv_len")
    local = batch // dp_shards
    if local < 1:
        raise ValueError(f"batch {batch} < dp_shards {dp_shards}")
    pod = PodShape(dp=dp_shards, tp=tp_shards, ep=ep_shards,
                   pod_chips=pod_chips)
    T = local if phase == "decode" else seq * local
    return local, T, pod


def lm_model_ops(cfg: ArchConfig, *, layers: int, batch: int, seq: int = 0,
                 phase: str = "prefill", kv_len: int = 0,
                 dp_shards: int = 1, tp_shards: int = 1, ep_shards: int = 1,
                 pod_chips: int = 0, dtype_bytes: int = 2) -> List[Op]:
    """Per-device op list for the FULL model on a pod shape.

    ``layers`` sequential copies of the per-layer op list (ops renamed
    ``L<i>.<name>``; every layer's weights re-stream HBM->VMEM, every
    layer's KV traffic is emitted) followed by the model head. ``batch``
    is the global batch, sharded over ``dp_shards`` replicas; TP/EP/DP
    collectives carry ``cross_pod`` per ``PodShape(dp, tp, ep,
    pod_chips)`` placement. Embedding lookup (a cheap gather) is not
    modeled.

    The per-layer body is exactly ``model_parts(name).body()``, so the
    sweep pre-screen can evaluate one layer analytically and scale the
    stats in closed form instead of walking ``layers`` copies — the
    event engine still simulates this full list.
    """
    local, T, pod = _model_args(
        cfg, layers=layers, batch=batch, seq=seq, phase=phase,
        kv_len=kv_len, dp_shards=dp_shards, tp_shards=tp_shards,
        ep_shards=ep_shards, pod_chips=pod_chips)
    body = _lm_body_ops(cfg, seq=seq, local_batch=local, phase=phase,
                        kv_len=kv_len, tp_shards=tp_shards,
                        ep_shards=ep_shards, pod=pod,
                        dtype_bytes=dtype_bytes)
    layer_w = sum(o.w_bytes for o in body
                  if not o.name.startswith(("dgrad.", "wgrad.")))
    ops = [dataclasses.replace(o, name=f"L{i}.{o.name}")
           for i in range(layers) for o in body]
    ops += _lm_head_ops(cfg, T=T, phase=phase, layers=layers,
                        tp_shards=tp_shards, pod=pod,
                        dtype_bytes=dtype_bytes, layer_w_bytes=layer_w)
    return ops


@dataclass(frozen=True)
class ModelParts:
    """Layer-replication decomposition of a full-model workload.

    ``full == layers x body (renamed L<i>.*) + head`` — the contract
    ``tests/test_invariants.py`` locks down. ``body_key``/``head_key``
    identify the part graphs independently of ``layers``, so a sweep
    over layer counts compiles/pre-screens each distinct part once.
    """

    layers: int
    body: Callable[[], List[Op]]
    head: Callable[[], List[Op]]
    body_key: str
    head_key: str


# -- parameterized LM workload names ---------------------------------------
#
# ``lm/<arch>/s<seq>b<batch>tp<tp>[ep<ep>]`` names one prefill
# ``lm_layer_ops`` instance; ``lm/<arch>/decode/kv<kv>b<batch>tp<tp>[ep<ep>]``
# names one decode step (one token per sequence against a <kv>-token KV
# cache). An ``L<layers>/`` segment selects the FULL model
# (``lm_model_ops``): ``train/`` becomes a valid phase, ``b<batch>`` is
# the global batch, and optional ``dp<dp>``/``pod<chips>`` suffixes set
# the DP degree and pod size. ``resolve_workload`` accepts these
# anywhere a plain ``WORKLOADS`` name is accepted, which is what lets
# sweep campaigns grid LM workloads over phase x seq/kv_len x batch x
# TP x EP x DP x layers x pod shape.

_LM_NAME_RE = re.compile(
    r"^lm/(?P<arch>[A-Za-z0-9_.\-]+)/"
    r"(?:L(?P<layers>\d+)/)?"
    r"(?:train/s(?P<trseq>\d+)|decode/kv(?P<kv>\d+)|s(?P<seq>\d+))"
    r"b(?P<batch>\d+)tp(?P<tp>\d+)(?:ep(?P<ep>\d+))?"
    r"(?:dp(?P<dp>\d+))?(?:pod(?P<pod>\d+))?$")


def lm_workload_name(arch: str, *, seq: int = 0, batch: int, tp: int,
                     phase: str = "prefill", kv_len: int = 0,
                     ep: int = 1, layers: int = 0, dp: int = 1,
                     pod: int = 0) -> str:
    """Single-layer name (``layers=0``, historical spelling) or
    full-model name (``layers>=1`` adds the ``L<layers>/`` segment and
    unlocks ``train``/``dp``/``pod``)."""
    if phase == "train":
        head = f"train/s{seq}"
    elif phase == "decode":
        head = f"decode/kv{kv_len}"
    else:
        head = f"s{seq}"
    model = f"L{layers}/" if layers else ""
    return (f"lm/{arch}/{model}{head}b{batch}tp{tp}"
            + (f"ep{ep}" if ep > 1 else "")
            + (f"dp{dp}" if dp > 1 else "")
            + (f"pod{pod}" if pod else ""))


def lm_grid_names(arch: str, seq: List[int], batch: List[int],
                  tp: List[int], *, phase: List[str] = ("prefill",),
                  kv_len: List[int] = (0,),
                  ep: List[int] = (1,), layers: List[int] = (0,),
                  dp: List[int] = (1,),
                  pod: List[int] = (0,)) -> List[str]:
    """Expand a phase x (seq | kv_len) x batch x TP x EP x DP x layers
    x pod grid into workload names. Grid order: phase-major, then seq
    (prefill/train) or kv_len (decode), then batch, tp, ep, dp, layers,
    pod — so the default arguments reproduce the historical seq-major
    prefill ordering."""
    out: List[str] = []
    for ph in phase:
        lens = kv_len if ph == "decode" else seq
        out += [lm_workload_name(arch, seq=0 if ph == "decode" else s,
                                 batch=b, tp=t, phase=ph,
                                 kv_len=s if ph == "decode" else 0, ep=e,
                                 layers=lyr, dp=d, pod=pc)
                for s in lens for b in batch for t in tp for e in ep
                for d in dp for lyr in layers for pc in pod]
    return out


def parse_lm_name(name: str) -> Optional[Dict[str, object]]:
    """Parse an ``lm/...`` name into its parameters (validated), or
    None when the name is not LM-shaped. Raises KeyError on an LM name
    with bad parameters (unknown arch, dp on a single layer, ...)."""
    m = _LM_NAME_RE.match(name)
    if not m:
        return None
    from ..configs import get_config   # deferred: avoids import cycle
    cfg = get_config(m["arch"])        # raises KeyError on bad arch
    phase = ("train" if m["trseq"] else
             "decode" if m["kv"] else "prefill")
    seq = int(m["trseq"] or m["seq"] or 0)
    kv = int(m["kv"]) if m["kv"] else 0
    batch, tp = int(m["batch"]), int(m["tp"])
    ep = int(m["ep"]) if m["ep"] else 1
    layers = int(m["layers"]) if m["layers"] else 0
    dp = int(m["dp"]) if m["dp"] else 1
    pod = int(m["pod"]) if m["pod"] else 0
    if m["layers"] is not None and layers < 1:
        raise KeyError(f"full model needs L >= 1 in {name!r}")
    if batch < 1 or tp < 1 or ep < 1 or dp < 1 or \
            (kv < 1 if phase == "decode" else seq < 1):
        raise KeyError(f"bad LM workload parameters in {name!r}")
    if ep > 1 and not cfg.is_moe:
        raise KeyError(f"ep>1 in {name!r} needs a MoE arch; "
                       f"{cfg.name} is {cfg.family}")
    if not layers and (dp > 1 or pod or phase == "train"):
        raise KeyError(f"train/dp/pod in {name!r} need the full-model "
                       f"L<layers>/ segment")
    if layers and batch % dp:
        raise KeyError(f"global batch {batch} must divide over dp={dp} "
                       f"in {name!r}")
    return {"cfg": cfg, "arch": m["arch"], "phase": phase, "seq": seq,
            "kv_len": kv, "batch": batch, "tp": tp, "ep": ep,
            "layers": layers, "dp": dp, "pod": pod}


def resolve_workload(name: str) -> Callable[[], List[Op]]:
    """Map a workload name — builtin CNN or parameterized ``lm/...`` —
    to its op-list factory; raises KeyError for unknown names."""
    if name in WORKLOADS:
        return WORKLOADS[name]
    if name.startswith("hlo/"):
        # captured compiler graphs (imported lazily: ingest pulls in the
        # HLO parser + fixture IO most callers never need)
        from . import ingest
        return ingest.resolve_hlo(name)
    if name.startswith("torch/"):
        # the port's own programs, captured (graph/torch_ingest.py)
        from . import torch_ingest
        return torch_ingest.resolve_torch(name)
    p = parse_lm_name(name)
    if p is None:
        raise KeyError(
            f"unknown workload {name!r}; have {sorted(WORKLOADS)} or "
            f"'lm/<arch>/s<seq>b<batch>tp<tp>[ep<ep>]' or "
            f"'lm/<arch>/decode/kv<kv>b<batch>tp<tp>[ep<ep>]' or "
            f"'lm/<arch>/L<layers>/[train/|decode/]...[dp<dp>]"
            f"[pod<chips>]' or 'hlo/<fixture>[@L<k>]' (captured HLO "
            f"graphs, see graph/ingest.py)")
    cfg = p["cfg"]

    if p["layers"]:
        def build() -> List[Op]:
            return lm_model_ops(cfg, layers=p["layers"], batch=p["batch"],
                                seq=p["seq"], phase=p["phase"],
                                kv_len=p["kv_len"], dp_shards=p["dp"],
                                tp_shards=p["tp"], ep_shards=p["ep"],
                                pod_chips=p["pod"])
    else:
        def build() -> List[Op]:
            return lm_layer_ops(cfg, seq=p["seq"], batch=p["batch"],
                                tp_shards=p["tp"], phase=p["phase"],
                                kv_len=p["kv_len"], ep_shards=p["ep"])

    return build


def model_parts(name: str) -> Optional[ModelParts]:
    """The layer-replication decomposition of a full-model workload
    name, or None for CNN / single-layer names. The sweep pre-screen
    uses this to compile + analytically schedule one layer body and one
    head instead of ``layers`` copies (``core.vectorized``'s closed-form
    ``repeats`` path); ``resolve_workload`` still builds the full list
    for event-engine refinement."""
    if name in WORKLOADS:
        return None
    p = parse_lm_name(name)
    if p is None or not p["layers"]:
        return None
    cfg = p["cfg"]
    local, T, pod = _model_args(
        cfg, layers=p["layers"], batch=p["batch"], seq=p["seq"],
        phase=p["phase"], kv_len=p["kv_len"], dp_shards=p["dp"],
        tp_shards=p["tp"], ep_shards=p["ep"], pod_chips=p["pod"])

    def body() -> List[Op]:
        return _lm_body_ops(cfg, seq=p["seq"], local_batch=local,
                            phase=p["phase"], kv_len=p["kv_len"],
                            tp_shards=p["tp"], ep_shards=p["ep"], pod=pod,
                            dtype_bytes=2)

    def head() -> List[Op]:
        layer_w = sum(o.w_bytes for o in body()
                      if not o.name.startswith(("dgrad.", "wgrad.")))
        return _lm_head_ops(cfg, T=T, phase=p["phase"], layers=p["layers"],
                            tp_shards=p["tp"], pod=pod, dtype_bytes=2,
                            layer_w_bytes=layer_w)

    # part keys are layers-independent EXCEPT the head in train+DP,
    # whose grad_allreduce payload scales with the layer count
    base = (f"{p['arch']}/{p['phase']}/s{p['seq']}kv{p['kv_len']}"
            f"b{p['batch']}tp{p['tp']}ep{p['ep']}dp{p['dp']}pod{p['pod']}")
    head_key = base + "/head"
    if p["phase"] == "train" and p["dp"] > 1:
        head_key += f"L{p['layers']}"
    return ModelParts(layers=p["layers"], body=body, head=head,
                      body_key=base + "/body", head_key=head_key)


def is_workload(name: str) -> bool:
    try:
        resolve_workload(name)
        return True
    except KeyError:
        return False


def workload_flops(ops: List[Op]) -> float:
    return sum(o.flops for o in ops)


def workload_bytes(ops: List[Op]) -> float:
    return sum(o.in_bytes + o.out_bytes + o.w_bytes for o in ops)
