"""Training steps through ``train/loop.py::make_train_step``.

Traffic parameters: ``batch`` rows of ``frames`` frames a step (frame
embeddings from a standard normal, unit targets uniform over the
vocabulary, new rows every step, both from the seed), the step's
``remat_policy``, ``clip_norm``, ``weight_decay`` and a constant learning
rate ``lr``. Set-up builds one state and one step, and drives them through
the first ``check_steps`` steps, the window's own call and feed; the window
continues the same state. With ``--trace 1`` the window's first
``profile_steps`` steps run under the profiler.

Correctness: the reference follows the first ``check_steps`` steps from the
same weights and rows. Compared, each as the gap between the program's
reading and the reference's: each leaf's norm of the first step's clipped
gradient, read from the program's first AdamW moment after one step,
against the reference's norm of that leaf or of the median leaf, whichever
is larger; each leaf's norm of the parameters' change after the checked
steps, the same way, leaving out leaves whose reference gradient is under a
thousandth of the median leaf's. A leaf is one layer's slice of a stacked
parameter. The steps' losses are read too (``loss_gap``, relative) but not
compared: neither the float8 control nor a fault of the step separates
them from sound runs.

Planted faults (``fault``): ``half_batch`` leaves half the rows out and
takes the mean over the rest; ``stale_state`` returns the state unchanged;
``fp8``, the control, judges the reference's steps under float8 products
in place of the program's.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from portbench.harness.common import load_module, make_params, mark, sub_seed
from portbench.harness.port import port_config, sync_fn
from portbench.harness.profile import Stretch

__all__ = ["run", "compare"]


def _norms(slices):
    return np.array([float(t.float().norm()) for _, t in slices])


def compare(prog, ref_r):
    """The three gaps between readings ``prog`` and ``ref_r``: dicts of
    ``losses`` (list), ``grad`` and ``change`` (per-leaf norms)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref_r["losses"]))
    g_med = float(np.median(ref_r["grad"]))
    grad_gap = float(np.max(np.abs(prog["grad"] - ref_r["grad"])
                            / np.maximum(ref_r["grad"], g_med)))
    moved = ref_r["grad"] >= 1e-3 * g_med
    c_ref, c_prog = ref_r["change"][moved], prog["change"][moved]
    c_med = float(np.median(c_ref))
    change_gap = float(np.max(np.abs(c_prog - c_ref) / np.maximum(c_ref, c_med)))
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap,
            "left_out": int((~moved).sum())}


def run(rec, limits, fault=None):
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw_init

    c, t, seed = rec.cfg, rec.traffic, rec.seed
    dev = torch.device(rec.device)
    mark(rec, "import program")
    dtype = getattr(torch, c["dtype"])
    sync = sync_fn(dev)
    ref = load_module("reference", c["reference"])
    lay = ref.layout(c)
    B, T, d = t["batch"], t["frames"], c["d_model"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        mark(rec, "device context")

    def batch(k):
        g = torch.Generator(device=dev)
        g.manual_seed(sub_seed(seed, "batch", k))
        return {"frames": torch.randn((B, T, d), generator=g, dtype=dtype, device=dev),
                "labels": torch.randint(0, c["vocab_size"], (B, T), generator=g,
                                        dtype=torch.int32, device=dev)}

    model = build_model(port_config(c), remat=True, remat_policy=t["remat_policy"])
    params = make_params(lay, seed, dtype, dev)
    state = {"params": params, "opt": adamw_init(params)}
    mark(rec, "weights")
    lr = torch.tensor(t["lr"], dtype=torch.float32, device=dev)
    step_fn = make_train_step(model, lr_schedule=lambda _: lr, clip_norm=t["clip_norm"],
                              weight_decay=t["weight_decay"])

    def step(k):
        b = batch(k)
        if fault == "half_batch":           # half the rows left out, the mean over the rest
            b = {key: v[:B // 2] for key, v in b.items()}
        if fault == "stale_state":          # a step that returns its state unchanged
            return {"loss": model.loss(state["params"], b).detach()}
        return step_fn(state, b)[1]

    prog = {"losses": []}
    for k in range(1, t["check_steps"] + 1):
        prog["losses"].append(float(step(k)["loss"]))
        if k == 1:
            prog["grad"] = _norms(ref.named_slices(state["opt"]["m"])) / (1 - ref.B1)
    p0 = make_params(lay, seed, dtype, dev)
    prog["change"] = np.array([float((a.float() - b.float()).norm()) for (_, a), (_, b) in
                               zip(ref.named_slices(state["params"]),
                                   ref.named_slices(p0))])
    del p0
    sync()

    units, losses = [], []
    k = t["check_steps"]
    mark(rec, "warm-up")
    st = Stretch(rec.trace, sync).start()
    t_w0 = time.perf_counter()
    rec.setup_s = t_w0 - rec.t_start
    with st:
        if rec.trace:
            for _ in range(t["profile_steps"]):
                k += 1
                t0 = time.perf_counter()
                losses.append(step(k)["loss"])
                units.append({"t0": t0, "t1": time.perf_counter(), "B": B, "T": T,
                              "tokens": B * T, "profiled": True})
            st.units = len(units)
    rec.unprofiled_t0 = time.perf_counter()
    while time.perf_counter() - t_w0 < rec.seconds:
        k += 1
        t0 = time.perf_counter()
        losses.append(step(k)["loss"])
        units.append({"t0": t0, "t1": time.perf_counter(), "B": B, "T": T, "tokens": B * T,
                      "profiled": False})
    sync()
    if units:
        units[-1]["t1"] = time.perf_counter()
    rec.window_s = time.perf_counter() - t_w0
    mark(rec, "window")
    rec.units, rec.requests = units, []
    rec.attempted = len(units)
    rec.failed = sum(1 for v in losses if not math.isfinite(float(v)))
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec.trace = st.read()

    del state, params, step_fn, model, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    feed = [(b["frames"], b["labels"]) for b in (batch(i) for i in range(1, t["check_steps"] + 1))]

    def reference(prec):
        p = make_params(lay, seed, dtype, dev)
        f32 = lambda v: v.to(torch.float32, copy=True)          # noqa: E731
        p32 = {"in_norm": f32(p["in_norm"]), "final_norm": f32(p["final_norm"]),
               "head": f32(p["head"]),
               "segments": [{k2: f32(v) for k2, v in p["segments"][0].items()}]}
        out = ref.train_steps(p32, c, feed, lr=t["lr"], weight_decay=t["weight_decay"],
                              clip_norm=t["clip_norm"], prec=prec)
        r = {"losses": out["losses"], "grad": _norms(ref.named_slices(out["first_grad"]))}
        del out
        r["change"] = np.array([float((a - b.float()).norm()) for (_, a), (_, b) in
                                zip(ref.named_slices(p32), ref.named_slices(p))])
        return r

    want = reference("f32")
    if fault == "fp8":                      # the control: float8 products' steps
        prog = reference("fp8")
    got = compare(prog, want)
    left_out = got.pop("left_out")
    rec.checked = (f"{t['check_steps']} steps x {len(prog['grad'])} leaves ({left_out} left "
                   f"out by the gradient rule; loss_gap {got['loss_gap']:.6g}, not compared)")
    rec.readings = {"program": prog, "reference": want, "loss_gap": got.pop("loss_gap")}
    return {name: (got[name], limits[name]) for name in got}
