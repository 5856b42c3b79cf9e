"""Closed-loop encoding through ``Model.forward`` in inference.

Traffic parameters: ``clients`` closed-loop clients, one clip of ``frames``
frame embeddings each (a standard normal from the seed, new clips every
batch), served together as one batch of ``batch``; ``warmup_batches``
before the window; with ``--trace 1`` the window's first
``profile_batches`` batches run under the profiler. A request's latency
(host clock) runs from its submission to its hidden states being ready on
the device (synchronised).

Correctness: ``check_batches`` batches drawn from the seed among the first
``sample_from`` of the window keep their outputs; once the window has
closed the reference encodes the same clips, and the number compared is
the largest relative error of one frame's hidden state,
||h - h_ref|| / ||h_ref||, over every frame of every kept clip.

Planted faults (``fault``): ``answer`` alters one frame's hidden state
where it is produced; ``fp8``, the control, judges the reference's hidden
states under float8 products in place of the program's.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from portbench.harness.common import load_module, make_params, mark, sub_seed
from portbench.harness.port import port_config, sync_fn
from portbench.harness.profile import Stretch

__all__ = ["run", "frame_error"]


def frame_error(h, want) -> float:
    """max over frames of ||h - want|| / ||want|| along the hidden dim."""
    want = want.float()
    return float(((h.float() - want).norm(dim=-1) / want.norm(dim=-1)).max())


def run(rec, limits, fault=None):
    import torch
    from repro_torch.models.model import build_model

    c, t, seed = rec.cfg, rec.traffic, rec.seed
    dev = torch.device(rec.device)
    mark(rec, "import program")
    dtype = getattr(torch, c["dtype"])
    sync = sync_fn(dev)
    ref = load_module("reference", c["reference"])
    B, T = t["batch"], t["frames"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        mark(rec, "device context")

    def clips(stream, k):
        g = torch.Generator(device=dev)
        g.manual_seed(sub_seed(seed, stream, k))
        return torch.randn((B, T, c["d_model"]), generator=g, dtype=dtype, device=dev)

    model = build_model(port_config(c), remat=False)
    params = make_params(ref.layout(c), seed, dtype, dev)
    mark(rec, "weights")

    def encode(x):
        with torch.inference_mode():
            h = model.forward(params, {"frames": x})
        if fault == "answer":               # one frame's answer altered where it is produced
            h = h.clone()
            h[0, 0] += 1.0
        return h

    for k in range(t["warmup_batches"]):
        encode(clips("warmup", k))
    sync()

    rng = np.random.default_rng(sub_seed(seed, "check"))
    keep = set(rng.choice(t["sample_from"], size=t["check_batches"], replace=False).tolist())
    kept, units = {}, []

    def do_batch(profiled):
        k = len(units)
        x = clips("window", k)
        t0 = time.perf_counter()
        h = encode(x)
        sync()
        t1 = time.perf_counter()
        if k in keep:
            kept[k] = h
        units.append({"t0": t0, "t1": t1, "B": B, "T": T, "profiled": profiled})

    mark(rec, "warm-up")
    st = Stretch(rec.trace, sync).start()
    t_w0 = time.perf_counter()
    rec.setup_s = t_w0 - rec.t_start
    with st:
        if rec.trace:
            for _ in range(t["profile_batches"]):
                do_batch(True)
            st.units = len(units)
    rec.unprofiled_t0 = time.perf_counter()
    need = max(keep) + 1                    # every kept batch is due in the window
    while time.perf_counter() - t_w0 < rec.seconds or len(units) < need:
        do_batch(False)
    rec.window_s = units[-1]["t1"] - t_w0
    mark(rec, "window")
    rec.units = units
    rec.requests = [{"t_submit": u["t0"], "t_done": u["t1"]} for u in units for _ in range(B)]
    rec.attempted, rec.failed = len(rec.requests), 0
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec.trace = st.read()

    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    err = []
    for k, h in sorted(kept.items()):
        x = clips("window", k)
        with torch.no_grad():
            want = ref.forward(params, c, x)
            if fault == "fp8":              # the control: float8 products' answers
                h = ref.forward(params, c, x, prec="fp8")
            err.append(frame_error(h, want))
        del want
    rec.checked = len(kept) * B
    return {"hidden_rel_err": (max(err), limits["hidden_rel_err"])}
