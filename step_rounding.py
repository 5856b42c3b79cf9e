"""How far does a change of rounding alone move one f32 train step of
xlstm-125m?

  python3 step_rounding.py

Needs one CUDA card. For each sequence length S of SEQS: one f32 train
step of xlstm-125m at full width and depth, B 4, from one state drawn from
a seed, with the kernels; with the plain versions; with chip_smoke.py's
wrong backward for it (dx x 1.1 in rmsnorm); and SEEDS rounding controls,
the plain versions whose rmsnorm output and input gradient each have every
element moved one ulp up, down or not at all, picked by a hash of its bits
and the seed. Each step is read against
the plain one as chip_smoke.py's train checks read it: the largest over
leaves of max |m - m_plain| / max |m_plain| (m: the first AdamW moment,
0.1 x the clipped gradient), and the grad norm's relative difference. The
controls' largest readings at a length are what rounding alone moves there;
chip_smoke.py states its xLSTM limits from them. One line per S, then one
JSON object with every reading.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

SEQS = (8, 16, 32, 64, 256, 1024)
SEEDS = 8
BATCH = 4


def ulp_moved(torch, t, salt: int):
    """Each element of the f32 tensor t moved one ulp down, not at all or
    up, by a hash of its bits and ``salt``: the same value always moves the
    same way, so remat's recompute sees the forward it saw."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFF
    pick = (((bits ^ salt) * 2654435761) >> 11) % 3
    up = torch.nextafter(t, torch.full_like(t, math.inf))
    down = torch.nextafter(t, torch.full_like(t, -math.inf))
    return torch.where(pick == 2, up, torch.where(pick == 0, down, t))


def rmsnorm_ulp(torch, seed: int):
    """rmsnorm_ref with its output and its input gradient moved by ulps."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    salt = (seed * 0x9E3779 + 0x5BD1E9) & 0xFFFFFF

    class Out(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            return ulp_moved(torch, y, salt)

        @staticmethod
        def backward(ctx, g):
            return g

    class In(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return ulp_moved(torch, g, salt ^ 0xA5A5A5)

    return lambda x, w, eps: Out.apply(rmsnorm_ref(In.apply(x), w, eps))


def readings(torch, S: int) -> dict:
    _, step_fn, fresh, batch = cs.step_setup(torch, cs.XLSTM, {}, BATCH, S)
    plain, mp, _, drawn = cs.one_step(torch, step_fn, fresh, batch, cs.plain_versions(torch))

    def read(fns=None):
        state, m, _, d = cs.one_step(torch, step_fn, fresh, batch, fns)
        if d != drawn:
            raise AssertionError("two draws of the state from one seed differ")
        shares = cs.moment_shares(plain, state)
        leaf = max(shares, key=shares.get)
        del state
        return dict(grad=shares[leaf], leaf=leaf,
                    norm=abs(float(m["grad_norm"]) - float(mp["grad_norm"]))
                    / abs(float(mp["grad_norm"])))

    t0 = time.perf_counter()
    out = dict(S=S, kernels=read())
    step_s = time.perf_counter() - t0
    out["wrong"] = read(cs.plain_versions(torch, dx=1.1))
    _, flash, scan = cs.plain_versions(torch)
    out["controls"] = [read((rmsnorm_ulp(torch, s), flash, scan)) for s in range(SEEDS)]
    out["step_s"] = step_s
    del plain
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_rounding: no CUDA device", file=sys.stderr)
        return 1
    rows = []
    for S in SEQS:
        r = readings(torch, S)
        c = [x["grad"] for x in r["controls"]]
        cn = [x["norm"] for x in r["controls"]]
        cs.log(f"[rounding] {cs.XLSTM} B={BATCH} S={S}: kernels {r['kernels']['grad']:.3e} "
               f"({r['kernels']['leaf']}; grad_norm rel {r['kernels']['norm']:.2e}); "
               f"{len(c)} ulp controls {min(c):.3e}-{max(c):.3e} (median "
               f"{sorted(c)[len(c) // 2]:.3e}; grad_norm rel up to {max(cn):.2e}); "
               f"wrong backward {r['wrong']['grad']:.3e} ({r['wrong']['leaf']}); "
               f"kernel step {r['step_s']:.2f} s")
        rows.append(r)
    print(json.dumps(dict(arch=cs.XLSTM, batch=BATCH, card=cs.phase_card(), rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
