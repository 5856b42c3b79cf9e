"""The launch plan of the list-schedule kernel and a CPU emulation of its
shared-memory variant.

``list_schedule_tiled`` runs the kernel's algorithm step by step: the
duration pre-pass into the ``done`` slots, then the chain per block of T
vectors with its loads one task ahead and the previous end forwarded. It
must equal the plain version and the JAX package bit for bit (no
tolerance: the frozen campaign records keep 6 digits of these f32 results),
on random graphs whose dependency slots reach forward, at themselves and
past N (where the emulated slot holds a duration, not the reference's
0.0), on every golden slice's parts and at N 6,122. ``list_schedule_plan``
is the twin of the C plan (held equal on the card by
``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
import torch

from _torch_common import hw_param_matrix, random_task_arrays
from repro.core import vectorized as jv
from repro_torch.core.vectorized import task_tensors
from repro_torch.kernels.list_schedule.ref import (MAX_VECTORS, SMEM_LIMIT, VARIANTS,
                                                   list_schedule_plan, list_schedule_ref,
                                                   list_schedule_tiled)
from test_torch_vectorized import GROUPS, _bits_equal, _graphs, _jax_arrays

CPU = torch.device("cpu")


def _tiled_vs_ref_and_jax(ta, pm, repeats, vectors, what, ja=None):
    feats, ints = task_tensors(ta, CPU)
    params = torch.from_numpy(np.asarray(pm, np.float64).astype(np.float32))
    got = list_schedule_tiled(feats, ints, params, ta.n_units, repeats, vectors=vectors)
    want = list_schedule_ref(feats, ints, params, ta.n_units, repeats)
    jmk, jbusy = jv.schedule_many_stats(ja or _jax_arrays(ta), pm, repeats=repeats)
    for g, w, j, name in zip(got, want, (jmk, jbusy), ("makespan", "busy")):
        _bits_equal(g.numpy(), w.numpy(), f"{what} {name} vs plain")
        _bits_equal(g.numpy(), np.asarray(j), f"{what} {name} vs JAX")


@pytest.mark.parametrize("n,n_units,classes,cross,dep_hi,vectors", [
    (1, 1, (0, 1, 2, 3), 0.3, None, None),  # one task
    (7, 2, (0, 1, 2, 3), 0.3, None, 4),     # K 12 over blocks of 4
    (300, 5, (0, 1, 2, 3), 0.3, None, 8),
    (50, 3, (3,), 0.5, None, 1),            # collectives, half cross-pod; T 1
    (64, 3, (0, 1, 2, 3), 0.3, 64, None),   # slots at i or later: still durations
    (64, 3, (0, 1, 2, 3), 0.3, 70, 8),      # ... and past N
    (120, 1, (0, 1), 0.0, 120, 2),          # one engine: every free slot forwarded
])
def test_tiled_random_graphs_bitwise(n, n_units, classes, cross, dep_hi, vectors):
    ta = random_task_arrays(n, n, n_units, classes=classes, cross=cross, dep_hi=dep_hi)
    for r in (1, 4):
        _tiled_vs_ref_and_jax(ta, hw_param_matrix(), r, vectors, f"N {n} T {vectors}")


@pytest.mark.parametrize("group", GROUPS)
def test_tiled_golden_parts_bitwise(group):
    """Every part of every golden cell, and N 6,122 (the plan's T 2, K 2)."""
    for label, ja, ta, pm in _graphs(group):
        _tiled_vs_ref_and_jax(ta, pm, 1, None, label, ja=ja)


def test_forward_slots_hold_durations_in_the_emulation():
    """The exactness trap of the design is live on these graphs: in the
    emulated ``done``, a slot at i or later holds a non-zero duration when
    task i runs, so dropping the guard would change the result."""
    ta = random_task_arrays(64, 64, 3, dep_hi=70)
    deps = np.asarray(ta.deps)
    i = np.arange(len(deps))[:, None]
    forward = (deps >= i) & (deps < len(deps))
    assert forward.sum() > 20


# around the shared variant's limit at T 1: N 9,676 / 9,682 / 9,683 at 40 /
# 6 / 1 units
N_GRID = [1, 2, 42, 1000, 3623, 3624, 6122, 7263, 9676, 9677, 9682, 9683, 9684, 14530,
          58106, 200000]


def _bytes(n, n_units, t):
    return 20 * (n + 2) + 4 * t * (n + 1 + n_units)


@pytest.mark.parametrize("n_units", [1, 6, 40])
def test_plan_fits_the_card_and_takes_the_largest_block(n_units):
    """Shared where it fits at T 1, else global; shared at the largest
    power-of-two T <= min(64, what K needs) that fits: the 16-bit slot
    indices of the packed tasks then cover every row."""
    for n in N_GRID:
        for k in (1, 2, 63, 192, 1000):
            p = list_schedule_plan(n, k, n_units)
            assert p.grid * p.vectors >= k > (p.grid - 1) * p.vectors
            if _bytes(n, n_units, 1) > SMEM_LIMIT:
                assert (p.variant, p.vectors, p.smem, p.threads) == ("global", 64, 0, 64)
                continue
            assert p.variant == "shared"
            assert p.threads == 512 and p.vectors & (p.vectors - 1) == 0
            cap = min(MAX_VECTORS, 1 << (k - 1).bit_length())
            assert p.vectors <= cap
            assert p.smem == _bytes(n, n_units, p.vectors) <= SMEM_LIMIT
            assert p.vectors == cap or _bytes(n, n_units, 2 * p.vectors) > SMEM_LIMIT
            assert (n + 1) * p.vectors <= 1 << 16 and n_units * p.vectors <= 1 << 16


def test_plan_of_the_main_shapes():
    p = list_schedule_plan(42, 192, 6)
    assert (p.variant, p.vectors, p.grid, p.smem) == ("shared", 64, 3,
                                                      4 * 64 * 49 + 20 * 44)
    p = list_schedule_plan(6122, 2, 6)
    assert (p.variant, p.vectors, p.grid, p.smem) == ("shared", 2, 1,
                                                      4 * 2 * 6129 + 20 * 6124)
    p = list_schedule_plan(6122, 192, 6)
    assert (p.variant, p.vectors, p.grid) == ("shared", 4, 48)
    assert list_schedule_plan(9682, 2, 6).variant == "shared"
    assert list_schedule_plan(9683, 2, 6).variant == "global"


def test_forced_variants():
    for v in VARIANTS:
        assert list_schedule_plan(42, 192, 6, v).variant == v
    # forced where nothing fits: T 1 above the limit, a launch the card refuses
    p = list_schedule_plan(20000, 2, 6, "shared")
    assert p.vectors == 1 and p.smem == _bytes(20000, 6, 1) > SMEM_LIMIT
    with pytest.raises(ValueError):
        list_schedule_plan(42, 2, 6, "tiled")
