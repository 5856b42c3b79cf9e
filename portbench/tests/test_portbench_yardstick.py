"""The yardstick against hand counts at small shapes: mask pairs, kernel
bounds (the SFU's rate among the peaks), model FLOPs, percentiles, the
busy union, and the benchmark's weights in the program's parameter
layout."""
import itertools
import math

import numpy as np
import pytest

from portbench.flops import hubert as fl_hubert
from portbench.flops import hymba as fl_hymba
from portbench.harness.common import percentile, sub_seed
from portbench.harness.masks import visible_pairs
from portbench.harness.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S, SFU_EXP2_PER_S
from portbench.harness.profile import union_seconds
from portbench.rooflines import flash_bwd, flash_fwd, selective_scan, ssm_scan
from portbench.tests.reduced import reduced_spec


def _brute(Sq, Sk, causal, window, n_sink):
    return sum(1 for r, c in itertools.product(range(Sq), range(Sk))
               if not causal or (c <= r and (not window or c > r - window or c < n_sink)))


@pytest.mark.parametrize("Sq,Sk,causal,window,n_sink", [
    (7, 7, True, 0, 0), (9, 9, True, 3, 2), (12, 12, True, 4, 0), (5, 8, False, 0, 0),
    (20, 20, True, 16, 8), (6, 4, True, 0, 0)])
def test_visible_pairs_against_brute_force(Sq, Sk, causal, window, n_sink):
    assert visible_pairs(Sq, Sk, causal, window, n_sink) == _brute(Sq, Sk, causal, window,
                                                                   n_sink)


def test_ssm_scan_bound_by_hand():
    # [2, 3, 4] f32: 3 tensors of 24 elements, 4 bytes each
    assert ssm_scan.bound_s(2, 3, 4, 4) == max(288 / HBM_BYTES_PER_S, 48 / F32_FLOPS)


def test_selective_scan_bound_by_hand():
    # B 2, S 3, di 4, n 2, bf16 z and y: xc, dt 2·24 f32; B, C 2·12 f32; A 8, D 4,
    # the last state 16 f32; z, y 2·24 bf16: 496 bytes; 48 exponentials
    assert SFU_EXP2_PER_S == pytest.approx(4.18e12, 1e-3)
    assert selective_scan.bound_s(2, 3, 4, 2, 2) == max(496 / HBM_BYTES_PER_S,
                                                        48 / SFU_EXP2_PER_S)
    # hymba's longest serve round a layer: 0.97 GB (0.290 ms) and 1.29 G
    # exponentials (0.308 ms)
    assert selective_scan.bound_s(8, 3146, 3200, 16, 2) == pytest.approx(0.3081e-3, 1e-3)


def test_flash_bounds_by_hand():
    # B 1, S 4, H 2, KV 1, hd 8, causal: 10 pairs a head
    fwd = flash_fwd.bound_s(1, 4, 4, 2, 1, 8, True, 2)
    assert fwd == max(4 * 8 * 20 / BF16_FLOPS, (2 * 4 * 2 * 8 + 2 * 4 * 8) * 2 / HBM_BYTES_PER_S)
    bwd = flash_bwd.bound_s(1, 4, 2, 1, 8, False, 4)
    assert bwd == max(10 * 8 * 32 / F32_FLOPS, (4 * 4 * 2 * 8 + 4 * 4 * 8) * 4 / HBM_BYTES_PER_S)
    # HuBERT's backward call: 1.152e11 FLOPs, 116.5 us on the tensor cores
    assert flash_bwd.bound_s(4, 1500, 16, 16, 80, False, 2) == pytest.approx(116.48e-6, 1e-3)


def test_hubert_flops_by_hand():
    c = reduced_spec("hubert-encode-30s")["cfg"]      # d 64, 4 heads of 16, ff 128, 2 layers
    per_layer = 64 * 64 * 4 + 3 * 64 * 128
    assert fl_hubert.forward(c, 2, 10) == 2 * 2 * per_layer * 20 + 4 * 16 * 4 * 2 * 100 * 2
    assert fl_hubert.train_step(c, 2, 10) == 3 * (fl_hubert.forward(c, 2, 10)
                                                  + 2 * 64 * 128 * 20)


def test_hymba_flops_by_hand():
    c = reduced_spec("hymba-longdoc-serve")["cfg"]
    d, di, n, r = 64, 128, 8, 4
    per_tok = (d * (4 + 4) * 16 + 4 * 16 * d + d * 2 * di + 4 * di + di * (r + 2 * n)
               + r * di + 2 * di * n + di * d + 3 * d * 128)
    S = 30
    pairs = visible_pairs(S, S) + 3 * visible_pairs(S, S, True, 16, 8)
    assert fl_hymba.prefill(c, S) == 2 * 4 * per_tok * S + 4 * 16 * 4 * pairs + 2 * d * 256


def test_percentile_and_union():
    assert percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert percentile([], 95) is None
    assert union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_sub_seed_takes_large_seeds():
    a, b = sub_seed(2**33 + 5, "w"), sub_seed(2**33 + 6, "w")
    assert a != b and 0 <= a < 2**62 and sub_seed(2**33 + 5, "w") == a


@pytest.mark.parametrize("cell", ["hymba-longdoc-serve", "hubert-train-15s"])
@pytest.mark.parametrize("full", [False, True])
def test_benchmark_weights_have_the_programs_layout(cell, full):
    from repro_torch.models.layers import map_templates
    from repro_torch.models.model import build_model

    from portbench.harness.common import load_module, tree_leaves
    from portbench.harness.port import port_config
    from portbench.harness.runner import resolve

    spec = resolve(cell) if full else reduced_spec(cell)
    c = spec["cfg"]
    ref = load_module("reference", c["reference"])
    want = map_templates(lambda t: t.shape, build_model(port_config(c)).template())

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(ref.layout(c)) == want
    assert all(math.prod(lf.shape) > 0 for lf in tree_leaves(ref.layout(c)))


@pytest.mark.parametrize("dist", [{"median": 1536, "sigma": 0.5, "min": 1024, "max": 3072},
                                  {"median": 128, "sigma": 0.6, "min": 64, "max": 256}])
def test_every_seed_serves_the_same_prompt_lengths_in_each_block(dist):
    from portbench.loops.serve import longest_per_stratum, schedule

    t = {"clients": 8, "prompt_len": dist}
    lo, hi = dist["min"], dist["max"] - 1
    a, b = schedule(t, 3, 24), schedule(t, 2**31 + 12345, 24)
    assert a.shape == (24, 8) and a.min() >= lo and a.max() <= hi
    assert (a != b).any()
    for blk in range(3):
        rows = slice(8 * blk, 8 * blk + 8)
        assert (np.sort(a[rows], axis=0) == np.sort(b[rows], axis=0)).all()
    # strata do not overlap, so the last client pads every batch
    assert (a.argmax(1) == 7).all()
    assert (longest_per_stratum(t) == a.max(0)).all()
