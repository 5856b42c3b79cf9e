"""Cells at a size the CPU holds, for the tests: the configuration's widths
cut to the program's own ``reduced()`` scale, float32 unless asked, and
short traffic."""
from portbench.harness.runner import resolve

_CFG = {
    "hymba": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=256, sliding_window=16, global_attn_layers=[0], n_meta_tokens=8,
                  ssm_state=8),
    "hubert": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                   vocab_size=32, frontend_stub_dim=64),
}
_TRAFFIC = {
    "serve": dict(prompt_len={"median": 26, "sigma": 0.5, "min": 20, "max": 41}, smax=64,
                  check_rounds=2, profile_rounds=1),
    "train": dict(batch=2, frames=24, profile_steps=1),
    "encode": dict(batch=2, clients=2, frames=24, sample_from=4, check_batches=2,
                   profile_batches=1, warmup_batches=1),
}


def reduced_spec(cell: str, dtype: str = "float32", bench=None):
    spec = resolve(cell, bench)
    spec["cfg"] = {**spec["cfg"], **_CFG[spec["cfg"]["reference"]], "dtype": dtype}
    spec["traffic"] = {**spec["traffic"], **_TRAFFIC[spec["traffic"]["loop"]]}
    return spec
