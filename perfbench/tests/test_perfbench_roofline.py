import pytest

from perfbench.reference.model import Arch
from perfbench.roofline import counts as C

DENSE = Arch(d=8, n_layers=2, n_heads=4, n_kv=2, head_dim=2, ff=16,
             vocab=32, rope_theta=1e4, eps=1e-6, lora_rank=2,
             lora_alpha=4.0, lora_targets=("q", "k", "v", "o", "gate", "up",
                                           "down"))
MOE = Arch(d=8, n_layers=2, n_heads=4, n_kv=2, head_dim=2, ff=16, vocab=32,
           rope_theta=1e4, eps=1e-6, moe=True, n_experts=4, top_k=2,
           moe_ff=16, lora_rank=2, lora_alpha=4.0,
           lora_targets=("q", "k", "v", "o"))


def test_k1_bytes_by_hand():
    # q and out: 2 slots x 4 heads x 2 dims, each 2 bytes, twice;
    # K and V of 3 + 5 positions x 2 kv heads x 2 dims, 2 bytes, twice
    assert C.k1_bytes(DENSE, [3, 5]) == 2 * 2 * 4 * 2 * 2 + 2 * 8 * 2 * 2 * 2


def test_k2_calls_and_counts_by_hand():
    fwd = C.k2_calls(DENSE, "FWD", 10)
    assert fwd == [(10, 8, 8, 2), (10, 8, 4, 2), (10, 8, 4, 2),
                   (10, 8, 8, 2), (10, 8, 16, 2), (10, 8, 16, 2),
                   (10, 16, 8, 2)]
    bwd = C.k2_calls(DENSE, "BWD", 10)
    assert bwd[:7] == fwd and bwd[7] == (10, 8, 8, 2) and \
        bwd[13] == (10, 8, 16, 2)
    assert C.k2_calls(DENSE, "HEAD", 10) == []
    assert len(C.k2_calls(MOE, "BWD", 10)) == 8
    f, b = C.k2_flops_bytes(10, 8, 16, 2)
    assert f == 2 * 10 * 8 * 16 + 2 * 10 * 8 * 2 + 2 * 10 * 2 * 16
    assert b == 2 * (10 * 8 + 8 * 16 + 8 * 2 + 2 * 16 + 10 * 16)


def test_model_flops_by_hand():
    attn = 8 * 2 * (2 * 4 + 2 * 2)            # q, o: 8x8; k, v: 8x4
    assert C.layer_matrix_params(DENSE) == attn + 3 * 8 * 16
    assert C.layer_matrix_params(MOE) == attn + 8 * 4 + 2 * 3 * 8 * 16
    dense_tok = 2 * (attn + 384) + 4 * 4 * 2 * 7
    assert C.decode_token_flops(DENSE, 7) == 2 * dense_tok + 2 * 8 * 32
    pre = 2 * (2 * (attn + 384) * 3 + 2 * 4 * 2 * 3 * 4) + 2 * 8 * 32
    assert C.prefill_flops(DENSE, 3) == pre
    lora = sum(2 * 2 * (i + o) for i, o in
               [(8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (8, 16), (16, 8)])
    assert C.lora_token_flops(DENSE) == lora
    att_fwd = 2 * 2 * 4 * 2 * 5 * 6             # 2 rows of 5, causal
    assert C.unit_flops(DENSE, "FWD", 2, 5) == \
        10 * (2 * (attn + 384) + lora) + att_fwd
    assert C.unit_flops(DENSE, "BWD", 2, 5) == \
        10 * (2 * (attn + 384) + 2 * lora) + 2 * att_fwd
    assert C.unit_flops(DENSE, "HEAD", 2, 5) == 4 * 2 * 4 * 8 * 32
    for kind in ("EMBED", "EMBED_BWD", "OPT"):
        assert C.unit_flops(DENSE, kind, 2, 5) == 0


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_bwd_costs_more_than_fwd(arch):
    assert C.unit_flops(arch, "BWD", 2, 8) > C.unit_flops(arch, "FWD", 2, 8)
