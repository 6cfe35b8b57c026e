"""Operations and bytes of the DeepSeek-V2 KD step, worked out from its
shapes and the expert pairs the program counted on the device: the
yardstick of ``metrics/grouped_matmul_roofline.py`` and
``metrics/mfu.moe_train.py``. Products count 2 operations a multiply-add;
norms, softmax, the rotary turn and the routing's sort are not counted;
causal attention counts the score and value products of the positions it
attends (S (S + 1) / 2 a head and sequence); nothing recomputed is counted.

A unit's shape (``record["unit_shapes"]``) holds ``rows`` (sequences),
``tgt_len`` (positions), ``held_pairs`` (the student's (token, held expert)
pairs of a step, summed over the MoE layers) and ``held_pairs_teacher``.
"""

from __future__ import annotations

F32 = 4


def moe_layers(config: dict) -> int:
    first, freq = config["first_k_dense_replace"], config.get("moe_layer_freq", 1)
    return sum(1 for i in range(first, config["num_hidden_layers"]) if i % freq == 0)


def grouped_pass(config: dict, pairs: float):
    """(operations, bytes) of one pass (forward, data or weight gradient) of
    the held experts' three products over ``pairs`` pairs summed over the
    MoE layers: each reads its ``pairs`` rows and the held experts' weights
    once and writes its result once."""
    h, w, g = config["hidden_size"], config["moe_intermediate_size"], config["n_routed_experts"]
    ops = 3 * 2.0 * pairs * h * w
    nbytes = 3 * F32 * (pairs * (h + w) + moe_layers(config) * g * h * w)
    return ops, nbytes


def forward(config: dict, rows: int, length: int, pairs: float) -> float:
    """One forward of the model share over ``rows`` sequences of ``length``
    positions with ``pairs`` held-expert pairs."""
    c = config
    t = rows * length
    h, heads, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    proj = h * heads * (dn + dr) + h * (r + dr) + r * heads * (dn + dv) + heads * dv * h
    attended = rows * length * (length + 1) / 2
    attn = 2.0 * t * proj + 2.0 * attended * heads * (dn + dr + dv)
    n_moe = moe_layers(c)
    n_dense = c["num_hidden_layers"] - n_moe
    dense = 2.0 * t * 3 * h * c["intermediate_size"]
    shared = 2.0 * t * (3 * h * c["moe_intermediate_size"] * c["n_shared_experts"]
                        + h * c["router_experts"])
    experts = 3 * 2.0 * pairs * h * c["moe_intermediate_size"]
    return (c["num_hidden_layers"] * attn + n_dense * dense + n_moe * shared + experts
            + 2.0 * t * h * c["vocab_size"])


def kd_step(config: dict, shape: dict) -> float:
    """One KD step: the student's forward and backward (twice the forward)
    and the teacher's forward, each with its own routed pairs."""
    rows, length = shape["rows"], shape["tgt_len"]
    return (3.0 * forward(config, rows, length, shape["held_pairs"])
            + forward(config, rows, length, shape["held_pairs_teacher"]))
