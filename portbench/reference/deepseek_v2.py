"""DeepSeek-V2 (arXiv:2405.04434, the published ``modeling_deepseek.py``),
one card's share of an expert-parallel deployment, written out in plain
PyTorch, float32 with TF32 off, every product through
``numerics.mm`` (so the controls round its operands); it imports nothing of
the port.

The model as the configuration file gives it (the published
``config.json`` keys): embedding, ``num_hidden_layers`` decoder layers
(pre-RMSNorm; multi-head latent attention without a query LoRA; a dense
SwiGLU for the first ``first_k_dense_replace`` layers, then a MoE layer),
a final RMSNorm and the output head. Attention: q = x·wq split per head
into a part without position (``qk_nope_head_dim``) and a rotary part
(``qk_rope_head_dim``); x·wkv_a gives the latent (``kv_lora_rank``,
RMS-normed) and one rotary key shared by the heads; latent·wkv_b gives
each head's key part without position and its value. The rotary parts are
de-interleaved (even entries, then odd) and turned by rotate-half with
YaRN's frequencies: the original ``θ^(-2i/d)`` and the interpolated ones
(÷ ``factor``) blended by a linear ramp over the dims between the
correction dims of ``beta_fast`` and ``beta_slow`` rotations at the
original length; cos and sin × mscale(factor, mscale) / mscale(factor,
mscale_all_dim), mscale(s, m) = 0.1·m·ln s + 1. Scores × (nope + rope)^-½
· mscale(factor, mscale_all_dim)², causal softmax, explicit (one sequence
at a time, recomputed in the backward so the scores are not kept).

The MoE layer's share: softmax over all ``n_routed_experts`` of x·router,
the ``num_experts_per_tok`` largest scores (× ``routed_scaling_factor``),
and for each held expert ``e`` in ``[first, first + n_held)``, one loop
step of plain products over the tokens that chose it: ``w · (silu(x·g_e) *
x·u_e)·d_e``; plus the shared experts (one SwiGLU of ``n_shared_experts``
× the expert width). What experts held elsewhere would add is left out,
as the program leaves it out.

:func:`follow` runs the KD steps of ``reference.train`` on this model: the
student 4-bit (``reference.quant``'s buckets, every matrix but the router),
the teacher as it is.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .numerics import mm
from .quant import EXCLUDED, fake_quant_flat
from .train import B1, B2, EPS, _bias_correction, kd_loss

Params = Mapping[str, torch.Tensor]


def shapes(cfg: dict, n_held: int) -> Dict[str, tuple]:
    """Every weight's shape, by the names the program's parameters have:
    matrices ``[in, out]``, a held expert's matrices stacked over the
    held experts."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    heads, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    width = cfg["moe_intermediate_size"]
    out = {"embed.embedding": (v, h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({p + "attn_norm.weight": (h,), p + "attn.wq": (h, heads * (dn + dr)),
                    p + "attn.wkv_a": (h, r + dr), p + "attn.kv_norm.weight": (r,),
                    p + "attn.wkv_b": (r, heads * (dn + dv)), p + "attn.wo": (heads * dv, h),
                    p + "mlp_norm.weight": (h,)})
        if is_moe(cfg, i):
            shared = width * cfg["n_shared_experts"]
            out.update({p + "mlp.router": (h, cfg["n_routed_experts"]),
                        p + "mlp.experts.w_gate": (n_held, h, width),
                        p + "mlp.experts.w_up": (n_held, h, width),
                        p + "mlp.experts.w_down": (n_held, width, h),
                        p + "mlp.shared.w_gate": (h, shared), p + "mlp.shared.w_up": (h, shared),
                        p + "mlp.shared.w_down": (shared, h)})
        else:
            w = cfg["intermediate_size"]
            out.update({p + "mlp.w_gate": (h, w), p + "mlp.w_up": (h, w), p + "mlp.w_down": (w, h)})
    out.update({"norm.weight": (h,), "head": (h, v)})
    return out


def is_moe(cfg: dict, layer: int) -> bool:
    return (cfg["n_routed_experts"] > 0 and layer >= cfg["first_k_dense_replace"]
            and layer % cfg.get("moe_layer_freq", 1) == 0)


def mscale(s: float, m: float) -> float:
    return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0


def inv_freq(cfg: dict) -> torch.Tensor:
    """YaRN's rotary inverse frequencies [rope dim / 2], f32 on the CPU."""
    d, base, y = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), cfg["rope_scaling"]
    original = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    interpolated = 1.0 / (y["factor"] * base ** (torch.arange(0, d, 2, dtype=torch.float32) / d))

    def correction_dim(rotations):
        return d * math.log(y["original_max_position_embeddings"]
                            / (rotations * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(correction_dim(y["beta_fast"])), 0)
    hi = min(math.ceil(correction_dim(y["beta_slow"])), d - 1)
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32) - lo)
                       / (hi - lo if hi > lo else 0.001), 0, 1)
    keep = 1.0 - ramp  # 1 where the original frequency is kept
    return interpolated * (1 - keep) + original * keep


def attn_scale(cfg: dict) -> float:
    y = cfg["rope_scaling"]
    m = mscale(y["factor"], y["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """De-interleave the last dim (evens, then odds), then rotate-half."""
    d = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1) * sin


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _core(q, k, v, scale: float, fmt: str):
    """One sequence's causal attention: q, k [heads, S, d], v [heads, S, dv]."""
    s = q.shape[1]
    scores = mm(q, k.transpose(1, 2), fmt) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return mm(probs, v, fmt)


def attention(p: Params, pre: str, x, cfg: dict, cos, sin, fmt: str):
    b, s, _ = x.shape
    heads, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = mm(x, p[pre + "wq"], fmt).view(b, s, heads, dn + dr).transpose(1, 2)
    kv_a = mm(x, p[pre + "wkv_a"], fmt)
    latent = rms_norm(kv_a[..., :r], p[pre + "kv_norm.weight"], cfg["rms_norm_eps"])
    kv = mm(latent, p[pre + "wkv_b"], fmt).view(b, s, heads, dn + dv).transpose(1, 2)
    k_rot = rope(kv_a[..., r:][:, None], cos, sin)  # one rotary key, every head
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :dn], k_rot.expand(b, heads, s, dr)], dim=-1)
    v = kv[..., dn:]
    scale = attn_scale(cfg)
    out = []
    for i in range(b):
        args = (q[i], k[i], v[i])
        if torch.is_grad_enabled():
            out.append(checkpoint(_core, *args, scale, fmt, use_reentrant=False))
        else:
            out.append(_core(*args, scale, fmt))
    o = torch.stack(out).transpose(1, 2).reshape(b, s, heads * dv)
    return mm(o, p[pre + "wo"], fmt)


def swiglu(x, gate, up, down, fmt: str):
    return mm(F.silu(mm(x, gate, fmt)) * mm(x, up, fmt), down, fmt)


def moe(p: Params, pre: str, x, cfg: dict, first: int, n_held: int, fmt: str):
    """The MoE layer's share of the card holding experts ``[first, first +
    n_held)``: their part for the tokens routed to them, and the shared
    experts."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    scores = torch.softmax(mm(x, p[pre + "router"], fmt), dim=-1)
    top_w, top_e = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    if cfg.get("norm_topk_prob"):
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    top_w = top_w * cfg["routed_scaling_factor"]
    out = swiglu(x, p[pre + "shared.w_gate"], p[pre + "shared.w_up"],
                 p[pre + "shared.w_down"], fmt)
    for j in range(n_held):
        tok, slot = (top_e == first + j).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], p[pre + "experts.w_gate"][j], p[pre + "experts.w_up"][j],
                       p[pre + "experts.w_down"][j], fmt)
            out = out.index_add(0, tok, y * top_w[tok, slot][:, None])
    return out.reshape(shape)


def rope_tables(cfg: dict, length: int, device):
    y = cfg["rope_scaling"]
    freqs = torch.outer(torch.arange(length, dtype=torch.float32, device=device),
                        inv_freq(cfg).to(device))
    emb = torch.cat([freqs, freqs], dim=-1)
    m = mscale(y["factor"], y["mscale"]) / mscale(y["factor"], y["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def forward(p: Params, tokens: torch.Tensor, cfg: dict, first: int, n_held: int,
            fmt: str = "f32") -> torch.Tensor:
    """tokens [B, S] (each row from position 0) → logits [B, S, V]."""
    eps = cfg["rms_norm_eps"]
    cos, sin = rope_tables(cfg, tokens.shape[1], tokens.device)
    x = p["embed.embedding"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        x = x + attention(p, pre + "attn.", rms_norm(x, p[pre + "attn_norm.weight"], eps), cfg,
                          cos, sin, fmt)
        h = rms_norm(x, p[pre + "mlp_norm.weight"], eps)
        if is_moe(cfg, i):
            x = x + moe(p, pre + "mlp.", h, cfg, first, n_held, fmt)
        else:
            x = x + swiglu(h, p[pre + "mlp.w_gate"], p[pre + "mlp.w_up"], p[pre + "mlp.w_down"],
                           fmt)
    return mm(rms_norm(x, p["norm.weight"], eps), p["head"], fmt)


def quantizable(name: str, t: torch.Tensor, exclude: Sequence[str]) -> bool:
    """Matrices and the embedding, but not the router (``exclude``)."""
    return t.dim() >= 2 and not any(s in name for s in tuple(EXCLUDED) + tuple(exclude))


def follow(cfg: dict, first: int, n_held: int, student: Params, teacher: Params,
           batches: Sequence[Dict[str, torch.Tensor]], fmt: str = "f32",
           fault: Optional[str] = None) -> dict:
    """``reference.train.follow`` on this model, the configuration's
    ``train`` and ``quant`` (``exclude``: names kept at full precision):
    train a copy of ``student`` on ``batches`` (``input``, ``target``),
    one step each → ``{"loss": [...], "grad": {name: norm}, "change":
    {name: norm}}``. ``fault="half"`` takes each loss over the first half
    of the batch's rows."""
    t, q = cfg["train"], cfg["quant"]
    bits, bucket, exclude = q["bits"], q["bucket_size"], q.get("exclude", ())
    params = {n: x.detach().clone().requires_grad_(True) for n, x in student.items()}
    start = {n: x.detach().clone() for n, x in student.items()}
    mu = {n: torch.zeros_like(x) for n, x in start.items()}
    nu = {n: torch.zeros_like(x) for n, x in start.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        qp = {n: (x + (fake_quant_flat(x.detach(), bits, bucket) - x.detach())
                  if quantizable(n, x, exclude) else x) for n, x in params.items()}
        s = forward(qp, batch["input"], cfg, first, n_held, fmt)
        with torch.no_grad():
            tl = forward(teacher, batch["input"], cfg, first, n_held, fmt)
        labels = batch["target"]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        rows = slice(0, labels.shape[0] // 2) if fault == "half" else None
        loss = kd_loss(s, tl, labels, mask, t["distill_weight"], t["temperature"], rows)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        del s, tl, qp
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if norm >= t["clip_norm"]:
                grads = {n: (g / norm) * t["clip_norm"] for n, g in grads.items()}
            if step == 0:
                grad_norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
            c1, c2 = _bias_correction(B1, step + 1), _bias_correction(B2, step + 1)
            for n, g in grads.items():
                mu[n] = (1 - B1) * g + B1 * mu[n]
                nu[n] = (1 - B2) * (g * g) + B2 * nu[n]
                step_n = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + EPS)
                params[n].add_(-t["learning_rate"] * step_n)
            del grads
        losses.append(float(loss.detach()))
    change = {n: float(torch.linalg.vector_norm(params[n].detach() - start[n])) for n in params}
    return {"loss": losses, "grad": grad_norms, "change": change}
