"""DeepSeek-V2 decoder (arXiv:2405.04434; the published
``modeling_deepseek.py``, class ``DeepseekV2ForCausalLM``) as a language
model of the port: multi-head latent attention (MLA) with a decoupled
rotary key under YaRN scaling, a leading dense SwiGLU layer and then
mixture-of-experts layers with shared experts, usable as teacher or
student of the LM task (``train.lm_task``, no carry).

Each MoE layer is one card's share of an expert-parallel deployment: it is
told which experts it holds (``first_expert``, ``n_held``), routes every
token over all ``n_routed_experts`` (softmax in f32, greedy top-k), and
computes the part of the layer's output that its own experts give, for
every (token, expert) pair routed to them, with none dropped, plus the
shared experts: ``shared(x) + Σ_{held selected e} w_e · expert_e(x)``. The
pairs are sorted by expert (pairs of experts held elsewhere last, a discard
group), and the held experts' products are the grouped kernel
``kernels.grouped_matmul`` over their contiguous rows, with the group
offsets found on the device, so the layer is captured in the train step's
graph. On one card the layer runs without the exchange of a deployment;
what the absent experts would add is left out.

Device counters (``utils.tracing.device_count``), per forward, summed over
the MoE layers, under ``<counters>.``: ``held_pairs`` (one entry a held
expert: the rows the grouped kernel's first call wrote for it, counted by
the kernel's row tiles) and ``dropped`` (the pairs the router sent to held
experts less the rows written: 0 unless a tile missed a row).

Departures from ``modeling_deepseek.py``:
- weights are ``[in, out]`` (the port multiplies ``x @ w``), a held
  expert's three matrices stacked over the held experts
  (``mlp.experts.w_gate`` [n_held, hidden, width]);
- attention is causal ``scaled_dot_product_attention`` in f32 (on the card
  its memory-efficient backend, which takes f32 and v's head size beside
  q's and k's) in place of the explicit softmax of the eager class; the
  softmax scale and the rotary embedding are the published ones;
- the router's auxiliary balance loss (``aux_loss_alpha``) is not computed,
  and there is no dropout;
- the held experts' part only, as above, and the vocabulary is whatever
  the configuration gives (a slice of the published one).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .._device import resolve_device
from ..kernels.grouped_matmul import grouped_matmul
from ..utils.tracing import device_count
from ._layers import FlaxModel
from .lm import Embed

DEEPSEEK_V2_LITE_ROPE = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                         "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                         "type": "yarn"}


@dataclass(frozen=True)
class DeepseekV2Config:
    """The published ``config.json`` keys the model reads (DeepSeek-V2-Lite's
    values by default)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict] = field(default_factory=lambda: dict(DEEPSEEK_V2_LITE_ROPE))
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False

    @classmethod
    def from_dict(cls, d: Mapping) -> "DeepseekV2Config":
        """The keys of a ``config.json`` that this class names."""
        return cls(**{f.name: d[f.name] for f in fields(cls) if f.name in d})

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


# --------------------------------------------------------------------- YaRN


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """``0.1 · mscale · ln(scale) + 1`` (1 for ``scale <= 1``)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim: int, base: float, rope_scaling: Optional[Mapping]) -> torch.Tensor:
    """The rotary inverse frequencies [dim / 2] (f32, CPU): YaRN's blend of
    the interpolated (÷ factor) and the original frequencies over the
    correction range that ``beta_fast`` / ``beta_slow`` set, or the plain
    ones without scaling."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** exps)
    if not rope_scaling:
        return extra
    s = rope_scaling
    factor, orig = s["factor"], s["original_max_position_embeddings"]
    inter = 1.0 / (factor * base ** exps)

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr_dim(s["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(s["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_mscale(rope_scaling: Optional[Mapping]) -> float:
    """The factor on the rotary cos and sin: mscale(factor, mscale) /
    mscale(factor, mscale_all_dim)."""
    if not rope_scaling:
        return 1.0
    s = rope_scaling
    return yarn_mscale(s["factor"], s["mscale"]) / yarn_mscale(s["factor"], s["mscale_all_dim"])


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """(qk_nope + qk_rope)^-½, times mscale(factor, mscale_all_dim)² under
    YaRN."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    s = cfg.rope_scaling
    if s and s.get("mscale_all_dim"):
        scale *= yarn_mscale(s["factor"], s["mscale_all_dim"]) ** 2
    return scale


def rope_tables(cfg: DeepseekV2Config, length: int, inv: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [length, qk_rope_head_dim] at positions 0..length-1, from
    the inverse frequencies ``inv`` (:func:`yarn_inv_freq`) on their
    device."""
    freqs = torch.outer(torch.arange(length, dtype=torch.float32, device=inv.device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = rope_mscale(cfg.rope_scaling)
    return emb.cos() * m, emb.sin() * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rotary embedding of ``x`` [..., S, d]: its interleaved
    pairs de-interleaved (evens, then odds), then rotate-half."""
    *lead, s, d = x.shape
    x = x.reshape(*lead, s, d // 2, 2).transpose(-1, -2).reshape(*lead, s, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


# ------------------------------------------------------------------- layers


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


def _attend(q, k, v, scale: float):
    """Causal attention over the last two dims, f32. On the card the
    memory-efficient backend (the flash backend takes no f32, and the math
    backend would hold every score)."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)
    return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)


class MLA(nn.Module):
    """Multi-head latent attention, training form, without a query LoRA:
    q = x·wq (per head: nope, rope); x·wkv_a = (latent c, shared k_pe); c
    normed; c·wkv_b = per head (k_nope, v)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        h, r = cfg.num_attention_heads, cfg.kv_lora_rank
        self.cfg = cfg
        self.wq = nn.Parameter(torch.empty(cfg.hidden_size,
                                           h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)))
        self.wkv_a = nn.Parameter(torch.empty(cfg.hidden_size, r + cfg.qk_rope_head_dim))
        self.kv_norm = RMSNorm(r, cfg.rms_norm_eps)
        self.wkv_b = nn.Parameter(torch.empty(r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)))
        self.wo = nn.Parameter(torch.empty(h * cfg.v_head_dim, cfg.hidden_size))
        self.scale = softmax_scale(cfg)

    def forward(self, x, cos, sin):
        c = self.cfg
        b, s, _ = x.shape
        h, dn, dr, dv = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        q = (x @ self.wq).view(b, s, h, dn + dr).transpose(1, 2)
        q_nope, q_pe = q.split([dn, dr], dim=-1)
        latent, k_pe = (x @ self.wkv_a).split([c.kv_lora_rank, dr], dim=-1)
        kv = (self.kv_norm(latent) @ self.wkv_b).view(b, s, h, dn + dv).transpose(1, 2)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe.reshape(b, 1, s, dr), cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, h, s, dr)], dim=-1)
        o = _attend(q, k, v.contiguous(), self.scale)
        return o.transpose(1, 2).reshape(b, s, h * dv) @ self.wo


class SwiGLU(nn.Module):
    """``(silu(x·w_gate) * x·w_up)·w_down``."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.w_gate = nn.Parameter(torch.empty(hidden, width))
        self.w_up = nn.Parameter(torch.empty(hidden, width))
        self.w_down = nn.Parameter(torch.empty(width, hidden))

    def forward(self, x):
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


class HeldExperts(nn.Module):
    """The SwiGLU experts a card holds, stacked: ``w_gate``, ``w_up``
    [n_held, hidden, width], ``w_down`` [n_held, width, hidden]."""

    def __init__(self, n_held: int, hidden: int, width: int):
        super().__init__()
        self.w_gate = nn.Parameter(torch.empty(n_held, hidden, width))
        self.w_up = nn.Parameter(torch.empty(n_held, hidden, width))
        self.w_down = nn.Parameter(torch.empty(n_held, width, hidden))


class MoE(nn.Module):
    """A MoE layer's share on a card (see the module docstring): the router
    over every expert, the held experts ``[first_expert, first_expert +
    n_held)`` and the shared experts."""

    def __init__(self, cfg: DeepseekV2Config, first_expert: int, n_held: int,
                 counters: str = "moe"):
        super().__init__()
        if not 0 <= first_expert <= first_expert + n_held <= cfg.n_routed_experts:
            raise ValueError(f"held experts [{first_expert}, {first_expert + n_held}) are not "
                             f"among the {cfg.n_routed_experts}")
        self.cfg, self.first_expert, self.n_held, self.counters = (
            cfg, first_expert, n_held, counters)
        self.router = nn.Parameter(torch.empty(cfg.hidden_size, cfg.n_routed_experts))
        self.experts = HeldExperts(n_held, cfg.hidden_size, cfg.moe_intermediate_size)
        self.shared = SwiGLU(cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)

    def route(self, x: torch.Tensor):
        """x [T, hidden] → (top-k weights, top-k experts) [T, k]: softmax
        over every expert in f32, greedy top-k, × the routed scale."""
        c = self.cfg
        scores = torch.softmax(x.float() @ self.router.float(), dim=-1)
        w, idx = torch.topk(scores, c.num_experts_per_tok, dim=-1, sorted=False)
        if c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return w * c.routed_scaling_factor, idx

    def forward(self, x):
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        w, idx = self.route(x)
        k, n = idx.shape[1], self.n_held
        local = idx - self.first_expert
        held = (local >= 0) & (local < n)
        key = torch.where(held, local, n).reshape(-1)  # the discard group is n
        order = torch.argsort(key, stable=True)
        offsets = torch.searchsorted(key[order], torch.arange(n + 1, device=x.device))
        token = torch.div(order, k, rounding_mode="floor")
        e = self.experts
        covered = offsets.new_zeros(n)
        gate = grouped_matmul(x, token, e.w_gate, offsets, covered)
        up = grouped_matmul(x, token, e.w_up, offsets)
        y = grouped_matmul(F.silu(gate) * up, None, e.w_down, offsets)
        routed = x.new_zeros(x.shape).index_add(0, token, y * w.reshape(-1)[order, None])
        with torch.no_grad():
            device_count(f"{self.counters}.held_pairs", covered)
            device_count(f"{self.counters}.dropped", held.sum() - covered.sum())
        return (self.shared(x) + routed).reshape(shape)


class Block(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, layer: int, first_expert: int, n_held: int,
                 counters: str):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = MLA(cfg)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = (MoE(cfg, first_expert, n_held, counters) if cfg.is_moe(layer)
                    else SwiGLU(cfg.hidden_size, cfg.intermediate_size))

    def forward(self, x, cos, sin):
        x = x + self.attn(self.attn_norm(x), cos, sin)
        return x + self.mlp(self.mlp_norm(x))


class DeepseekV2(FlaxModel):
    """Embed → decoder layers → RMSNorm → logits over the vocabulary; the
    LM protocol of ``train.lm_task``: ``forward(tokens, None)`` →
    ``(logits, None)``."""

    def __init__(self, cfg: DeepseekV2Config, *, first_expert: int = 0,
                 n_held: Optional[int] = None, counters: str = "moe", device="cuda",
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.first_expert = first_expert
        self.n_held = cfg.n_routed_experts - first_expert if n_held is None else n_held
        dev = resolve_device(device)
        with torch.device(dev):  # the weights are made where they live
            self.embed = Embed(cfg.vocab_size, cfg.hidden_size)
            self.layers = nn.ModuleList(
                Block(cfg, i, first_expert, self.n_held, counters)
                for i in range(cfg.num_hidden_layers))
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.head = nn.Parameter(torch.empty(cfg.hidden_size, cfg.vocab_size))
        # made here: its copy to the card syncs, which a captured step cannot
        self._inv_freq = yarn_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta,
                                       cfg.rope_scaling).to(dev)
        self._rope: Dict = {}
        self._place(dev, seed)

    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed``, drawn on the model's device:
        matrices N(0, 1/fan_in) (an expert stack's fan-in is its middle
        dim), the embedding N(0, 1/hidden), RMSNorm scales 1."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.dim() == 1:
                    p.fill_(1.0)
                    continue
                fan_in = p.shape[-1] if name == "embed.embedding" else p.shape[-2]
                p.copy_(torch.randn(p.shape, generator=g, device=p.device) / fan_in ** 0.5)

    def rope(self, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (cos, sin) tables for ``length`` positions, kept after the
        first call (made before any capture, by a step's first call)."""
        if length not in self._rope:
            self._rope[length] = rope_tables(self.cfg, length, self._inv_freq)
        return self._rope[length]

    def forward(self, tokens: torch.Tensor, carry=None, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """tokens [B, S] → (logits [B, S, V], None): each row a sequence
        from position 0, causal. There is no carry and no dropout."""
        cos, sin = self.rope(tokens.shape[1])
        x = self.embed.embedding[tokens]
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x) @ self.head, None

    def forward_with(self, params: Mapping[str, torch.Tensor], tokens, carry=None, *,
                     train: bool = False, generator: Optional[torch.Generator] = None):
        """:meth:`forward` on the weights ``params`` (``named_parameters()``
        names → tensors) in place of the module's own."""
        return functional_call(self, dict(params), (tokens, carry),
                               {"train": train, "generator": generator})

    def logits_split(self, mp) -> bool:
        """The model has no tensor-parallel forward: its logits are whole."""
        return False


def make_deepseek_v2(cfg=None, *, first_expert: int = 0, n_held: Optional[int] = None,
                     counters: str = "moe", device="cuda", seed: int = 0) -> DeepseekV2:
    """A :class:`DeepseekV2` of ``cfg`` (a :class:`DeepseekV2Config`, a
    ``config.json`` dict, or None for DeepSeek-V2-Lite) holding experts
    ``[first_expert, first_expert + n_held)`` of each MoE layer (all from
    ``first_expert`` when None)."""
    if cfg is None:
        cfg = DeepseekV2Config()
    elif not isinstance(cfg, DeepseekV2Config):
        cfg = DeepseekV2Config.from_dict(cfg)
    return DeepseekV2(cfg, first_expert=first_expert, n_held=n_held, counters=counters,
                      device=device, seed=seed)
