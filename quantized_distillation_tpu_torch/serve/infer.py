"""Packed-weight inference for the seq2seq family: the serving main path.

PyTorch port of the JAX package's ``serve/infer.py``. :func:`pack_decoder`
turns trained parameters into the deployment form (packed INT2/4/8 weights,
dequantization fused into every decoder matmul), :func:`encode_packed` runs
the dense encoder and precomputes the attention keys, and
:func:`beam_search_packed` drives the beam core with the packed decode step.
Per decode step the path launches the dequant-matmul kernel once per LSTM
layer (the four gates of input and recurrent weights fused into one
[E_in + H, 4H] matrix) and once for the attention output, the fused
generator kernel once, and the beam-advance kernel once. On the card the
whole search (encode, every step, finalization) runs as one captured CUDA
graph, cached per decoder and shape (see ``beam.run_search``).

Dtype placement mirrors the JAX package: ``enc_out``, the keys, ``h`` and
the input feed are stored in the compute dtype; the cell state ``c`` and
the gate math stay f32; attention folds the beams of a sentence into one
batch entry and accumulates in f32; ``attn_h`` reaches the generator in f32.

The TPU generator kernel's tuning knobs ``topk_slots``, ``topk_lse_shift``,
``topk_fold`` and ``topk_pair`` are accepted by :func:`pack_decoder` and
ignored: the port's top-k is exact, so they have nothing to tune.
``generator_group`` is kept because it fixes the generator's padded width,
and so the packed bytes. The decode steps return the attention alignment
too when asked (``with_align``), which the coverage penalty and
per-hypothesis attention read.

A learned-codebook deploy (``pack_decoder(points=...)``) packs every matrix
with the codebook: ``lut_mode="exact"`` keeps each weight's point index
and the LUT, so each decode step launches the LUT variants of the two
kernels (3 dequant-matmuls and 1 fused generator); ``lut_mode="requant8"``
(the default, as in the JAX package) snaps the codebook values onto the
uniform 8-bit grid and runs the uniform kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import resolve_device
from ..config import BeamConfig
from ..convert import fuse_lstm_params
from ..kernels.dequant_matmul import dequant_matmul
from ..kernels.packed import PackedLinear, pack_linear
from ..kernels.topk_fused import KMAX, dequant_matmul_topk
from ..models.seq2seq import DecoderState, Seq2SeqConfig
from ..utils.graphs import signature
from ..utils.tracing import spanned
from .beam import _check_cfg, beam_decode, expand_to_beams, run_search
from .sharded import pack_generator_sharded


@dataclasses.dataclass
class FusedDecState:
    """Serving decoder state in two row-major buffers, so the per-step beam
    reorder is two wide-row gathers: ``c = [c_0 | c_1 | ...]`` (f32) and
    ``hf = [h_0 | h_1 | ... | input_feed]`` (compute dtype)."""

    c: torch.Tensor  # [M, L*H] float32
    hf: torch.Tensor  # [M, (L+1)*H] compute dtype


def fuse_dec_state(state: DecoderState, compute_dtype) -> FusedDecState:
    """Nested-tuple ``DecoderState`` → :class:`FusedDecState`."""
    states, input_feed = state
    c = torch.cat([c for c, _ in states], dim=-1).to(torch.float32)
    hf = torch.cat([h.to(compute_dtype) for _, h in states] + [input_feed.to(compute_dtype)], dim=-1)
    return FusedDecState(c=c, hf=hf)


def unfuse_dec_state(state: FusedDecState, num_layers: int, hidden: int) -> DecoderState:
    """:class:`FusedDecState` → nested-tuple ``DecoderState``."""
    states = tuple(
        (state.c[:, i * hidden:(i + 1) * hidden], state.hf[:, i * hidden:(i + 1) * hidden])
        for i in range(num_layers)
    )
    return states, state.hf[:, num_layers * hidden:]


@dataclasses.dataclass
class PackedLSTMCell:
    """Fused [x; h] → gates matrix [E_in + H, 4H], gate order i, f, g, o."""

    w: PackedLinear
    bias: torch.Tensor  # [4H] f32


@dataclasses.dataclass
class PackedDecoder:
    """All decoder-side weights in deployment form, on one device (on a
    mesh: this rank's, the generator being its vocab shard)."""

    tgt_embed: torch.Tensor  # [V_tgt, E] compute dtype (a gather, stays dense)
    cells: Tuple[PackedLSTMCell, ...]
    attn_in: Optional[torch.Tensor]  # [H, H] compute dtype (None = dot attention)
    attn_out: PackedLinear  # [2H, H]
    generator: PackedLinear  # [H, V] + bias (uniform: V padded, -1e9 bias on the padding)
    hidden: int
    compute_dtype: torch.dtype = torch.bfloat16
    # (shard, shards): ``generator`` is that vocab shard of a generator split
    # over the mesh's model axis (``sharded.shard_decoder``); None: whole
    vocab_shard: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.tgt_embed.device


def _fuse_cell(cell_params) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax OptimizedLSTMCell params → ([E_in+H, 4H] matrix, [4H] bias)."""
    wi, wh, bh = fuse_lstm_params(cell_params)
    return torch.cat([wi, wh], dim=0), bh


def pack_decoder(
    params,
    cfg: Seq2SeqConfig,
    bits: int,
    *,
    scaling: str = "linear",
    points=None,
    lut_mode: str = "requant8",
    compute_dtype=torch.bfloat16,
    generator_group: int = 32,
    topk_slots: int = 2,
    topk_lse_shift: bool = True,
    topk_fold: bool = True,
    topk_pair: bool = False,
    generator_store_bits: Optional[int] = None,
    device="cuda",
) -> PackedDecoder:
    """Flax-layout Seq2Seq parameters (see :mod:`..convert`) → packed
    decoder on ``device``. Packing runs on the CPU, so the bytes do not
    depend on the device; ``topk_*`` are accepted and ignored (see the
    module docstring). ``points`` ([2^bits] in the scaled domain, a tensor
    or an array) packs every matrix with that codebook, as ``lut_mode``
    says; the generator then goes through ``pack_linear`` with its N-long
    bias, and the fused kernel masks the padded columns itself."""
    dev = resolve_device(device)
    if points is not None:
        points = torch.as_tensor(points, dtype=torch.float32).cpu()
    quant = dict(scaling=scaling, points=points, lut_mode=lut_mode)
    dec = params["decoder"]
    cells = []
    for i in range(cfg.num_layers):
        w, b = _fuse_cell(dec[f"lstm_{i}"])
        cells.append(PackedLSTMCell(w=pack_linear(w, bits, **quant).to(dev), bias=b.to(dev)))
    attn = dec["attn"]
    attn_in = None
    if cfg.attn_type == "general":
        attn_in = torch.as_tensor(attn["linear_in"]["kernel"]).to(dev, compute_dtype)
    attn_out = pack_linear(torch.as_tensor(attn["linear_out"]["kernel"]), bits, **quant)
    gen_kernel = torch.as_tensor(params["generator"]["kernel"])
    gen_bias = torch.as_tensor(params["generator"]["bias"])
    if points is None:
        generator = pack_generator_sharded(
            gen_kernel, gen_bias, bits, mp=1, scaling=scaling, max_group=generator_group,
            store_bits=generator_store_bits,
        )
    else:
        generator = pack_linear(gen_kernel, bits, bias=gen_bias, max_group=generator_group,
                                **quant)
    return PackedDecoder(
        tgt_embed=torch.as_tensor(params["tgt_embed"]["embedding"]).to(dev, compute_dtype),
        cells=tuple(cells),
        attn_in=attn_in,
        attn_out=attn_out.to(dev),
        generator=generator.to(dev),
        hidden=cfg.hidden,
        compute_dtype=compute_dtype,
    )


def encode_packed(model, dec: PackedDecoder, src, src_len, *, fused: bool = True):
    """Dense encoder pass + attention-key precompute →
    ``(enc_keys [B,T,H], enc_out [B,T,H], enc_mask [B,T], init state)``;
    the state is a :class:`FusedDecState` (``fused=True``) or the
    nested-tuple ``DecoderState`` with h and input feed in compute dtype."""
    cd = dec.compute_dtype
    with torch.no_grad():
        enc_out, enc_mask, state = model.encode(src, src_len)
        enc_out = enc_out.to(cd)
        keys = enc_out @ dec.attn_in if dec.attn_in is not None else enc_out
    if fused:
        return keys, enc_out, enc_mask, fuse_dec_state(state, cd)
    states, input_feed = state
    states = tuple((c, h.to(cd)) for c, h in states)
    return keys, enc_out, enc_mask, (states, input_feed.to(cd))


def _decode_body(dec: PackedDecoder, state, token, enc_keys, enc_out, enc_mask):
    """Everything up to the generator → (state, attn_h f32, align).

    ``state`` is a :class:`FusedDecState` or a nested-tuple
    ``DecoderState``; the output state has the same form. The encoder
    tensors' leading dim is the sentence count (or the row count): the beams
    of a sentence share its encoder outputs, so attention folds them into
    one batch entry."""
    fused = isinstance(state, FusedDecState)
    hd, nl, cd = dec.hidden, len(dec.cells), dec.compute_dtype
    if fused:
        input_feed = state.hf[:, nl * hd:]
    else:
        states, input_feed = state
    x = torch.cat([dec.tgt_embed[token], input_feed.to(cd)], dim=-1)
    new_states = []
    for i, cell in enumerate(dec.cells):
        if fused:
            c, h = state.c[:, i * hd:(i + 1) * hd], state.hf[:, i * hd:(i + 1) * hd]
        else:
            c, h = states[i]
        z = dequant_matmul(torch.cat([x, h.to(cd)], dim=-1), cell.w, compute_dtype=cd) + cell.bias
        zi, zf, zg, zo = z.chunk(4, dim=-1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h = (torch.sigmoid(zo) * torch.tanh(c)).to(cd)
        new_states.append((c, h))
        x = h
    rows, hdim = x.shape
    nsent = enc_keys.shape[0]
    q = x.reshape(nsent, rows // nsent, hdim)
    # products of compute-dtype values, summed in f32 (exact products in f32)
    scores = torch.bmm(q.float(), enc_keys.float().transpose(1, 2))
    scores = torch.where(enc_mask[:, None, :], scores, torch.full_like(scores, -1e9))
    align = torch.softmax(scores, dim=-1)
    context = torch.bmm(align.to(cd).float(), enc_out.float()).reshape(rows, -1)
    attn_h = torch.tanh(
        dequant_matmul(torch.cat([context, x.float()], dim=-1), dec.attn_out, compute_dtype=cd)
    )
    feed = attn_h.to(cd)
    if fused:
        new_state = FusedDecState(
            c=torch.cat([c for c, _ in new_states], dim=-1),
            hf=torch.cat([h for _, h in new_states] + [feed], dim=-1),
        )
    else:
        new_state = (tuple(new_states), feed)
    return new_state, attn_h, align.reshape(rows, -1)


def packed_decode_step(dec: PackedDecoder, state, token, enc_keys, enc_out, enc_mask, *,
                       with_align: bool = False):
    """One decode step on packed weights → (state, logits [B, V_tgt]), plus
    ``align [B, T_src]`` with ``with_align``."""
    new_state, attn_h, align = _decode_body(dec, state, token, enc_keys, enc_out, enc_mask)
    logits = dequant_matmul(attn_h, dec.generator, compute_dtype=dec.compute_dtype)
    out = (new_state, logits[:, : dec.tgt_embed.shape[0]])
    return out + (align,) if with_align else out


def packed_decode_step_topk(
    dec: PackedDecoder, state, token, enc_keys, enc_out, enc_mask, k: int, *,
    with_align: bool = False,
):
    """Decode step returning per-row top-k candidates ``(vals, idx, lse)``
    from the fused generator kernel (the logits never reach memory), plus
    ``align [B, T_src]`` with ``with_align``."""
    new_state, attn_h, align = _decode_body(dec, state, token, enc_keys, enc_out, enc_mask)
    cand = dequant_matmul_topk(attn_h, dec.generator, k, compute_dtype=dec.compute_dtype)
    return (new_state, cand, align) if with_align else (new_state, cand)


def check_whole_vocab(dec: PackedDecoder) -> None:
    """Raise for a decoder whose generator is one vocab shard of several:
    it serves only through the sharded paths (``serve.sharded``)."""
    if dec.vocab_shard is not None and dec.vocab_shard[1] > 1:
        raise ValueError(f"the decoder holds vocab shard {dec.vocab_shard}: serve it with "
                         "beam_search_sharded or TranslationEngine(mesh=...)")


@spanned("serve.search")
def beam_search_packed(
    model,
    dec: PackedDecoder,
    src: torch.Tensor,
    src_len: torch.Tensor,
    cfg: BeamConfig,
    *,
    fused_topk: Optional[bool] = None,
    return_attention: bool = False,
    device="cuda",
    _eager: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Beam search on the packed decoder (the serving entry point) →
    ``(tokens [B, max_len], scores [B])`` or the n-best lists;
    ``return_attention`` appends each hypothesis' per-step attention (see
    ``beam.beam_decode``), and ``cfg.coverage_penalty`` scores with the
    coverage the decode steps' alignments accrue.

    ``fused_topk`` (default: on when ``beam_size <= 8``) feeds the beam core
    from the fused generator kernel's per-beam candidates and advances the
    beams with the beam-advance kernel; off, it takes full logits from the
    dequant-matmul kernel. On the card the search runs as one CUDA graph,
    captured at the first call for this model, decoder, batch, source
    length and config (``_eager=True``: the eager step loop, for
    comparisons)."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    if model.device != dev or dec.device != dev:
        raise ValueError(f"model on {model.device} and decoder on {dec.device}, not {dev}")
    check_whole_vocab(dec)
    k = cfg.beam_size
    if fused_topk is None:
        fused_topk = k <= KMAX
    with_align = cfg.coverage_penalty != 0.0 or return_attention

    def search(src, src_len):
        with torch.no_grad():
            # encoder tensors stay per sentence; _decode_body folds the beams
            keys, enc_out, enc_mask, state = encode_packed(model, dec, src, src_len)
            step = packed_decode_step_topk if fused_topk else packed_decode_step
            extra = (k,) if fused_topk else ()

            def decode_step(s, tokens):
                return step(dec, s, tokens, keys, enc_out, enc_mask, *extra,
                            with_align=with_align)

            return beam_decode(
                decode_step, expand_to_beams(state, k), src.shape[0], cfg,
                candidates=fused_topk, coverage_len=enc_out.shape[1],
                return_attention=return_attention,
            )

    key = ("beam_search_packed", signature(model), signature(dec), cfg, fused_topk,
           return_attention)
    return run_search(search, (src, src_len), dev, _eager, key)
