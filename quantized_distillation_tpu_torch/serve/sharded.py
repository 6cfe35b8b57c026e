"""Tensor-parallel packed serving: slot data parallelism x vocab tensor
parallelism (PyTorch port of the JAX package's ``serve/sharded.py``).

One process per rank (see :mod:`..parallel`). The decomposition is the
JAX package's:

- rows (sentences x beams) split over ``data``: rank ``(d, m)`` decodes
  sentences ``[d B/dp, (d+1) B/dp)``, which need no collective a step;
- the generator's vocab splits over ``model``: each rank runs the fused
  generator kernel (``csrc/topk_fused.cu``, uniform or LUT) over its
  ``V_pad / mp`` columns and emits its local top-k and logsumexp; the merge
  is exact: a row's global top-k is a subset of the union of the shards'
  top-k, and the lse is the logsumexp of the shards' lses;
- every other weight is replicated: each rank holds the whole decoder but
  its generator shard.

So the only collective of a decode step is one all-gather each of the
candidates' values, indices and lses over ``model`` (a few KB). The
offline search ends with one all-gather of its results over ``data``, so
every rank returns the whole batch, as JAX's global arrays do.

Vocab padding: :func:`pack_generator_sharded` pads the generator to an
``mp x group x 256``-aligned width whose padded columns carry a -1e9 bias,
so each shard's kernel runs over its whole padded width and a padded
column never wins a top-k slot nor moves the logsumexp (exp(-1e9 - max)
underflows to 0 in f32).

On an NCCL group the search and the engine's step run as CUDA graphs with
their collectives inside; on a gloo group (several ranks sharing a card, or
the CPU) they run eagerly and the candidates go through the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .._device import resolve_device
from ..config import BeamConfig
from ..kernels.packed import BUCKET, PackedLinear, pack_linear
from ..kernels.topk_fused import KMAX, dequant_matmul_topk, topk_sorted
from ..parallel.comm import all_gather, capturable, warm_up
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size
from ..utils.graphs import signature

NEG_BIAS = -1e9


def pack_generator_sharded(
    kernel: torch.Tensor,
    bias: torch.Tensor,
    bits: int,
    mp: int,
    *,
    scaling: str = "linear",
    max_group: int = 16,
    store_bits=None,
    points=None,
) -> PackedLinear:
    """Pack the [H, V] generator padded to a multiple of ``mp * max_group *
    256`` columns, with -1e9 bias on the padding. Padded columns repeat the
    edge column, so no bucket's range widens. ``points`` packs onto that
    codebook (the exact-LUT form) instead of the uniform grid."""
    kernel = torch.as_tensor(kernel).to(torch.float32)
    bias = torch.as_tensor(bias).to(torch.float32)
    v = kernel.shape[1]
    align = mp * max_group * BUCKET
    pad = -(-v // align) * align - v
    if pad:
        kernel = torch.cat([kernel, kernel[:, -1:].expand(-1, pad)], dim=1)
        bias = torch.cat([bias, bias.new_full((pad,), NEG_BIAS)])
    return pack_linear(
        kernel, bits, scaling=scaling, bias=bias, max_group=max_group,
        store_bits=store_bits, points=points,
    )


def generator_shard(gen: PackedLinear, shard: int, mp: int) -> PackedLinear:
    """Columns ``[shard, shard + 1) * N_pad / mp`` of a generator packed by
    :func:`pack_generator_sharded`, each tensor copied contiguous (a column
    block of ``packed`` is strided): whole 256-column buckets, so its bytes
    are the packed form of those columns."""
    npad = gen.n_padded
    if npad % (mp * BUCKET):
        raise ValueError(f"padded width {npad} does not split into {mp} bucket-aligned shards")
    local = npad // mp
    nb, cb = local // BUCKET, local * gen.bits // 8
    return dataclasses.replace(
        gen,
        packed=gen.packed[:, shard * cb:(shard + 1) * cb].contiguous(),
        scale=gen.scale[shard * nb:(shard + 1) * nb].contiguous(),
        offset=gen.offset[shard * nb:(shard + 1) * nb].contiguous(),
        bias=None if gen.bias is None else gen.bias[shard * local:(shard + 1) * local].contiguous(),
        shape=(gen.shape[0], local),
    )


def shard_decoder(dec, mesh, gen_kernel, gen_bias):
    """``dec`` with this rank's vocab shard of the generator (repacked from
    the dense ``gen_kernel``/``gen_bias`` so the width splits into whole
    bucket groups; ``vocab_shard`` = (shard, shards)) and every other
    weight as it is. A byte-stored generator (``store_bits=8``) is repacked
    at its quantization bits, stored in bytes; an exact-LUT generator keeps
    its codebook."""
    mp, shard = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    g = dec.generator
    if g.points is not None:
        gen = pack_generator_sharded(gen_kernel, gen_bias, g.bits, mp, points=g.points.cpu())
    else:
        gen = pack_generator_sharded(
            gen_kernel, gen_bias, g.effective_quant_bits, mp,
            store_bits=g.bits if g.quant_bits is not None else None,
        )
    local = generator_shard(gen, shard, mp).to(dec.device)
    return dataclasses.replace(dec, generator=local, vocab_shard=(shard, mp))


def merge_shards(vals_g: torch.Tensor, idx_g: torch.Tensor, lse_g: torch.Tensor, k: int):
    """The exact merge of the vocab shards' candidates, each ``[mp, rows,
    ...]`` in shard order (indices already global): the top-k of the union
    of the local top-k's, shard-major, and the logsumexp of the local lses
    → ``(vals [rows, k], idx [rows, k], lse [rows, 1])``, contiguous, as
    the beam-advance kernel takes them."""
    mp, rows = vals_g.shape[:2]
    vals_u = vals_g.transpose(0, 1).reshape(rows, mp * k)
    idx_u = idx_g.transpose(0, 1).reshape(rows, mp * k)
    best_v, pos = topk_sorted(vals_u, k)
    return (best_v.contiguous(), torch.gather(idx_u, 1, pos),
            torch.logsumexp(lse_g[..., 0], dim=0)[:, None])


def make_sharded_decode_step_topk(dec, mesh, k: int, *, with_align: bool = False):
    """``(state, tokens, enc_keys, enc_out, enc_mask) -> (state, (vals, idx,
    lse))`` over this rank's rows, with the generator split over
    ``model``; the candidates' indices are global vocab ids. ``with_align``
    appends the attention alignment ``align [rows, T_src]``. ``dec`` must
    come from :func:`shard_decoder` on this mesh."""
    from .infer import _decode_body

    mp, shard = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    if dec.vocab_shard != (shard, mp):
        raise ValueError(f"decoder holds vocab shard {dec.vocab_shard}, this rank needs "
                         f"{(shard, mp)}: pass it through shard_decoder on this mesh")
    if not 1 <= k <= KMAX:
        raise ValueError(f"sharded serving takes 1 <= k <= {KMAX}, got {k}")
    local_npad = dec.generator.n_padded
    offset = shard * local_npad

    def step(state, tokens, enc_keys, enc_out, enc_mask):
        new_state, attn_h, align = _decode_body(dec, state, tokens, enc_keys, enc_out, enc_mask)
        vals, idx, lse = dequant_matmul_topk(attn_h, dec.generator, k,
                                             compute_dtype=dec.compute_dtype)
        cand = merge_shards(all_gather(vals, mesh, MODEL_AXIS),
                            all_gather(idx + offset, mesh, MODEL_AXIS),
                            all_gather(lse, mesh, MODEL_AXIS), k)
        return (new_state, cand, align) if with_align else (new_state, cand)

    return step


def beam_search_sharded(
    model,
    dec,
    src: torch.Tensor,
    src_len: torch.Tensor,
    cfg: BeamConfig,
    mesh,
    *,
    return_attention: bool = False,
    device="cuda",
    _eager: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Mesh-sharded packed beam search (the offline entry point). Every rank
    passes the whole batch and gets the whole result, ``(tokens [B,
    max_len], scores [B])`` or the n-best lists (``return_attention``
    appends the attention); it decodes its ``data`` slice of the sentences.
    ``dec`` must come from :func:`shard_decoder`; B must divide the
    ``data`` axis, so each rank's rows are whole sentences. On an NCCL
    group on the card the search runs as one CUDA graph, collectives
    included (``_eager=True``: the eager loop)."""
    from .beam import _check_cfg, beam_decode, expand_to_beams, run_search
    from .infer import encode_packed

    _check_cfg(cfg)
    dev = resolve_device(device)
    if model.device != dev or dec.device != dev:
        raise ValueError(f"model on {model.device} and decoder on {dec.device}, not {dev}")
    b, k = src.shape[0], cfg.beam_size
    dp = axis_size(mesh, DATA_AXIS)
    if b % dp:
        raise ValueError(f"batch {b} must divide data axis {dp}")
    bl, d = b // dp, axis_index(mesh, DATA_AXIS)
    with_align = cfg.coverage_penalty != 0.0 or return_attention
    step = make_sharded_decode_step_topk(dec, mesh, k, with_align=with_align)

    def search(src, src_len):
        with torch.no_grad():
            # encoder tensors per sentence: the decode body folds the beams
            keys, enc_out, enc_mask, state = encode_packed(model, dec, src, src_len)

            def decode_step(s, tokens):
                return step(s, tokens, keys, enc_out, enc_mask)

            out = beam_decode(
                decode_step, expand_to_beams(state, k), src.shape[0], cfg, candidates=True,
                coverage_len=enc_out.shape[1], return_attention=return_attention,
            )
            return tuple(all_gather(t, mesh, DATA_AXIS).flatten(0, 1) for t in out)

    # keyed by the mesh's process groups, which the key keeps alive: a graph
    # holds its groups' communicators, and a new group never reuses a key
    groups = tuple(mesh.get_group(axis) for axis in mesh.mesh_dim_names)
    key = ("beam_search_sharded", groups, signature(model), signature(dec), cfg,
           return_attention)
    eager = _eager or not capturable(mesh, dev)
    if not eager:
        warm_up(mesh)
    return run_search(search, (src[d * bl:(d + 1) * bl], src_len[d * bl:(d + 1) * bl]), dev,
                      eager, key)
