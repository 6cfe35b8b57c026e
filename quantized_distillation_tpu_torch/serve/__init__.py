"""Serving: the beam core, packed-weight inference, the
continuous-batching engine and mesh-sharded (slot data parallel x vocab
tensor parallel) serving of the PyTorch port."""

from .beam import (
    NEG_INF,
    BeamState,
    beam_decode,
    beam_search,
    coverage_penalty,
    expand_to_beams,
    greedy_decode,
    init_beam_state,
    length_penalty,
    reconstruct_attention,
    reconstruct_tokens,
    step_beams,
    step_beams_cand,
    tokens_to_sentences,
    unroll_ring,
)
from .engine import Completion, TranslationEngine
from .infer import (
    FusedDecState,
    PackedDecoder,
    beam_search_packed,
    encode_packed,
    pack_decoder,
    packed_decode_step,
    packed_decode_step_topk,
)
from .sharded import (
    beam_search_sharded,
    make_sharded_decode_step_topk,
    pack_generator_sharded,
    shard_decoder,
)

__all__ = [
    "NEG_INF",
    "BeamState",
    "Completion",
    "FusedDecState",
    "PackedDecoder",
    "TranslationEngine",
    "beam_decode",
    "beam_search",
    "beam_search_packed",
    "beam_search_sharded",
    "coverage_penalty",
    "encode_packed",
    "expand_to_beams",
    "greedy_decode",
    "init_beam_state",
    "length_penalty",
    "make_sharded_decode_step_topk",
    "pack_decoder",
    "pack_generator_sharded",
    "packed_decode_step",
    "packed_decode_step_topk",
    "reconstruct_attention",
    "reconstruct_tokens",
    "shard_decoder",
    "step_beams",
    "step_beams_cand",
    "tokens_to_sentences",
    "unroll_ring",
]
