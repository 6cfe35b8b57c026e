"""Serving: the beam core, packed-weight inference and the
continuous-batching engine of the PyTorch port."""

from .beam import (
    NEG_INF,
    BeamState,
    beam_decode,
    beam_search,
    coverage_penalty,
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
from .sharded import pack_generator_sharded

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
    "coverage_penalty",
    "encode_packed",
    "greedy_decode",
    "init_beam_state",
    "length_penalty",
    "pack_decoder",
    "pack_generator_sharded",
    "packed_decode_step",
    "packed_decode_step_topk",
    "reconstruct_attention",
    "reconstruct_tokens",
    "step_beams",
    "step_beams_cand",
    "tokens_to_sentences",
    "unroll_ring",
]
