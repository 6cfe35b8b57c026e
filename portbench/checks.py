"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference, each reduced to one number that has a limit
of its own (``portbench/limits/<cell>.json``).

Serving (beam search, beam K): every token of a served hypothesis extends
its prefix with one of the K best tokens of the model's distribution there,
so under the reference its logit lies at or above the K-th best logit up to
rounding (K = 1 is greedy decoding's rule). ``token_gap`` is the widest gap
by which a served token's reference logit lies below the reference's K-th
best at its position, over the sampled requests up to each one's first
EOS. ``score_gap`` is the widest difference, per scored token, between the
score the search returned and the reference's log-probability of the same
tokens. Neither sees a search that keeps fewer beams: ``beam_gap`` is the
mean over the sampled requests of the amount, per scored token, by which
the reference's log-probability of a served hypothesis falls below that of
the best hypothesis of the reference's own beam search (beam K) over the
same source, one-sided: a served hypothesis that scores higher reads 0.
A mean, not the widest: bfloat16 rounding parts a served search from the
float32 reference's at near ties, which costs one request in a dozen some
thousandths a token, as much as greedy decoding costs a typical one; over
the sample, greedy decoding reads several times what sound runs do.

Training: ``loss_gap`` is the widest relative difference of the first
steps' losses. Parameter by parameter, a gap is that between the
program's norm and the reference's, against the larger of the parameter's
reference norm and the median parameter's: ``grad_gap`` is the worst
parameter's gap of the first gradient as the optimizer takes it,
``change_gap`` the median parameter's gap of the change over the first
steps (by the third step the program's and the reference's rounding have
parted by a level of the 4-bit grid in some weights, so the worst
parameter's change swings from seed to seed). The change leaves out
parameters whose reference gradient is under a thousandth of the median
parameter's: Adam moves those by round-off alone.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

EOS = 2
EXCLUDE_BELOW = 1e-3


def scored_length(tokens: torch.Tensor) -> int:
    """Positions up to and including the first EOS (all without one)."""
    eos = (tokens == EOS).nonzero()
    return int(eos[0, 0]) + 1 if eos.numel() else int(tokens.numel())


def log_prob(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The reference's log-probability of ``tokens`` [T] up to the first
    EOS, from its logits [T, V] at each of their positions."""
    n = scored_length(tokens)
    logp = F.log_softmax(ref_logits[:n].double(), dim=-1)
    return float(logp.gather(1, tokens[:n].long()[:, None]).sum())


def beam_gap(best: float, ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """How far, per scored token, the reference's log-probability of the
    hypothesis ``tokens`` lies below ``best`` (that of the reference beam's
    best hypothesis); 0 where it lies above."""
    return max(best - log_prob(ref_logits, tokens), 0.0) / scored_length(tokens)


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor, score: float, beam: int,
                best: float) -> Dict[str, float]:
    """One request: ``ref_logits`` [T, V] of the reference at each position
    of the served ``tokens`` [T], the search's ``score``, and ``best``, the
    reference's log-probability of its own beam's best hypothesis."""
    n = scored_length(tokens)
    logits, toks = ref_logits[:n].double(), tokens[:n].long()
    kth = torch.topk(logits, beam, dim=-1).values[:, -1]
    mine = logits.gather(1, toks[:, None])[:, 0]
    return {"token_gap": float(torch.clamp(kth - mine, min=0).max()),
            "score_gap": abs(score - log_prob(ref_logits, tokens)) / n,
            "beam_gap": beam_gap(best, ref_logits, tokens)}


def control_gaps(ref_logits: torch.Tensor, ctrl_logits: torch.Tensor, tokens: torch.Tensor,
                 beam: int, best: float, ref_of_ctrl_best: torch.Tensor,
                 ctrl_best: torch.Tensor) -> Dict[str, float]:
    """The control's readings on one request: at each position of the
    served tokens, the gap of the K tokens the control ranks first, and the
    control's score of the served tokens against the reference's; and the
    beam gap of the best hypothesis of the control's own beam search
    (``ctrl_best``, with the reference's logits at its positions)."""
    n = scored_length(tokens)
    ref, ctrl, toks = ref_logits[:n].double(), ctrl_logits[:n].double(), tokens[:n].long()
    kth = torch.topk(ref, beam, dim=-1).values[:, -1:]
    picks = torch.topk(ctrl, beam, dim=-1).indices
    gap = torch.clamp(kth - ref.gather(1, picks), min=0).max()
    ref_score = F.log_softmax(ref, dim=-1).gather(1, toks[:, None]).sum()
    ctrl_score = F.log_softmax(ctrl, dim=-1).gather(1, toks[:, None]).sum()
    return {"token_gap": float(gap), "score_gap": float(abs(ctrl_score - ref_score)) / n,
            "beam_gap": beam_gap(best, ref_of_ctrl_best, ctrl_best)}


def over_requests(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Each number over the requests: the mean of a beam gap, the widest
    reading of the others."""
    return {k: statistics.mean(r[k] for r in readings) if k.endswith("beam_gap")
            else max(r[k] for r in readings) for k in readings[0]}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              names: List[str]) -> Dict[str, float]:
    """Each parameter's gap between the two norms, against the larger of its
    reference norm and the median parameter's."""
    med = statistics.median(reference[n] for n in reference)
    return {n: abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in names}


def worst_leaf(program: Dict[str, float], reference: Dict[str, float], names: List[str]):
    """(the worst parameter, its gap)."""
    gaps = leaf_gaps(program, reference, names)
    name = max(gaps, key=gaps.get)
    return name, gaps[name]


def _compared(reference: dict) -> Dict[str, List[str]]:
    """The parameters each parameter-wise number takes: every one for the
    gradient, those the reference's gradient moves for the change."""
    grad = reference["grad"]
    med = statistics.median(grad.values())
    return {"grad": list(grad), "change": [n for n in grad if grad[n] >= EXCLUDE_BELOW * med]}


def train_gaps(program: dict, reference: dict) -> Dict[str, float]:
    """``program`` and ``reference``: ``{"loss": [...], "grad": {name:
    norm}, "change": {name: norm}}`` over the same steps."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program["loss"], reference["loss"], strict=True))
    names = _compared(reference)
    return {"loss_gap": loss,
            "grad_gap": worst_leaf(program["grad"], reference["grad"], names["grad"])[1],
            "change_gap": statistics.median(
                leaf_gaps(program["change"], reference["change"], names["change"]).values())}


def train_worst(program: dict, reference: dict) -> Dict[str, str]:
    """Which parameter reads worst, for each parameter-wise number, and each
    step's loss of both sides: what a reading is looked into by."""
    out = {}
    for key, names in _compared(reference).items():
        name, gap = worst_leaf(program[key], reference[key], names)
        out[f"{key}_gap.worst"] = (f"{name} gap {gap!r} program {program[key][name]!r} "
                                   f"reference {reference[key][name]!r}")
    out["loss"] = f"program {program['loss']!r} reference {reference['loss']!r}"
    return out
