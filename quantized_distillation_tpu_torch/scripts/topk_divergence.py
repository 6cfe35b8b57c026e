"""The fused generator's top-k against the exact top-k on a TRAINED decode
distribution (the PyTorch port's counterpart of the JAX package's
``scripts/topk_divergence.py``).

The port's generator kernel (``kernels/topk_fused.py``, ``csrc/
topk_fused.cu``) computes an exact top-k, but from its own logits: at bf16
compute the tensor-core pass accumulates in another order than the
dequant-matmul kernel that feeds the exact path, so near-degenerate logits
of a trained model may order differently across the two. This script
measures that on a trained toy translation model's peaked decode
distributions:

1. trains a seq2seq on the toy reversal task (Zipf word draws when the
   vocabulary is larger than 8000) in this process on ``--device``;
2. walks the exact beam-decode trajectory step by step: at every step the
   same generator input goes to (a) the exact path, the dequant-matmul
   kernel's logits and a top-k in ``jax.lax.top_k``'s order, and (b) the
   fused generator kernel, recording per live row top-k set mismatches,
   top-1 mismatches and the top-k value gap (absolute, and relative to the
   row's largest |logit|); the beams advance on the exact logits, so both
   paths see one trajectory. The deploy packs at bf16 compute; a control
   walk (first seed) packs at f32;
3. decodes each seed's test batch end to end with ``beam_search_packed``,
   fused and exact, and reports both BLEUs and their token agreement.

The port's top-k has no ``slots``: ``per_step`` holds one entry,
``"exact"``, with the JAX script's per-entry keys; its exactness
certificate is all ones, so ``cert_fail_rate`` is 0 and
``unsound_certificates`` counts every mismatch.

    python -m quantized_distillation_tpu_torch.scripts.topk_divergence --vocab 32000
    python -m quantized_distillation_tpu_torch.scripts.topk_divergence --device cpu

Prints the per-epoch train loss and per-seed BLEU lines on stderr and, as
the last line of stdout, one JSON object with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .._device import resolve_device
from ..config import BeamConfig, TrainConfig
from ..convert import params_to_numpy
from ..data import nmt_batches, toy_corpus
from ..kernels import dequant_matmul, dequantize_linear, launch_counts, launches_since
from ..kernels.topk_fused import dequant_matmul_topk, topk_sorted
from ..models import make_seq2seq
from ..serve import tokens_to_sentences
from ..serve.beam import expand_to_beams, init_beam_state, step_beams
from ..serve.infer import _decode_body, beam_search_packed, encode_packed, pack_decoder
from ..train import build_optimizer, create_train_state, make_train_step, nmt_task
from ..utils.bleu import corpus_bleu

VOCAB = 2000  # default; --vocab 32000 measures at the serving shape
N_TRAIN = 8000
SEED = 0
PRESET = "student_small"
HIDDEN, EMBED = 256, 128
EPOCHS = 6
BATCH = 128  # train batch

# bf16 deploy: a mismatched row's top-k values may differ by at most a few
# bf16 ulps relative to the row's largest |logit| (two roundings of 2^-8
# each and the accumulation order; 8 * 2^-8 = 3.1%); a larger gap is a real
# wrong index, whose gap is the spacing between logits, not an ulp.
BF16_NOISE_REL = 8.0 * 2.0 ** -8
# f32 control: both kernels take the same f32 inputs and dequantized
# weights, and sum K products and the bias in their own orders. By
# Higham's bound (Accuracy and Stability of Numerical Algorithms, 2nd ed.,
# eq. 3.5), each logit is within gamma_n * S_j of the exact sum, with
# gamma_n = n u / (1 - n u), u = 2^-24, n = K + 2 (the weight's dequant
# rounding and the bias add counted) and S_j = sum_k |x_k w_kj| + |b_j|; the
# i-th largest value of a vector moves by at most the largest change of an
# element, so a tie swapped by rounding moves no top-k value further than
# 2 gamma_n max_j S_j. The bound is relative to that row scale.
F32_UNIT = 2.0 ** -24


def f32_noise_rel(depth: int) -> float:
    """The f32 control's bound on a top-k value gap, relative to the row's
    max_j S_j, for a generator of inner width ``depth``."""
    nu = (depth + 2) * F32_UNIT
    return 2.0 * nu / (1.0 - nu)


def build_corpus(n, seed, vocab=None):
    vocab = VOCAB if vocab is None else vocab
    # large (serving-size) vocabularies use Zipf word draws so the head of
    # the vocabulary is learnable from a fixed-size toy corpus
    return toy_corpus(n=n, vocab_size=vocab, min_len=6, max_len=6, seed=seed,
                      zipf=1.1 if vocab > 8000 else 0.0)


def build_model(corpus, device="cuda"):
    return make_seq2seq(PRESET, len(corpus.src_vocab), len(corpus.tgt_vocab), hidden=HIDDEN,
                        embed_dim=EMBED, dropout=0.0, device=device, seed=SEED)


def train_stage(vocab=None, device="cuda"):
    """Train the toy model → (the model, holding its trained weights, and
    the per-epoch mean losses)."""
    dev = resolve_device(device)
    corpus = build_corpus(N_TRAIN, SEED, vocab)
    model = build_model(corpus, dev)
    task = nmt_task(model, device=dev)
    tx = build_optimizer(TrainConfig(learning_rate=3e-3, clip_norm=5.0))
    state = create_train_state(dict(model.named_parameters()), tx, device=dev)
    step = make_train_step(task, tx, donate=False, device=dev)
    losses = []
    for epoch in range(EPOCHS):
        tot, nb = 0.0, 0
        for batch in nmt_batches(corpus, BATCH, seed=epoch, drop_remainder=True):
            batch.pop("index")
            state, m = step(state, batch, 1)
            tot += float(m["loss"])
            nb += 1
        losses.append(tot / nb)
        print(f"train epoch {epoch} loss {tot / nb:.4f}", file=sys.stderr, flush=True)
    with torch.no_grad():  # the step stepped its own copy (donate=False, as in JAX)
        for name, t in model.named_parameters():
            t.copy_(state.params[name])
    return model, losses


COUNT_KEYS = ("rows", "mismatch", "top1_mismatch", "cert_fail", "unsound")
GAP_KEYS = ("mismatch_vgap_max", "mismatch_vgap_rel_max", "unsound_vgap_max",
            "unsound_vgap_rel_max")


def step_stats(live, ev, ei, fv, fi, cert):
    """Per-step counts and largest gaps over the live rows, as the JAX
    script's ``measure_step`` defines them → (those numbers, the rows that
    mismatch, each row's top-k value gap)."""
    # set comparison (ties can permute equal-valued entries)
    match = (fi.sort(dim=1).values == ei.to(torch.int32).sort(dim=1).values).all(dim=1)
    top1 = fi[:, 0] == ei[:, 0].to(torch.int32)
    vgap = (fv.sort(dim=1).values - ev.sort(dim=1).values).abs().amax(dim=1)
    row_mag = ev.abs().amax(dim=1).clamp_min(1.0)
    vgap_rel = vgap / row_mag  # in units of the row's logit scale
    miss = live & ~match
    unsound = miss & (cert[:, 0] == 1)
    zero = torch.zeros_like(vgap)
    out = {"rows": live.sum(), "mismatch": miss.sum(), "top1_mismatch": (live & ~top1).sum(),
           "cert_fail": (live & (cert[:, 0] == 0)).sum(), "unsound": unsound.sum(),
           "mismatch_vgap_max": torch.where(miss, vgap, zero).max(),
           "mismatch_vgap_rel_max": torch.where(miss, vgap_rel, zero).max(),
           "unsound_vgap_max": torch.where(unsound, vgap, zero).max(),
           "unsound_vgap_rel_max": torch.where(unsound, vgap_rel, zero).max()}
    return {k: v.item() for k, v in out.items()}, miss, vgap


def walk(model, d, src, src_len, k, max_len, vsize, on_step):
    """The exact beam-decode trajectory on the packed decoder ``d``: at every
    step ``on_step(live, attn_h, ev, ei, fv, fi, cert)`` sees both paths'
    top-k, then the beams advance on the exact logits."""
    keys, enc_out, enc_mask, st = encode_packed(model, d, src, src_len)
    state = init_beam_state(expand_to_beams(st, k), src.shape[0], k, max_len, device=d.device)
    for t in range(max_len):
        live = ~state.finished.reshape(-1)
        new_dec, attn_h, _ = _decode_body(d, state.decoder_state, state.last_token.reshape(-1),
                                          keys, enc_out, enc_mask)
        logits = dequant_matmul(attn_h, d.generator, compute_dtype=d.compute_dtype)[:, :vsize]
        ev, ei = topk_sorted(logits, k)
        fv, fi, _, cert = dequant_matmul_topk(attn_h, d.generator, k,
                                              compute_dtype=d.compute_dtype, certify=True)
        on_step(live, attn_h, ev, ei, fv, fi, cert)
        state = step_beams(lambda s, tk: (new_dec, logits), state, t, beam_size=k)


def measure_stage(model, n_seeds=3, max_len=10, beam=5, batch=64, bits=4, vocab=None,
                  device="cuda"):
    """Walk and decode ``n_seeds`` test batches on ``model`` packed at
    ``bits`` → (the JAX script's output object, diagnostics: the f32
    control's mismatches past its bound, the bounds, and each search's
    kernel launches)."""
    dev = resolve_device(device)
    k, vsize = beam, model.cfg.tgt_vocab
    params = params_to_numpy(model)
    with torch.no_grad():
        dec = pack_decoder(params, model.cfg, bits, compute_dtype=torch.bfloat16, device=dev)
        # control: both kernels at f32 compute; their logits differ only by
        # the f32 summation order
        dec_f32 = pack_decoder(params, model.cfg, bits, compute_dtype=torch.float32, device=dev)
        w32 = dequantize_linear(dec_f32.generator)[:, :vsize].abs()
        b32 = dec_f32.generator.bias[:vsize].abs()
    f32_bound = f32_noise_rel(w32.shape[0])
    totals = dict.fromkeys(COUNT_KEYS, 0)
    gaps = dict.fromkeys(GAP_KEYS, 0.0)
    f32 = {"mismatch": 0, "past_bound": 0, "vgap_scaled_max": 0.0}

    def on_bf16(live, attn_h, ev, ei, fv, fi, cert):
        stats, _, _ = step_stats(live, ev, ei, fv, fi, cert)
        for m in COUNT_KEYS:
            totals[m] += int(stats[m])
        for m in GAP_KEYS:
            gaps[m] = max(gaps[m], float(stats[m]))

    def on_f32(live, attn_h, ev, ei, fv, fi, cert):
        _, miss, vgap = step_stats(live, ev, ei, fv, fi, cert)
        scale = (attn_h.abs() @ w32 + b32).amax(dim=1)  # max_j S_j of each row
        scaled = torch.where(miss, vgap / scale, torch.zeros_like(vgap))
        f32["mismatch"] += int(miss.sum())
        f32["past_bound"] += int((scaled > f32_bound).sum())
        f32["vgap_scaled_max"] = max(f32["vgap_scaled_max"], float(scaled.max()))

    bleu_rows = []
    searches = {"fused": {}, "exact": {}}
    cfg = BeamConfig(beam_size=k, max_len=max_len)
    with torch.no_grad():
        for seed in range(n_seeds):
            test = build_corpus(batch, 1000 + seed, vocab)
            tb = next(nmt_batches(test, batch, shuffle=False))
            src = torch.as_tensor(tb["src"]).long().to(dev)
            src_len = torch.as_tensor(tb["src_len"]).long().to(dev)
            walk(model, dec, src, src_len, k, max_len, vsize, on_bf16)
            if seed == 0:  # the f32 control walk
                walk(model, dec_f32, src, src_len, k, max_len, vsize, on_f32)

            # end to end: the fused generator vs the exact logits path
            tokens = {}
            for name, fused in (("fused", True), ("exact", False)):
                before = launch_counts()
                tokens[name], _ = beam_search_packed(model, dec, src, src_len, cfg,
                                                     fused_topk=fused, device=dev)
                for n, c in launches_since(before).items():
                    searches[name][n] = searches[name].get(n, 0) + c
            tf, te = tokens["fused"].cpu().numpy(), tokens["exact"].cpu().numpy()
            tok_agree = float((tf == te).mean())
            refs = [test.tgt_vocab.decode(t_) for t_ in test.tgt]
            order = [int(i) for i in tb["index"]]
            bleu_f = corpus_bleu(tokens_to_sentences(tf, test.tgt_vocab), [refs[i] for i in order])
            bleu_e = corpus_bleu(tokens_to_sentences(te, test.tgt_vocab), [refs[i] for i in order])
            bleu_rows.append({"seed": seed, "bleu_fused": bleu_f, "bleu_exact": bleu_e,
                              "token_agreement": tok_agree})
            print(f"seed {seed}: fused BLEU {bleu_f:.2f} exact BLEU {bleu_e:.2f} "
                  f"token agreement {tok_agree:.4f}", file=sys.stderr, flush=True)

    r = max(totals["rows"], 1)
    out = {"vocab": vsize, "beam": k, "bits": bits, "steps": max_len, "seeds": n_seeds,
           "per_step": {"exact": {
               "rows": totals["rows"],
               "topk_set_mismatch_rate": totals["mismatch"] / r,
               "top1_mismatch_rate": totals["top1_mismatch"] / r,
               "cert_fail_rate": totals["cert_fail"] / r,
               "unsound_certificates": totals["unsound"],
               "mismatch_value_gap_max": gaps["mismatch_vgap_max"],
               "mismatch_value_gap_rel_max": gaps["mismatch_vgap_rel_max"],
               "unsound_value_gap_max": gaps["unsound_vgap_max"],
               "unsound_value_gap_rel_max": gaps["unsound_vgap_rel_max"],
           }},
           "end_to_end": bleu_rows,
           "f32_shared_rounding_unsound": f32["mismatch"]}
    diag = {"bf16_noise_rel": BF16_NOISE_REL, "f32_noise_rel": f32_bound,
            "f32_mismatch_past_bound": f32["past_bound"],
            "f32_mismatch_value_gap_scaled_max": f32["vgap_scaled_max"],
            "search_launches": searches}
    return out, diag


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab", type=int, default=VOCAB,
                    help="vocabulary size (32000: the serving shape)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None, report=None) -> int:
    """The train stage, then the measure stage; raises if a bf16 mismatch
    lies past BF16_NOISE_REL or an f32-control mismatch past its bound.
    ``report`` (a dict), when given, receives the train losses and the
    measure stage's diagnostics."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the f32 control's scale in true f32
    t0 = time.perf_counter()
    model, losses = train_stage(args.vocab, dev)
    if report is not None:
        report.update(train_losses=losses, train_seconds=time.perf_counter() - t0)
    out, diag = measure_stage(model, vocab=args.vocab, device=dev)
    if report is not None:
        report.update(diag)
    print(f"f32 control: {out['f32_shared_rounding_unsound']} mismatches, "
          f"{diag['f32_mismatch_past_bound']} past the bound {diag['f32_noise_rel']:.3e} "
          f"(largest gap {diag['f32_mismatch_value_gap_scaled_max']:.3e} of the row scale)",
          file=sys.stderr, flush=True)
    for name, counts in diag["search_launches"].items():
        print(f"{name} search launches: {counts}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    ex = out["per_step"]["exact"]
    if ex["unsound_certificates"] and ex["unsound_value_gap_rel_max"] > BF16_NOISE_REL:
        raise AssertionError(
            f"a bf16 mismatch diverges beyond relative numeric noise "
            f"({ex['unsound_value_gap_rel_max']:.4f} > {BF16_NOISE_REL:.4f})")
    if diag["f32_mismatch_past_bound"]:
        raise AssertionError(
            f"f32 control: {diag['f32_mismatch_past_bound']} mismatches past the f32 bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
