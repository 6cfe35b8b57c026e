#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

It checks the port on the card and does not time its paths: their speed
is the benchmark's (``python3 -m portbench.program``). The device times it
prints are each kernel's, against its plain version, a PyTorch yardstick
and its bound.

Phases, each printing one JSON line:

1. device: the card's name, count and ``nvidia-smi`` power limit; exits
   non-zero without a result when PyTorch sees no card;
2. build: compiles the four CUDA sources of ``csrc/`` (one ``nvcc`` each,
   in parallel; the LUT variants are template instances in two of them) and
   reports the ``ptxas`` resource lines; fails if ``ptxas``
   serialized the wgmma of any instance (warning C7518) or spilled in a
   tensor-core instance; then ``cuobjdump -sass`` of the dequant-matmul and
   fused-generator libraries counts the tensor-core instructions (HGMMA,
   HMMA) of each instance: at least one in every bf16-compute instance,
   none in the f32 ones;
3. kernels: calls each serving kernel's wrapper at the shapes the serving
   main path gives it (student_medium, V=32000, B=256 x beam 5 = 1280 rows,
   4-bit), holds it against its plain PyTorch version on the same inputs
   (dequant-matmul and the generator also at a ragged 77 x 200 x 700, the
   generator at K = 77 too, for 2/4/8 bits; both at rtol = atol = 1e-4 for
   bf16 compute as for f32; the standalone beam combine and the beam
   advance bit-exact, the advance also at K in {1, 3, 5, 8}, kc = K and kc
   > K, t first and last, with finished beams, EOS winners, ties and
   NEG_INF blocks, and in the engine's form: the ring row read from device
   memory, some, no or all sentences active), and times kernel, plain
   version and a one-call PyTorch yardstick on the device: CUDA events
   around a CUDA graph of back-to-back calls, so the host's time to issue
   each call is left out (dequant-matmul and the generator also report
   their plan, TFLOP/s and share of the bound);
4. main path: ``pack_decoder`` → ``beam_search_packed`` at full width (depth
   as published: 2 layers), which runs the search as one CUDA graph: checks
   the launch counters on the capturing call and on a replay (3
   dequant-matmul, 1 fused top-k, 1 beam advance per decode step, no
   standalone combine; the LSTM cell kernel once an encoder layer and
   source position), finite scores, and f32 tokens and scores of the
   graph equal to the eager loop's on the card, the tokens also to the
   port's CPU plain path, on 16 sentences;
5. (no line: the search's device time by kernel is the benchmark's trace);
6. train kernel: the fake-quant kernel at the train step's shape (every
   quantizable leaf of student_medium: 105,984 buckets x 256), bit-exact
   against its plain version for 2/4/8 bits x linear/abs-max and on
   constant and zero buckets, timed against the plain version; then the
   grouped expert matmul (``csrc/grouped_matmul.cu``) at the DeepSeek-V2
   cell's shapes (:func:`phase_grouped_kernel`: T = 16,384 tokens, P = 6T
   pairs, 8 uneven held groups with an empty one and a discard group after
   them, 2048 -> 1408 with the rows gathered and 1408 -> 2048 without):
   forward, data and weight gradient against the plain versions on the
   same inputs (f32: rtol 1e-5, atol 2e-5 of the largest |value|), the
   discard rows 0, the rows each group's tiles covered, the launches (2
   products and 1 weight gradient a direction, counters zeroed just
   before), and the device ms of a forward and of a forward + backward;
   then the LSTM cell (``csrc/lstm_cell.cu``, :func:`phase_lstm_kernel`) at
   the cells' B x W (256 / 128 / 64 rows x the students' 256, the nmt
   teacher's 500 and the LM teacher's 650, the scalar path) and a
   tensor-parallel shard's (64 of 256 over 4), on random and saturating
   inputs, the per-step input a strided slice: ``lstm_gates`` forward (with
   and without autograd) and the gradients of all five inputs, with both
   outputs and with either absent, ``torch.equal`` to the composite on the
   card (the kernels repeat its roundings in its order); one
   launch a call each way after the counters are zeroed; one graphed KD
   step of each LSTM family (seq2seq at phase 7's shape, the LM at phase
   14's) and its replay, whose cell launches must follow from the models'
   layers and steps; and device us a call, kernel against composite,
   forward and forward + backward;
7. train path: 4-bit STE knowledge distillation of student_medium from the
   2x500 teacher at ``bench.py --train --family seq2seq``'s shape (V=32000,
   B=128, L=24, Adam 1e-3, clip 5, KD w=0.7 T=5): ``nmt_task`` →
   ``create_train_state`` → ``make_train_step`` for 10 steps on one batch,
   then ``make_eval_step``; checks one fake-quant launch per step (and one
   for the eval step), finite loss and gradient norm, a falling loss, and
   one step at B=8 on the card against the port's CPU plain path from the
   same weights; then the graphed step (``make_train_step`` runs one CUDA
   graph per signature on the card) against the eager one (``_eager=True``)
   on a student with dropout 0.3 (:func:`graph_legs`: 10 steps from copies
   of one state, every tensor and loss bit-equal where two eager runs are,
   one capture, one fake-quant launch a step, another seed another loss;
   phase ``train_graph``);
8. (no line: the step's device time by kernel is the benchmark's trace);
9. codebook train: differentiable quantization at the same shape, 4-bit
   learned codebooks (``QuantSpec(method="codebook")``), mode ``joint``:
   10 steps and the eval step with the trained codebooks; checks that no
   kernel launches (the JAX package runs none here either), finite loss and
   gradient norm, a falling loss, that weights and codebooks both move, and
   one joint step at B=8 on the card against the CPU plain path; after the
   updates of :func:`settle_joint`, holds the graphed joint step to the
   eager one (:func:`graph_legs`, no launch) and takes the codebooks,
   then runs 2 steps in mode ``codebooks`` that must leave every weight
   bit-identical and move the codebooks;
10. LUT kernels: the LUT variants of dequant-matmul (the three decode-step
   shapes, 2/4/8 bits, f32 and bf16 compute) and of the fused generator
   ([1280, 256] x [256, 32000] padded to 32768 without a -1e9 bias, 4-bit,
   k=5) against their plain versions, timed like phase 3;
11. codebook path: ``pack_decoder(points=<the trained generator/kernel
   codebook>, lut_mode="exact")`` → ``beam_search_packed`` at full width
   (one CUDA graph): launch counts on the capturing call and a replay (3
   LUT dequant-matmul, 1 LUT fused top-k, 1 beam advance per decode step),
   finite scores, f32 tokens and scores of the graph equal to the eager
   loop's on the card and the tokens to the CPU plain path on 16
   sentences; a ``lut_mode="requant8"`` deploy that must launch only the
   uniform kernels;
12. engine: the continuous-batching ``TranslationEngine`` at ``bench.py
   --engine``'s shape (student_medium, V=32000, S=256 slots x beam 5,
   source length 24, admit_batch 16; phase 4's bf16 decoder): f32 parity,
   32 sentences through an 8-slot engine with staggered arrivals
   (max_tgt_len 24) against the offline graphed ``beam_search_packed`` on
   the card, plain and with ``length_penalty=0.6, coverage_penalty=0.4``
   (tokens equal, scores rtol 1e-5); at full occupancy (every slot live,
   max_tgt_len 256) the launches of a driven chunk of 8 steps (3
   dequant-matmul, 1 fused top-k, 1 beam advance a step, through graph
   replays, no standalone combine; the replays run under
   ``set_sync_debug_mode("error")``); churn, 3 S requests with seeded
   Poisson arrivals at 0.9 offered load (max_tgt_len 64, chunk_steps 4,
   busy 1, stage_ahead 2): every request completes with a finite score,
   occupancy, steady-state occupancy and idle shares as bench.py defines
   them; after
   phase 11, 16 requests through an engine on the exact-LUT deploy, which
   must launch only the LUT kernels (3 + 1) and the advance a step;
13. vision train: 4-bit STE KD of the WideResNet family at ``bench.py
   --train --family wrn``'s shape (WRN-28-10 teacher, 36,536,884
   parameters → WRN-16-4 student, CIFAR-100, B = 256, 32×32×3, Adam 1e-3,
   clip 5, ``DistillSpec()``): ``vision_task`` → ``create_train_state(
   batch_stats=...)`` → 10 steps on one seeded batch → ``make_eval_step``;
   checks one fake-quant launch a step over 10,814 buckets (and one for the
   eval step; the kernel at that shape bit-exact against its plain
   version), finite loss and gradient norm, a falling loss, running
   statistics that moved, and one step at B = 8 on the card against the
   CPU plain path from the trained weights and statistics (the new
   statistics at W_RTOL / W_ATOL); 2 steps in mode ``joint`` (learned
   codebooks, as ``examples/cifar100_wrn_diffquant.py`` trains) that launch
   no kernel; the graphed step against the eager one (:func:`graph_legs`,
   under :func:`cudnn_deterministic`);
14. LM train: the 2x650 teacher → ``student_medium`` LSTM LM at ``bench.py
   --train --family lm``'s shape (V = 10000, bptt 35, B = 256) with
   ``lm_task(thread_carry=True)``: on the card each step's input carry is
   the last step's output carry, with no gradient history (a recording
   task, run with ``_eager=True``: a replay would not record); then the
   checks of phase 13 (24,096 buckets, no statistics), the B = 8 parity
   over two threaded steps (carries at W_RTOL / W_ATOL), the graphed step
   against the eager one with the carry threaded (:func:`graph_legs`);
15. vision families: the CNN (``teacher`` → ``student_small``, CIFAR-10, B
   = 128, ``examples/cifar10_distill.py``) and the ResNet (``resnet18`` →
   ``resnet18_half``, ImageNet stem at 224×224, 1000 classes, B = 64):
   3 STE steps each with the launch, finite and statistics checks, and a
   B = 4 step on the card against the CPU;
16. artifact: the deploy loop from disk at full width. Phase 4's seeded
   student is written as a 4-bit uniform ``.qdt`` (``save_artifact``:
   Huffman-coded levels through the host codec, ``csrc/qdt_native.cpp``,
   built with ``g++`` in phase 2) and as a codebook ``.qdt`` (phase 9's
   trained codebooks), read back onto the card (``load_artifact``),
   packed (``pack_decoder``; the codebook file as the exact-LUT deploy on
   its ``generator/kernel`` codebook) and served by the graphed
   ``beam_search_packed``: launch counts on the capturing call and a
   replay (3 dequant-matmul, 1 fused top-k, 1 beam advance a step, the
   LUT variants for the codebook file), finite scores, f32 tokens of the
   file on the card equal to the CPU plain path's on the same file (16
   sentences); file bytes, fp32 bytes and compression ratio beside the
   ``model_size_report`` estimate from the measured index streams; the
   host codec's round trip of the index streams. Then phase 7's train state (student_medium with its
   Adam moments) saved and restored through ``ExperimentManager`` on the
   card, bit-equal, and the port's WMT driver (``python -m
   quantized_distillation_tpu_torch.examples.wmt_distill --device cuda``,
   toy corpus of 1,000 pairs, one epoch each) as a subprocess that must
   exit 0 with its ``final`` event. Files go to a temporary directory
   under ``runs/``, removed at the end;
17. drivers: the four paper drivers of ``examples/`` in this process
   through their ``main(argv)`` with ``--device cuda``, on their synthetic
   data, each under its own workdir in a temporary directory under
   ``runs/`` (removed at the end): CIFAR-10 (``teacher`` → ``student_small``,
   4-bit, 2,560 images, 15 epochs a stage: BASELINE config 1), CIFAR-100
   WRN-28-10 → WRN-16-4 (2-bit, ``--auto-bits 3``, 2,560 images, one epoch
   a stage, the codebook stage included: BASELINE config 2), ImageNet
   ``resnet18`` → ``resnet18_half`` (64 px, 1000 classes, 2,048 images, B =
   64, one epoch a stage) and the PTB LM (2x650 → 2x256, V = 10000, 200,000
   tokens, one epoch a stage). Each must return 0 with a ``final`` event
   whose numbers are finite, register its teacher and student, each with a
   checkpoint, and launch the fake-quant kernel exactly as its code implies
   (one launch per student STE step and per quantized eval batch; the
   teachers, the bit assignment and the codebook stage none), more than
   zero times; the CIFAR-10 student's quantized accuracy must exceed 0.2.
   One line per driver: its final event, the launches, and the fake-quant
   kernel bit-exact against its plain version and timed on the buckets of
   the driver's student at its bits (after the counted run).

18. multi_gpu: the mesh-sharded paths (``parallel/``, ``serve/sharded.py``,
   ``TranslationEngine(mesh=)``, ``make_train_step(mesh=)``). (a) NCCL at
   world size 1 in this process, mesh (1, 1), full width: the sharded
   search (one CUDA graph, its all-gathers inside) launches 3 dequant-matmul,
   1 fused top-k and 1 beam advance a step on the capturing call and a
   replay, records its all-gathers, and gives f32 tokens equal to
   ``beam_search_packed``'s (graphed equal to eager), uniform and exact-LUT;
   16 requests through a ``TranslationEngine(mesh=)`` equal to the offline sharded search; a
   full-width KD step (B = 128) with ``grad_reduce_dtype=torch.bfloat16``
   within the JAX package's tolerance of the mesh-less step (loss rtol
   1e-5, weights rtol 0.05, atol 1e-4), one fake-quant launch each, the
   mesh step graphed; then the mesh KD steps as CUDA graphs
   (:func:`mesh_graph_legs`, lines ``mesh_*_graph``): DP with the bf16
   reduce, TP ``weights`` and ``joint`` (seq2seq at phase 7's width,
   dropout 0.3), the LM TP with the carry threaded (phase 14's width) and
   WRN-28-10 → WRN-16-4 DP (phase 13's), 10 steps graphed beside three
   eager runs of 10 from copies of one state: graphed equal to eager bit
   for bit (the WRN under deterministic cuDNN), one capture, one
   fake-quant launch a STE step (none in ``joint``), and every replay's
   collectives those of the eager step. (b) 4
   ranks sharing the card over gloo (``parallel.launch.run_ranks``), meshes
   (1, 4) and (2, 2), full width: each rank's fused generator kernel at its
   shard width (N = 8192, 16384) against its plain version at rtol = atol =
   1e-4, f32 and bf16; the f32 sharded search (eager: gloo's collectives
   go through the host) with 3 / 1 / 1 launches a step on every rank, its
   tokens equal on every rank and to a one-process emulation of the same
   shards and merge, and equal to the one-process search's but where that
   search had a tie of at most 2 ulps (the merged logsumexp sums in another
   order), scores within 1e-4. (c) 2 ranks over gloo: a B = 8 DP step (f32
   reduce) equal to the one-rank step on all 8 rows (loss rtol 1e-5,
   weights rtol 1e-5, atol 1e-6), eager (a gloo step is never graphed).
   Then the generator, uniform and LUT, at
   the shard widths in this process, checked and timed like phase 3.
   (d) tp_train: tensor-parallel KD training (``make_train_step(mesh=,
   param_specs=)`` on ``place_params_seq2seq`` shards, SGD lr 1e-2,
   dropout 0). At mesh (1, 1) over NCCL in (a)'s group, the full-width
   seq2seq step's TP code path (one-rank collectives) equal to the
   mesh-less step, graphed. Over gloo (eager on every rank), 4 ranks
   sharing the card at (1, 4) and (2, 2)
   (the full-width seq2seq step: teacher 2x500 → student_medium, V =
   32000, B = 128, L = 24, each rank its data rows) and 2 ranks at (1, 2)
   (the LM: 2x650 → student_medium, V = 10000, B = 256 x 35): each rank's
   loss and grad norm (rtol 1e-5) and SGD-updated shard (rtol 1e-5, atol
   1e-6) against the slices of the one-process step on the card, one
   fake-quant launch a rank, all-gathers, reduce-scatters and all-reduces
   over ``model`` in the budget, and on every rank of the first mesh the
   fake-quant kernel on the gathered tree (105,984 buckets; the LM's
   24,096) bit-exact against its plain version. Then ``python -m
   quantized_distillation_tpu_torch.scripts.comm_budget`` (full width, 8
   gloo ranks on the card) and ``...scripts.multihost_smoke --device
   cuda`` (4 gloo ranks) as subprocesses that must exit 0.
19. quality: the quality scripts on trained models, in this process
   through their ``main(argv)``. ``scripts.topk_divergence --vocab 32000``
   trains the toy translation model (Zipf words, V = 32,000), walks its
   beam trajectory with the bf16 deploy (3 seeds x 10 steps, B = 64, beam
   5, 4-bit) and an f32 control walk, and decodes each seed with
   ``beam_search_packed`` fused and exact: it must return 0 with the JAX
   script's keys, every bf16 top-k mismatch within 8 x 2^-8 of the row's
   largest |logit|, no f32-control mismatch past its rounding bound, finite
   BLEU, and the launches its code implies (its one-layer student: 2
   dequant-matmul, 1 generator, 1 beam advance a step in the fused search,
   3 dequant-matmul in the exact one, 3 + 1 a step in the walks).
   ``scripts.accuracy_grid --wrn --wrn-data 256`` (the JAX script's
   defaults, the WRN-28-10 grid cut to 256 images for its launches alone)
   must return 0 with every cell finite (accuracies in [0, 1], BLEU in [0,
   100]), the CNN teacher at 0.2 or more and the NMT teacher at 50 BLEU or
   more, and the fake-quant launches its code implies
   (:func:`grid_fake_quant_launches`) and no other. One line per grid with
   its cells and the JAX package's own run beside it (from
   ``BASELINE.md``), and the ``contract_checks``, reported, not gated.
20. graft: ``graft_entry.entry()`` (the flagship student_medium's 4-bit
   STE forward, V = 8192, B = 8, 24 x 24) eager and as one CUDA graph
   (``graft_entry.graphed_entry``): one fake-quant launch each, the graph
   bit-equal to the eager call, the card's f32 logits within 1e-4 of a CPU
   run of the same forward on the same weights; then
   ``graft_entry.dryrun_multichip`` over NCCL at ``torch.cuda.device_count()``
   ranks (one rank a card; the step and the search graphed; the preset's
   dropout) and over gloo at 4 ranks sharing the card (mesh (2, 2), eager,
   dropout 0), both projecting from the flagship step measured on the card
   (``graft_entry.measure_flagship_step``) and without the multi-process
   smoke (phase 18 runs that command): finite
   losses, equal on every rank, one fake-quant launch a rank a KD step, the
   toy student's search and decode step launching 2 dequant-matmul, 1
   generator (and 1 advance) a step on every rank, each projection line
   naming the card; each dry run held to the same one on the CPU (the
   plain versions, the same seeded weights): every rank's search tokens
   equal, its scores within 1e-4, and the gloo run's losses (f32 and
   reduced gradient reduce) within 1e-4. One ``graft`` line: forward shape,
   launches, loss per mesh, backend, card-vs-CPU differences, payloads,
   the projection and the step it used, budgets, card;
21. bench: ``quantized_distillation_tpu_torch.bench.main`` in this process
   at full width with short chains (``--lo 1 --hi 2 --trials 1``): serving,
   ``--engine`` and ``--train --family seq2seq|wrn|lm``, each line with
   ``bench.py``'s keys (in its order) and finite, positive values; the
   launches of each run: 3 dequant-matmul, 1 generator and 1 advance a
   packed search step and nothing else in serving (so none in the FP32
   leg), the same 3 / 1 / 1 ratio in the engine, one fake-quant launch a
   4-bit train step and nothing else in training; the flagship record
   (``bench_flagship_train_torch.json``) written with ``bench.py``'s keys
   and the card; the bench's own loops: a chain of 3 packed searches
   launches 3 x (72 / 24 / 24), a chain of 2 dense FP32 searches none;
   last ``kernels.topk_fused.topk_sorted``, the dense search's top-k, at its
   shape ([B, K * V] = [256, 160000]) on rows with injected ties, -inf runs
   and ±0, indices and values equal to ``torch.sort(stable=True)``'s, and
   its device ms against the sort's and one ``torch.topk``'s (CUDA graphs
   of 20 calls);
22. multi_card: where PyTorch sees at least ``MULTI_CARDS`` (4) cards,
   ``python -m quantized_distillation_tpu_torch.scripts.multicard_smoke
   --cards 4`` as a subprocess (one NCCL rank a card: the sharded search
   at meshes (1, 4), (2, 2) and (4, 1), the mesh engine, the graphed DP
   and TP KD steps, ``dryrun_multichip(4)``; see its docstring), which
   must exit 0; one ``multi_card`` line with its last lines and each
   kernel's launches a rank by mesh. With fewer cards, the one line
   ``{"phase": "multi_card", "ran": false, "cards": n}`` and nothing else.

TF32 is off for matmul and cuDNN throughout, so every
f32 product on the card is a true f32 product, as on the CPU. The card-vs-CPU steps (phases
7, 9, 13-15) run through the train step's own ``prepare``, ``gradients``
and ``update`` on both devices, the CPU on the card's ReLU sign patterns
(:func:`relu_masks`), and fail where the CPU's own signs differ on more
than ``RELU_FLIP_SHARE`` (1 in 10^5) of the ReLU outputs of a step.

Then the kernel table as one JSON object, each row its kernel's device
times, plan and bound (the generator rows also their times at the shard
widths of phase 18; each phase's launches are in its own line), then the
result line ``{"ok": true, "device": {...}}``. The phases share only what
they build on: the model, its weights, the trained codebooks and train
state. Any failed check exits non-zero before
that line. Weights are random, made from a seed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from quantized_distillation_tpu_torch.config import (
    BeamConfig,
    DistillSpec,
    QuantSpec,
    ServeConfig,
    TrainConfig,
)
from quantized_distillation_tpu_torch.convert import (
    batch_stats_to_numpy,
    flax_leaves,
    params_to_numpy,
)
from quantized_distillation_tpu_torch.data import (
    load_cifar,
    load_imagenet,
    nmt_batches,
    toy_corpus,
)
from quantized_distillation_tpu_torch.data.cifar import BASE_DATA_FOLDER
from quantized_distillation_tpu_torch.examples import (
    cifar10_distill,
    cifar100_wrn_diffquant,
    imagenet_resnet_distill,
    ptb_lm_distill,
)
from quantized_distillation_tpu_torch.kernels import (
    _build,
    beam_advance,
    beam_advance_reference,
    beam_combine_topk,
    beam_combine_topk_reference,
    dequant_matmul,
    dequant_matmul_plan,
    dequant_matmul_reference,
    dequant_matmul_topk,
    dequant_matmul_topk_plan,
    dequant_matmul_topk_reference,
    dequantize_linear,
    fake_quant_buckets,
    fake_quant_buckets_reference,
    grouped_matmul,
    grouped_matmul_reference,
    launch_counts,
    lstm_cell,
    lstm_cell_reference,
    pack_linear,
    pick_generator_group,
)
from quantized_distillation_tpu_torch.models import (
    CNN_PRESETS,
    LM_PRESETS,
    SEQ2SEQ_PRESETS,
    ConvForwardNet,
    Seq2Seq,
    make_cnn,
    make_lm,
    make_resnet,
    make_seq2seq,
    make_wrn,
)
from quantized_distillation_tpu_torch.models.seq2seq import lstm_gates
from quantized_distillation_tpu_torch import native
from quantized_distillation_tpu_torch.parallel import (
    ModelParallel,
    make_mesh,
    place_batch,
    place_params_lm,
    place_params_seq2seq,
    placed_pspecs,
)
from quantized_distillation_tpu_torch.parallel.comm import capturable, collective_budget
from quantized_distillation_tpu_torch.parallel.launch import run_ranks
from quantized_distillation_tpu_torch.ops.bucketing import to_buckets
from quantized_distillation_tpu_torch.ops.sizes import model_size_report
from quantized_distillation_tpu_torch.serve import (
    TranslationEngine,
    beam_search_packed,
    pack_decoder,
)
from quantized_distillation_tpu_torch.serve.beam import EOS, PAD
from quantized_distillation_tpu_torch.serve.sharded import (
    beam_search_sharded,
    generator_shard,
    pack_generator_sharded,
    shard_decoder,
)
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    lm_initial_carry,
    lm_task,
    make_eval_step,
    make_train_step,
    nmt_task,
    vision_task,
)
from quantized_distillation_tpu_torch.train.manager import ExperimentManager
from quantized_distillation_tpu_torch.train.quantize_tree import (
    index_streams,
    is_quantizable,
    param_sizes,
)
from quantized_distillation_tpu_torch.train.optim import apply_updates, global_norm
from quantized_distillation_tpu_torch.train.trainer import (
    Task,
    as_batch,
    map_tensors,
    quantized_params,
    trainable,
)
from quantized_distillation_tpu_torch import bench, graft_entry
from quantized_distillation_tpu_torch.kernels.topk_fused import topk_sorted
from quantized_distillation_tpu_torch.scripts import accuracy_grid, topk_divergence
from quantized_distillation_tpu_torch.scripts.multicard_smoke import (
    CELL_COUNTERS,
    F32_TOL,
    Checks,
    advance_inputs,
    check_advance,
    check_dequant_matmul,
    check_topk,
    cudnn_deterministic,
    decode_matrices,
    expected as expected_on,
    graph_leg,
    lut_points,
    path_counts,
    serve_inputs,
    sharded_step_check,
    zero_counts,
)
from quantized_distillation_tpu_torch.utils.artifact import load_artifact, save_artifact
from quantized_distillation_tpu_torch.utils.profiling import CHIP_PEAKS, graph_ms

# the card's data-sheet peaks, one definition (utils/profiling.CHIP_PEAKS)
PEAK_BF16 = CHIP_PEAKS["H100"]["bf16_tflops"] * 1e12  # dense bf16 tensor-core FLOP/s
PEAK_F32 = CHIP_PEAKS["H100"]["f32_tflops"] * 1e12  # f32 FLOP/s outside the tensor cores
HBM = CHIP_PEAKS["H100"]["hbm_gbs"] * 1e9  # device memory, bytes/s
# train-step parity, as tests/test_torch_train.py states it for f32: loss and
# metrics rtol 1e-5; gradients within 1e-4 of the tensor's largest |gradient|;
# updated weights rtol 1e-5, atol 1e-6
LOSS_RTOL, GRAD_TOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-5, 1e-6
RELU_FLIP_SHARE = 1e-5  # card-vs-CPU ReLU sign flips: at most this share of the outputs a step

DESIGN = "tensor cores (wgmma)"
DESIGN_TOPK = ("tensor cores (wgmma), x resident in shared memory, lse from registers, "
               "top-k by a filter, then a merge by each row's quad")
RAGGED = (77, 200, 700)  # M, K, N: K not a multiple of 16, N of 64
RAGGED_TOPK_K = (200, 77)  # the generator also at K = 77: x rows off 16-byte alignment

SRC = "quantized_distillation_tpu_torch/csrc/"
ADMIT_BATCH = 16  # bench.py --engine's admission width
ENGINE_T_MAX = 256  # bench.py --engine's max_tgt_len at full occupancy
JAXK = "quantized_distillation_tpu/kernels/"
def read_counts() -> dict:
    """The serving and train kernels' counters (the LSTM cell's are read by
    :func:`cell_counts`: they follow each model's layers and steps)."""
    torch.cuda.synchronize()
    return path_counts(launch_counts())


def cell_counts() -> dict:
    torch.cuda.synchronize()
    counts = launch_counts()
    return {name: counts[name] for name in CELL_COUNTERS}


def expected(**counts) -> dict:
    """Every counter of :func:`read_counts` at 0 except those given."""
    return expected_on(True, **counts)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """(least ms the card could take, what bounds it): the larger of the
    operations at ``peak`` (the bf16 tensor-core rate unless given) and the
    bytes at the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def packed_bytes(p) -> int:
    return nbytes(p.packed, p.scale, p.offset, p.points, p.bias)


def phase_device():
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(2)
    smi = graft_entry.card_line()
    print(smi, flush=True)
    dev = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    emit({"phase": "device", **dev, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return dev, smi


TC_KERNELS = ("dequant_matmul_tc_kernel", "topk_tc_kernel", "topk_tc_stream_kernel")


def ptxas_faults(log: str) -> tuple:
    """From one ``nvcc -Xptxas -v`` log: the warnings that wgmma was
    serialized (C7518), and the tensor-core functions with spill stores."""
    serialized = [line.strip() for line in log.splitlines()
                  if "C7518" in line or ("wgmma" in line and "serialized" in line)]
    spills, fn = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn and int(m.group(1)) > 0 and any(k in fn for k in TC_KERNELS):
            spills.append(f"{fn[:80]}: {m.group(1)} bytes")
    return serialized, spills


def phase_build(checks):
    """Builds every library (anew, so that each compiler log is read) and
    fails on a serialized wgmma or a spilling tensor-core instance; then
    the host codec (``csrc/qdt_native.cpp``, ``g++``)."""
    logs = _build.build_all(force=True)
    _build.load_host("qdt_native")
    ptxas = [
        f"{name}: {line.split('ptxas info    : ')[-1]}"
        for name, log in logs.items()
        for line in log.splitlines()
        if "registers" in line
    ]
    faults = {}
    for name in ("dequant_matmul", "topk_fused"):
        serialized, spills = ptxas_faults(logs.get(name, ""))
        checks.require(name in logs, f"build: no compiler log for {name}")
        checks.require(not serialized, f"build: ptxas serialized wgmma in {name}: {serialized[:2]}")
        checks.require(not spills, f"build: spill stores in tensor-core instances: {spills[:4]}")
        faults[name] = {"wgmma_serialized": len(serialized), "tc_spilling": len(spills)}
    emit({"phase": "build", "built": sorted(logs), "faults": faults, "ptxas": ptxas})


def cuobjdump() -> str:
    """cuobjdump beside nvcc, else the copy in Triton's package."""
    cands = [Path(_build._nvcc()).parent / "cuobjdump"]
    try:
        import triton

        cands.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    for cand in cands:
        if cand.exists():
            return str(cand)
    raise FileNotFoundError("cuobjdump not found beside nvcc or in triton/backends/nvidia/bin")


# library → (names of its bf16-compute pass instances, name of its f32 instances)
SASS_LIBS = {
    "dequant_matmul": (("dequant_matmul_tc_kernel",), "dequant_matmul_kernel"),
    "topk_fused": (("topk_tc_kernel", "topk_tc_stream_kernel"), "topk_partial_kernel"),
}


def phase_sass(checks):
    """Tensor cores, shown in the machine code: HGMMA (wgmma) and HMMA
    (mma.sync) instructions in each instance of the dequant-matmul and
    fused-generator libraries. Every bf16-compute instance
    (dequant_matmul_tc_kernel; the generator's pass 1, topk_tc_kernel and
    topk_tc_stream_kernel) must hold at least one, the f32 instances
    (dequant_matmul_kernel, topk_partial_kernel) none."""
    try:
        tool = cuobjdump()
    except FileNotFoundError as e:
        checks.require(False, str(e))
        return
    for name, (tc_names, f32_name) in SASS_LIBS.items():
        lib = _build._lib_path(name)
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        found = []
        for part in sass.split("Function : ")[1:]:
            fn = part.split("\n", 1)[0].strip()
            found.append({"function": fn, "HGMMA": part.count("HGMMA"),
                          "HMMA": len(re.findall(r"\bHMMA\b", part)),
                          "tensor_core": any(k in fn for k in tc_names)})
        tc = [f for f in found if f["tensor_core"]]
        f32 = [f for f in found if f32_name in f["function"]]
        checks.require(len(tc) > 0 and len(f32) > 0,
                       f"sass {name}: {len(tc)} bf16 and {len(f32)} f32 instances")
        for f in tc:
            checks.require(f["HGMMA"] + f["HMMA"] > 0,
                           f"sass: no tensor-core instruction in {f['function']}")
        for f in f32:
            checks.require(f["HGMMA"] + f["HMMA"] == 0,
                           f"sass: tensor-core instruction in {f['function']}")
        emit({"phase": "sass", "tool": tool, "library": lib.name,
              "bf16_instances": len(tc), "f32_instances": len(f32),
              "hgmma_per_bf16_instance": sorted({f["HGMMA"] for f in tc}),
              "tensor_core_instructions_in_f32_instances": sum(f["HGMMA"] + f["HMMA"] for f in f32),
              "instances": [[f["function"][:60], f["HGMMA"], f["HMMA"]] for f in found]})


def kernel_dequant_matmul(checks, name, replaces, dec, rows, gen, lut_bits=()):
    """The dequant-matmul kernel at the three decode-step shapes of ``dec``
    against its plain version (f32 and bf16 compute; with ``lut_bits``, also
    each matrix repacked with a random codebook of those bits), and at the
    ragged shape RAGGED (2/4/8 bits, x f32 and bf16, bias set; codebooks when
    ``lut_bits`` is given); every check at F32_TOL, bf16 compute too. At
    bf16, per decode shape: the tile plan, device time (CUDA graph) against
    the plain version and bf16 ``torch.matmul`` on the dequantized weight,
    achieved TFLOP/s and share of the bound. Returns the kernel-table row,
    summed over one decode step."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    dm = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0, flops=0.0, bytes=0.0)
    shapes, errs = [], {}
    for mat, p, xdt in decode_matrices(dec):
        k, n = p.shape
        x = torch.randn(rows, k, generator=gen).to(dev, xdt)
        variants = [(p.bits, p)] + [
            (b, pack_linear(dequantize_linear(p), b, points=lut_points(b, gen).to(dev)))
            for b in lut_bits if b != p.bits]
        for bits, q in variants:
            err = check_dequant_matmul(checks, f"{name}/{mat}/{bits}", x, q)
            errs.update({f"{mat}/{bits}/{cd}": e for cd, e in err.items()})
            if q is p:
                dm["err"] = max(dm["err"], err[str(bf16)])
        w16 = dequantize_linear(p, bf16)
        ms = graph_ms(lambda: dequant_matmul(x, p, compute_dtype=bf16))
        plain = graph_ms(lambda: dequant_matmul_reference(x, p, compute_dtype=bf16))
        lib = graph_ms(lambda: torch.matmul(x.to(bf16), w16))
        flops = 2.0 * rows * k * n
        byt = nbytes(x) + packed_bytes(p) + rows * n * 4
        bms, by = bound(flops, byt)
        shapes.append({"name": mat, "M": rows, "K": k, "N": n, "x": str(xdt),
                       "plan": dequant_matmul_plan(x, p), "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bms, "bound_by": by,
                       "tflops": flops / (ms * 1e-3) / 1e12, "share_of_bound": bms / ms,
                       "flops": flops, "bytes": byt})
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bms), ("flops", flops), ("bytes", byt)):
            dm[key] += val
    m, k, n = RAGGED
    for bits in (2, 4, 8):
        w = torch.randn(k, n, generator=gen)
        pts = lut_points(bits, gen) if lut_bits else None
        q = pack_linear(w, bits, bias=torch.randn(n, generator=gen), points=pts).to(dev)
        for xdt in (torch.float32, bf16):
            x = torch.randn(m, k, generator=gen).to(dev, xdt)
            err = check_dequant_matmul(checks, f"{name}/ragged {m}x{k}x{n}/{bits}/{xdt}", x, q)
            errs.update({f"ragged/{bits}/{xdt}/{cd}": e for cd, e in err.items()})
    _, by = bound(dm["flops"], dm["bytes"])
    emit({"phase": "kernel", "name": name, "per_shape": shapes, "max_abs_err": errs,
          "ragged": {"M": m, "K": k, "N": n, "bits": [2, 4, 8], "bias": True},
          "per_step": {"flops": dm["flops"], "bytes": dm["bytes"], "ms": dm["ms"],
                       "library_ms": dm["library_ms"]}})
    return {
        "name": name, "route": "cuda", "source": SRC + "dequant_matmul.cu",
        "replaces": replaces, "max_abs_err": dm["err"],
        "ms": dm["ms"], "plain_ms": dm["plain_ms"], "bound_ms": dm["bound_ms"],
        "bound_by": by, "library_ms": dm["library_ms"],
        "design": DESIGN,
        "per": "one decode step: lstm_0 + lstm_1 + attn_out",
    }


def ragged_topk(checks, name, gen, lut: bool) -> dict:
    """The generator at M = 77, N = 700 and K = 200 and 77 (x rows off
    16-byte alignment at K = 77): 2/4/8 bits, x f32 and bf16, both compute
    types, k = 5; with ``lut``, each packed with a random codebook (edge
    padding masked by the kernel)."""
    m, _, n = RAGGED
    out = {}
    for k in RAGGED_TOPK_K:
        for bits in (2, 4, 8):
            pts = lut_points(bits, gen) if lut else None
            q = pack_linear(torch.randn(k, n, generator=gen), bits,
                            bias=torch.randn(n, generator=gen), points=pts).to("cuda")
            for xdt in (torch.float32, torch.bfloat16):
                x = torch.randn(m, k, generator=gen).to("cuda", xdt)
                for cd in (torch.float32, torch.bfloat16):
                    out[f"{k}/{bits}/{xdt}/{cd}"] = check_topk(
                        checks, f"{name}/ragged {m}x{k}x{n}/{bits}/{xdt}", x, q, 5, cd)["max_abs_err"]
    return out


def kernel_topk(checks, name, replaces, g, rows, gen, extra: dict) -> dict:
    """The fused generator kernel on the generator ``g`` against its plain
    version (f32 and bf16 compute, see check_topk), at the ragged shapes,
    and timed at bf16 against the plain version and one PyTorch call (bf16
    matmul + bias, ``torch.topk``, ``torch.logsumexp``), with its plan,
    TFLOP/s and share of the bound. ``extra`` joins the printed line.
    Returns the kernel-table row."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    k_top = 5
    x = torch.randn(rows, g.shape[0], generator=gen).to(dev)
    stats = {str(cd): check_topk(checks, name, x, g, k_top, cd) for cd in (torch.float32, bf16)}
    ragged = ragged_topk(checks, name, gen, g.points is not None)
    g16 = dequantize_linear(g, bf16)
    bias = g.bias

    def library():
        logits = torch.matmul(x.to(bf16), g16).float() + bias
        return torch.topk(logits, k_top), torch.logsumexp(logits, dim=-1)

    ms = graph_ms(lambda: dequant_matmul_topk(x, g, k_top, compute_dtype=bf16))
    plain = graph_ms(lambda: dequant_matmul_topk_reference(x, g, k_top, compute_dtype=bf16),
                     calls=5)
    lib = graph_ms(library)
    flops = 2.0 * rows * g.shape[0] * g.shape[1]
    byt = nbytes(x) + packed_bytes(g) + rows * (k_top * 8 + 4)
    bms, by = bound(flops, byt)
    emit({"phase": "kernel", "name": name, "M": rows, "K": g.shape[0], "N": g.shape[1],
          "N_padded": g.n_padded, "k": k_top, "checks": stats, "ragged_max_abs_err": ragged,
          "plan": dequant_matmul_topk_plan(x, g), "ms": ms, "library_ms": lib,
          "tflops": flops / (ms * 1e-3) / 1e12, "share_of_bound": bms / ms,
          "flops": flops, "bytes": byt, **extra})
    return {
        "name": name, "route": "cuda", "source": SRC + "topk_fused.cu", "replaces": replaces,
        "max_abs_err": stats[str(bf16)]["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "design": DESIGN_TOPK,
    }


def phase_kernels(checks, dec, rows, gen):
    """Each serving kernel at the main path's shapes against its plain version."""
    dev = torch.device("cuda")
    table = [kernel_dequant_matmul(checks, "dequant_matmul", JAXK + "dequant_matmul.py:68",
                                   dec, rows, gen)]

    # tie-heavy: zero weights make the logits the bias exactly, full of ties
    g = dec.generator
    tie_bias = torch.randint(0, 4, (g.shape[1],), generator=gen).float()
    gt = pack_linear(torch.zeros(g.shape), 4, bias=tie_bias, max_group=g.group).to(dev)
    x = torch.randn(rows, g.shape[0], generator=gen).to(dev)
    v, i, _ = dequant_matmul_topk(x, gt, 5, compute_dtype=torch.bfloat16)
    rv, ri, _ = dequant_matmul_topk_reference(x, gt, 5, compute_dtype=torch.bfloat16)
    checks.require(torch.equal(i, ri) and torch.equal(v, rv), "topk/ties: not exact")
    ties = {"rows_equal": int((i == ri).all(dim=1).sum())}
    table.append(kernel_topk(checks, "dequant_matmul_topk", JAXK + "topk_fused.py:78", g,
                             rows, gen, {"ties": ties}))

    # --- beam combine: [B, beam * kc] candidates as the beam core builds them
    k_top = 5
    b = rows // k_top
    n = k_top * k_top
    cand = torch.randn(b, n, generator=gen) * 10
    cand[torch.rand(b, n, generator=gen) < 0.3] = -1e9  # finished-beam blocks
    cand[:, 3] = cand[:, 7]  # exact ties
    cand = cand.to(dev)
    tok = torch.randint(0, 32000, (b, n), generator=gen, dtype=torch.int32).to(dev)
    got = beam_combine_topk(cand, tok, k_top)
    want = beam_combine_topk_reference(cand, tok, k_top)
    exact = all(torch.equal(a, c) for a, c in zip(got, want))
    checks.require(exact, "beam_combine: not bit-exact")
    ms = graph_ms(lambda: beam_combine_topk(cand, tok, k_top), calls=100)
    plain = graph_ms(lambda: beam_combine_topk_reference(cand, tok, k_top), calls=100)
    lib = graph_ms(lambda: torch.topk(cand, k_top), calls=100)
    flops, byt = float(b * n * k_top), nbytes(cand, tok) + b * k_top * 12
    bms, by = bound(flops, byt)
    emit({"phase": "kernel", "name": "beam_combine_topk", "B": b, "n": n, "k": k_top,
          "bit_exact": exact, "flops": flops, "bytes": byt})
    table.append({
        "name": "beam_combine_topk", "route": "cuda", "source": SRC + "beam_combine.cu",
        "replaces": JAXK + "beam_combine.py:41",
        "max_abs_err": float((got[0] - want[0]).abs().max()),
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "note": "the JAX public function's counterpart; on the main path beam_advance "
                "does its work",
    })
    table.append(kernel_beam_advance(checks, b, k_top, gen))
    return table


def kernel_beam_advance(checks, b, k, gen) -> dict:
    """The beam-advance kernel against its plain version, bit-exact in every
    output (the new beam state, the history rows, the flat parent rows): at
    the serving shape (b sentences, k beams, k candidates a beam) at the
    first and last step, and at K in {1, 3, 5, 8} with kc = K and kc > K on
    37 sentences; in the engine's form (``pos`` on the device, an
    ``active`` mask) at the serving shape; timed at the serving shape
    against the plain version, in both forms. No single PyTorch call
    computes a beam advance: no library time."""
    t_max = 24
    cases = [(b, k, k, 0), (b, k, k, t_max - 1)] + [
        (37, kk, kc, t) for kk, kc in ((1, 1), (1, 3), (3, 3), (3, 5), (5, 5), (5, 8), (8, 8))
        for t in (0, t_max - 1)]
    exact = {f"B{bb}/K{kk}/kc{kc}/t{t}": check_advance(checks, "beam_advance", bb, kk, kc, t,
                                                       t_max, gen)
             for bb, kk, kc, t in cases}
    # the engine's form: the ring row in device memory and an active mask
    for pos, share in ((0, 0.5), (t_max - 1, 0.5), (t_max - 1, 0.0), (0, 1.0)):
        cand, state = advance_inputs(b, k, k, t_max, gen)
        mine, ref = [x.clone() for x in state], [x.clone() for x in state]
        eng = dict(pos=torch.tensor([pos], dtype=torch.int32, device="cuda"),
                   active=(torch.rand(b, generator=gen) < share).cuda())
        rows = beam_advance(*cand, *mine, eos_id=EOS, pad_id=PAD, **eng)
        want = beam_advance_reference(*cand, *ref, eos_id=EOS, pad_id=PAD, **eng)
        ok = torch.equal(rows, want) and all(torch.equal(x, y) for x, y in zip(mine, ref))
        exact[f"B{b}/K{k}/kc{k}/pos{pos}/active{share}"] = ok
        checks.require(ok, f"beam_advance engine form pos={pos} active={share}: not bit-exact")
    cand, state = advance_inputs(b, k, k, t_max, gen)
    mine, ref = [x.clone() for x in state], [x.clone() for x in state]
    ms = graph_ms(lambda: beam_advance(*cand, *mine, t_max - 1, eos_id=EOS, pad_id=PAD),
                  calls=100)
    engine_ms = graph_ms(lambda: beam_advance(*cand, *mine, eos_id=EOS, pad_id=PAD, **eng),
                         calls=100)
    plain = graph_ms(lambda: beam_advance_reference(*cand, *ref, t_max - 1, eos_id=EOS,
                                                     pad_id=PAD), calls=100)
    n = k * k
    scores, finished, lengths, last = state[:4]
    flops = float(b * (2 * n + k * n))  # candidate scores, then k rounds of compares
    byt = nbytes(*cand) + 2 * nbytes(scores, finished, lengths) + nbytes(last) + b * k * (4 + 1 + 8)
    bms, by = bound(flops, byt, PEAK_F32)
    emit({"phase": "kernel", "name": "beam_advance", "B": b, "K": k, "kc": k,
          "bit_exact": exact, "flops": flops, "bytes": byt, "ms": ms, "plain_ms": plain,
          "engine_form_ms": engine_ms})
    return {
        "name": "beam_advance", "route": "cuda", "source": SRC + "beam_combine.cu",
        "replaces": JAXK + "beam_combine.py:41", "max_abs_err": 0.0 if all(exact.values())
        else float("inf"), "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "engine_form_ms": engine_ms,
        "library_ms": None, "library": "no single PyTorch call computes a beam advance",
        "design": "one launch a decode step: candidate scores, top-K and bookkeeping, "
                  "one warp a sentence",
    }


def phase_main_path(checks, args, model, params, smi):
    """The packed serving search at full width (see the module docstring,
    phase 4)."""
    dev = torch.device("cuda")
    cfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    src, src_len = serve_inputs(args)
    group = pick_generator_group(args.batch * args.beam)
    dec = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.bfloat16,
                       generator_group=group, device=dev)

    steps = cfg.max_len
    want = expected(dequant_matmul=3 * steps, dequant_matmul_topk=steps, beam_advance=steps)
    # the encoder's LSTM: one cell launch a layer and source position
    want_cells = {"lstm_cell": len(model.encoder.cells) * src.shape[1], "lstm_cell_backward": 0}
    for call in ("capture", "replay"):  # the first call captures the graph, then replays it
        zero_counts()
        toks, scores = beam_search_packed(model, dec, src, src_len, cfg, device=dev)
        launches, cells = read_counts(), cell_counts()
        checks.require(launches == want, f"main path launches ({call}) {launches}, expected {want}")
        checks.require(cells == want_cells,
                       f"main path cell launches ({call}) {cells}, expected {want_cells}")
    checks.require(tuple(toks.shape) == (args.batch, steps), f"tokens shape {tuple(toks.shape)}")
    checks.require(bool(torch.isfinite(scores).all()), "main path scores not finite")
    checks.require(bool(((toks >= 0) & (toks < args.vocab)).all()), "token ids out of range")

    # f32: the graph against the eager loop on the card and the CPU plain versions
    ns = args.cpu_sentences
    dec32 = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.float32,
                         generator_group=group, device=dev)
    g_toks, g_scores = beam_search_packed(model, dec32, src[:ns], src_len[:ns], cfg, device=dev)
    e_toks, e_scores = beam_search_packed(model, dec32, src[:ns], src_len[:ns], cfg, device=dev,
                                          _eager=True)
    graph_eq = torch.equal(g_toks, e_toks) and torch.equal(g_scores, e_scores)
    checks.require(graph_eq, "f32 graphed search differs from the eager loop on the card")
    cpu_model = make_seq2seq(args.preset, args.vocab, args.vocab, device="cpu", seed=args.seed)
    dec_cpu = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.float32,
                           generator_group=group, device="cpu")
    c_toks, c_scores = beam_search_packed(cpu_model, dec_cpu, src[:ns], src_len[:ns], cfg,
                                          device="cpu")
    tok_equal = torch.equal(g_toks.cpu(), c_toks)
    checks.require(tok_equal, "f32 tokens on the card differ from the CPU plain path")
    score_err = float((g_scores.cpu() - c_scores).abs().max())
    emit({
        "phase": "main_path", "preset": args.preset, "vocab": args.vocab, "batch": args.batch,
        "beam": args.beam, "max_len": steps, "bits": args.bits, "generator_group": group,
        "launches": launches, "cell_launches": cells, "f32_graph_equals_eager": graph_eq,
        "f32_tokens_equal_cpu": tok_equal, "f32_sentences": ns,
        "f32_score_max_abs_diff": score_err, "card": smi,
    })


def quantizable_buckets(params, spec: QuantSpec) -> torch.Tensor:
    """Every quantizable flax leaf bucketed on its own and concatenated, as
    the train step hands them to the fake-quant kernel."""
    return torch.cat([
        to_buckets(leaf.detach().contiguous(), spec.bucket_size)[0]
        for path, leaf in flax_leaves(params) if is_quantizable(path, leaf, spec)
    ])


def phase_train_kernel(checks, student, gen) -> dict:
    """The fake-quant kernel at the train step's shape against its plain
    version: bit-exact, so the tolerance is 0."""
    buckets = quantizable_buckets(dict(student.named_parameters()), QuantSpec(bits=4))
    exact = {}
    for bits in (2, 4, 8):
        for scaling in ("linear", "absmax"):
            got = fake_quant_buckets(buckets, bits, scaling=scaling)
            want = fake_quant_buckets_reference(buckets, bits, scaling=scaling)
            exact[f"{bits}/{scaling}"] = ok = torch.equal(got, want)
            checks.require(ok, f"fake_quant {bits}-bit {scaling}: not bit-exact")
    flat = torch.cat([torch.full((64, 256), 3.25), torch.zeros(64, 256),
                      torch.randn(64, 256, generator=gen)]).cuda()
    for scaling in ("linear", "absmax"):
        got = fake_quant_buckets(flat, 4, scaling=scaling)
        ok = torch.equal(got, fake_quant_buckets_reference(flat, 4, scaling=scaling))
        exact[f"degenerate/{scaling}"] = ok
        checks.require(ok, f"fake_quant degenerate buckets {scaling}: not bit-exact")
    checks.require(torch.equal(fake_quant_buckets(flat[:128], 4), flat[:128]),
                   "fake_quant: constant or zero buckets changed")
    ms = graph_ms(lambda: fake_quant_buckets(buckets, 4))
    plain = graph_ms(lambda: fake_quant_buckets_reference(buckets, 4))
    n = buckets.numel()
    flops, byt = 8.0 * n, 2 * nbytes(buckets)
    bms, by = bound(flops, byt, PEAK_F32)
    emit({"phase": "kernel", "name": "fake_quant_buckets", "n_buckets": buckets.shape[0],
          "bucket_size": buckets.shape[1], "bit_exact": exact, "flops": flops, "bytes": byt,
          "achieved_bytes_per_s": byt / (ms * 1e-3)})
    return {
        "name": "fake_quant_buckets", "route": "cuda", "source": SRC + "fake_quant.cu",
        "replaces": JAXK + "fake_quant.py:39", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library": "no single PyTorch call computes bucketed min/max fake-quant",
    }


GROUPED_TOKENS = 16384  # the dsv2lite cell's tokens a step (4 x 4096), 6 pairs each
GROUPED_SIZES = [2900, 0, 4100, 17, 1, 1500, 3001, 900]  # 8 held experts' rows
GROUPED_RTOL, GROUPED_ATOL = 1e-5, 2e-5  # f32 sums in another order; atol x max |value|


def phase_grouped_kernel(checks, seed: int) -> dict:
    """The grouped expert matmul at the DeepSeek-V2 cell's shapes (phase 6):
    each direction's forward, data gradient and weight gradient against
    the plain versions (``grouped_matmul_reference``, ``grouped_wgrad_
    reference``) on the same inputs, the discard rows, the covered rows,
    the launches; then device ms."""
    from quantized_distillation_tpu_torch.kernels.grouped_matmul import grouped_wgrad_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t, p, hidden, width = GROUPED_TOKENS, 6 * GROUPED_TOKENS, 2048, 1408
    held = sum(GROUPED_SIZES)
    offsets = torch.tensor([0, *itertools.accumulate(GROUPED_SIZES)], dtype=torch.int64,
                           device=dev)
    rows = torch.randint(0, t, (p,), generator=gen, device=dev)
    result = {}
    for name, k, n, gather in (("gate", hidden, width, True), ("down", width, hidden, False)):
        x = torch.randn(t if gather else p, k, generator=gen, device=dev)
        w = torch.randn(len(GROUPED_SIZES), k, n, generator=gen, device=dev) / k ** 0.5
        dy = torch.randn(p, n, generator=gen, device=dev)
        r = rows if gather else None
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        covered = torch.zeros(len(GROUPED_SIZES), dtype=torch.int64, device=dev)
        zero_counts()
        y = grouped_matmul(xg, r, wg, offsets, covered)
        y.backward(dy)
        counts = read_counts()
        checks.require(counts == expected(grouped_matmul=2, grouped_matmul_wgrad=1),
                       f"grouped_matmul {name}: launches {counts}")
        checks.require(covered.tolist() == GROUPED_SIZES,
                       f"grouped_matmul {name}: covered {covered.tolist()}")
        checks.require(not y[held:].any(), f"grouped_matmul {name}: discard rows written")
        dxp = grouped_matmul_reference(dy, None, w.transpose(1, 2), offsets)
        want = {"forward": grouped_matmul_reference(x, r, w, offsets),
                "dgrad": dxp if r is None else torch.zeros_like(x).index_add_(0, r, dxp),
                "wgrad": grouped_wgrad_reference(x, r, dy, offsets, w.shape)}
        errs = {}
        for part, got in (("forward", y.detach()), ("dgrad", xg.grad), ("wgrad", wg.grad)):
            scale = float(want[part].abs().max())
            errs[part] = float((got - want[part]).abs().max()) / scale
            ok = torch.allclose(got, want[part], rtol=GROUPED_RTOL, atol=GROUPED_ATOL * scale)
            checks.require(ok, f"grouped_matmul {name} {part}: max error {errs[part]:.3g} "
                               "of the largest |value|")

        xt, wt = x.detach().requires_grad_(), w.detach().requires_grad_()

        def both():  # returns the gradients: no AccumulateGrad outside the capture
            return torch.autograd.grad(grouped_matmul(xt, r, wt, offsets), (xt, wt), dy)

        fwd_ms = graph_ms(lambda: grouped_matmul(x, r, w, offsets), calls=5)
        both_ms = graph_ms(both, calls=5)
        flops = 2.0 * held * k * n
        result[name] = {"k": k, "n": n, "gather": gather, "rel_err": errs,
                        "forward_ms": fwd_ms, "forward_tflops": flops / fwd_ms * 1e-9,
                        "forward_f32_peak_share": flops / (fwd_ms * 1e-3) / PEAK_F32,
                        "fwd_bwd_ms": both_ms,
                        "fwd_bwd_f32_peak_share": 3 * flops / (both_ms * 1e-3) / PEAK_F32}
        del x, w, dy, xg, wg, xt, wt, y, want, dxp
    emit({"phase": "kernel", "name": "grouped_matmul", "tokens": t, "pairs": p, "held": held,
          "sizes": GROUPED_SIZES, **result})
    return result


# (rows, width of h, cell width W): the students at the nmt buckets' batches
# and the LM's, the nmt teacher's 500 (float4 path) and the LM teacher's 650
# (the scalar path), a tensor-parallel shard (64 of 256 over 4)
LSTM_SHAPES = [(256, 256, 256), (128, 256, 256), (64, 256, 256), (256, 500, 500),
               (128, 500, 500), (64, 500, 500), (256, 650, 650), (256, 256, 64)]
LSTM_T = 35  # steps of the [B, T, 4W] product each call's xw is a slice of


def _cell_grads(fn, inputs, dc, dh):
    """``fn``'s (c', h') on ``inputs`` (wh, bh, c, h, a [B, T, 4W] product
    sliced at one step) and the gradients of all five, ``dc``/``dh`` None
    where that output takes no part."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    wh, bh, c, h, xw_all = leaves
    c_new, h_new = fn(wh, bh, c, h, xw_all[:, 1])
    sum((y * d).sum() for y, d in ((c_new, dc), (h_new, dh)) if d is not None).backward()
    return [c_new.detach(), h_new.detach()] + [t.grad for t in leaves]


def _composite_gates(wh, bh, c, h, xw):
    return lstm_cell_reference(h @ wh, bh, xw, c)


def lstm_cell_shape(checks, key, b, hidden, width, gen) -> dict:
    """The cell at one shape against the composite on the card: values with
    and without autograd, the gradients with both outputs and with either
    absent, random and saturating inputs; then device ms a call."""
    dev = torch.device("cuda")
    rec = {}
    for kind, scale in (("random", 1.0), ("saturating", 20.0)):
        inputs = [torch.randn(hidden, 4 * width, generator=gen, device=dev) / hidden ** 0.5,
                  torch.randn(4 * width, generator=gen, device=dev),
                  scale * torch.randn(b, width, generator=gen, device=dev),
                  torch.randn(b, hidden, generator=gen, device=dev),
                  scale * torch.randn(b, LSTM_T, 4 * width, generator=gen, device=dev)]
        wh, bh, c, h, xw_all = inputs
        with torch.no_grad():
            zero_counts()
            got = lstm_gates(wh, bh, c, h, xw_all[:, 1])
            calls = cell_counts()
            want = _composite_gates(wh, bh, c, h, xw_all[:, 1])
        plain_equal = all(map(torch.equal, got, want))
        checks.require(plain_equal, f"lstm_cell {key} {kind}: forward without autograd differs "
                                    "from the composite")
        checks.require(calls == {"lstm_cell": 1, "lstm_cell_backward": 0},
                       f"lstm_cell {key}: launches without autograd {calls}")
        grads = {}
        for outputs in ("both", "h_only", "c_only"):
            dc = torch.randn(b, width, generator=gen, device=dev) if outputs != "h_only" else None
            dh = torch.randn(b, width, generator=gen, device=dev) if outputs != "c_only" else None
            zero_counts()
            got = _cell_grads(lstm_gates, inputs, dc, dh)
            calls = cell_counts()
            want = _cell_grads(_composite_gates, inputs, dc, dh)
            equal = dict(zip(["c", "h", "d_wh", "d_bh", "d_c", "d_h", "d_xw"],
                             (torch.equal(g, w) for g, w in zip(got, want))))
            tag = f"lstm_cell {key} {kind} {outputs}"
            checks.require(all(equal.values()), f"{tag}: differs from the composite: {equal}")
            checks.require(calls == {"lstm_cell": 1, "lstm_cell_backward": 1},
                           f"{tag}: launches {calls}")
            grads[outputs] = equal
        rec[kind] = {"no_grad_bit_equal": plain_equal, "autograd_bit_equal": grads}

    # device ms a call: the pointwise part alone (the product is the same
    # torch.matmul on both sides), then with its backward
    hw = (h @ wh).detach()
    xw = xw_all[:, 1]
    leaves = [t.detach().clone().requires_grad_() for t in (hw, bh, xw_all, c)]
    dc, dh = torch.randn(b, width, generator=gen, device=dev), torch.randn(b, width, generator=gen,
                                                                           device=dev)

    def both(fn):
        hw_, bh_, xa_, c_ = leaves
        return torch.autograd.grad(fn(hw_, bh_, xa_[:, 1], c_), leaves, (dc, dh))

    # the yardstick: PyTorch's fused cell of nn.LSTMCell (takes both biases)
    xw_c, zero_b = xw.contiguous(), torch.zeros_like(bh)
    ms = {"forward": graph_ms(lambda: lstm_cell(hw, bh, xw, c)),
          "plain_forward": graph_ms(lambda: lstm_cell_reference(hw, bh, xw, c)),
          "library_forward": graph_ms(
              lambda: torch.ops.aten._thnn_fused_lstm_cell(xw_c, hw, c, bh, zero_b)),
          "forward_backward": graph_ms(lambda: both(lstm_cell)),
          "plain_forward_backward": graph_ms(lambda: both(lstm_cell_reference))}
    # bytes a call reads and writes once: hw, xw, c and bh in, c' and h' out
    # (forward); the saved gates and tanh(c') out and back in, c, dh, dc in,
    # dz and dc out (the backward)
    fwd_bytes = 4 * (b * 9 * width + 4 * width + b * 2 * width)
    both_bytes = fwd_bytes + 4 * b * (5 * width + 5 * width + 3 * width + 5 * width)
    rec["device_ms"] = ms
    rec["bound_ms"] = {"forward": fwd_bytes / HBM * 1e3, "forward_backward": both_bytes / HBM * 1e3}
    return rec


def kd_cell_launches(checks, label, task, tx, state, batch, quant, seed, fwd, bwd) -> dict:
    """Two calls of the graphed KD step (capture, then a replay) with the
    counters zeroed: ``fwd`` forward and ``bwd`` backward cell launches a
    step, one fake-quant launch."""
    step = make_train_step(task, tx, quant=quant, distill=DistillSpec(), device="cuda")
    zero_counts()
    for _ in range(2):
        state, m = step(state, batch, seed)
    cells, path = cell_counts(), read_counts()
    want = {"lstm_cell": 2 * fwd, "lstm_cell_backward": 2 * bwd}
    checks.require(cells == want and path == expected(fake_quant_buckets=2),
                   f"{label} KD step launches {cells} {path}, expected {want} and 2 fake-quant")
    checks.require(step.captures == 1 and math.isfinite(float(m["loss"])),
                   f"{label} KD step: {step.captures} captures, loss {float(m['loss'])}")
    return {"steps": 2, "cell_launches": cells, "per_step": {"forward": fwd, "backward": bwd}}


def phase_lstm_kernel(checks, args) -> dict:
    """The LSTM cell kernels (phase 6, see the module docstring)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    shapes = {}
    for b, hidden, width in LSTM_SHAPES:
        key = f"{b}x{width}" + ("" if hidden == width else f"_of_{hidden}")
        shapes[key] = lstm_cell_shape(checks, key, b, hidden, width, gen)
    quant = QuantSpec(bits=args.bits)
    tx = build_optimizer(TrainConfig(learning_rate=1e-3, clip_norm=5.0))

    # seq2seq at phase 7's shape: source and target of src_len, every cell
    # of student and teacher forward, the student's backward
    student, task, batch = kd_setup(args, dev, args.train_batch, args.seed + 60)
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant, device=dev)
    layers = (SEQ2SEQ_PRESETS[args.preset]["num_layers"], SEQ2SEQ_PRESETS["teacher"]["num_layers"])
    cells = [2 * n * args.src_len for n in layers]  # encoder + decoder
    kd = {"seq2seq": kd_cell_launches(checks, "seq2seq", task, tx, state, batch, quant, args.seed,
                                      sum(cells), cells[0])}
    del student, task, state

    # the LM at phase 14's shape
    v, b = args.lm_vocab, args.lm_batch
    teacher = make_lm("teacher", v, device=dev, seed=args.seed + 61)
    student = make_lm("student_medium", v, device=dev, seed=args.seed + 62)
    task = lm_task(student, teacher, thread_carry=True, device=dev)
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                               carry=lm_initial_carry(student, b, teacher), device=dev)
    cells = [LM_PRESETS[p]["num_layers"] * args.lm_bptt for p in ("student_medium", "teacher")]
    kd["lm"] = kd_cell_launches(checks, "lm", task, tx, state,
                                lm_batch(b, v, args.lm_bptt, args.seed + 63, dev), quant,
                                args.seed, sum(cells), cells[0])
    del student, teacher, task, state
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "lstm_cell", "shapes": shapes, "kd_steps": kd})
    return {"shapes": shapes, "kd_steps": kd}


def kd_setup(args, device, batch_size, seed, dropout: float = 0.0):
    """Student (``dropout``), its KD task from a fresh teacher, and a
    bench.py-shaped synthetic batch."""
    v, L = args.vocab, args.src_len
    teacher = make_seq2seq("teacher", v, v, dropout=0.0, device=device, seed=seed)
    student = make_seq2seq(args.preset, v, v, dropout=dropout, device=device, seed=seed + 1)
    g = torch.Generator().manual_seed(seed + 2)
    batch = {
        "src": torch.randint(4, v, (batch_size, L), generator=g),
        "src_len": torch.full((batch_size,), L),
        "tgt_in": torch.randint(4, v, (batch_size, L), generator=g),
        "tgt_out": torch.randint(4, v, (batch_size, L), generator=g),
        "tgt_mask": torch.ones(batch_size, L),
    }
    return student, nmt_task(student, teacher, device=device), batch


def train_parity(checks, args, quant, distill, cfg, mode: str = "weights") -> dict:
    """One full-width seq2seq step at B = 8 on the card and on the CPU (see
    :func:`step_parity`)."""

    def setup(dev):
        student, task, batch = kd_setup(args, dev, args.parity_batch, args.seed + 20)
        tx = build_optimizer(cfg)
        return task, create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                        mode=mode, device=dev), tx

    batch = kd_setup(args, "cpu", args.parity_batch, args.seed + 20)[2]
    return step_parity(checks, f"train parity ({mode})", setup, [batch], quant, distill, mode)


def _leaves(tree) -> list:
    out = []
    map_tensors(out.append, tree)
    return out


@contextlib.contextmanager
def relu_masks(masks: list, replay: bool):
    """Inside, ``F.relu`` records the sign pattern of each output in
    ``masks`` (``replay`` False), or applies the recorded patterns in call
    order in place of its own (``replay`` True; the yielded list then
    counts the elements whose own sign differs, and the outputs). A ReLU
    network's gradient jumps where a pre-activation crosses 0: in the WRN
    step at B = 8 on an H100, a few outputs that rounded to the other side
    of 0 than on the CPU put the gradients 0.031 of a tensor's largest value
    apart, which no tolerance on rounding can hold (PERF.md). Replayed, the
    CPU differentiates the same piecewise-linear function the card did, and
    the flips are bounded instead (``RELU_FLIP_SHARE``)."""
    relu = torch.nn.functional.relu
    it, counts = iter(masks), [0, 0]  # flips, outputs

    def recording(x, inplace=False):
        y = relu(x)
        masks.append((y > 0).cpu())
        return y

    def replaying(x, inplace=False):
        m = next(it).to(x.device)
        counts[0] += int(((x > 0) != m).sum())
        counts[1] += m.numel()
        return torch.where(m, x, torch.zeros_like(x))

    torch.nn.functional.relu = replaying if replay else recording
    try:
        yield counts
    finally:
        torch.nn.functional.relu = relu


def step_parity(checks, label, setup, batches, quant, distill, mode: str = "weights") -> dict:
    """Train steps at a small batch on the card and on the CPU (plain
    versions) from the same weights (and codebooks, running statistics,
    carry), through the parts of the train step that runs
    (``make_train_step(..., _eager=True)``: ``prepare``, then the body's
    ``gradients`` and, on the card, its ``update``), so its gradients can be
    compared: loss, metrics, grad_norm and every gradient card against CPU;
    the new running statistics and carry card against CPU at W_RTOL /
    W_ATOL; then the card's updated tensors against the CPU optimizer
    applied to the card's gradients. (Adam's first step is lr * g / (|g| +
    eps), which turns gradient differences at the level of rounding into
    whole steps where |g| is near 0, so the two devices' own updated
    tensors are compared and reported, not held.) A later step starts both
    devices from the card's updated tensors, each with its own running
    statistics and carry, so the carry the card threads is held to the one
    the CPU threads. The CPU step takes the card's ReLU sign patterns
    (:func:`relu_masks`); the outputs whose own sign differs must be at
    most ``RELU_FLIP_SHARE`` of the ReLU outputs a step.
    ``setup(device) -> (task, state, tx)``; ``batches``: one batch a step."""
    runs = {}
    for dev in ("cuda", "cpu"):
        task, state, tx = setup(torch.device(dev))
        runs[dev] = [state, tx, make_train_step(task, tx, quant=quant, distill=distill,
                                                mode=mode, device=dev, _eager=True)]
    out = {"batch": next(iter(batches[0].values())).shape[0], "mode": mode,
           "steps": len(batches)}
    grad_rel = opt_err = own_err = stats_err = carry_err = 0.0
    own_over = flips = outputs = 0
    for i, batch in enumerate(batches):
        res, masks = {}, []
        for dev, (state, _, step) in runs.items():
            run = step.prepare(state, batch, 0)
            wrt = trainable(state.params, state.codebooks, mode)
            before = {n: p.detach().clone() for n, p in wrt.items()}
            with relu_masks(masks, replay=dev == "cpu") as counted:
                loss, metrics, grads, upd = step.gradients(run)
            res[dev] = (loss, metrics, grads, before, upd, run)
        step_flips, step_outputs = counted
        flips, outputs = flips + step_flips, outputs + step_outputs
        checks.require(step_flips <= RELU_FLIP_SHARE * step_outputs,
                       f"{label} step {i}: {step_flips} ReLU sign flips of {step_outputs} "
                       f"outputs, more than {RELU_FLIP_SHARE} of them")
        (gl, gmet, gg, _, gupd, grun), (cl, cmet, cg, cbefore, cupd, _) = res["cuda"], res["cpu"]
        gm = dict(gmet, loss=gl, grad_norm=global_norm(gg))
        for k, v in dict(cmet, loss=cl, grad_norm=global_norm(cg)).items():
            err = abs(float(gm[k]) - float(v))
            out[f"{k}_abs_diff"] = max(err, out.get(f"{k}_abs_diff", 0.0))
            checks.require(err <= LOSS_RTOL * abs(float(v)),
                           f"{label} step {i} {k}: card {float(gm[k])} vs cpu {float(v)}")
        gstate, _, gstep = runs["cuda"]
        cstate, ctx, _ = runs["cpu"]
        gstep.update(grun, gl, gmet, gg, gupd)  # the card's step, in place
        runs["cuda"][0], _ = gstep.finish(gstate, grun)
        gwrt = trainable(gstate.params, gstate.codebooks, mode)
        cwrt = trainable(cstate.params, cstate.codebooks, mode)
        g_card = {n: g.detach().cpu() for n, g in gg.items()}
        opt = cstate.opt_state  # the CPU optimizer's step on the card's gradients, on copies
        on_card, _ = ctx.update(g_card, opt._replace(mu=map_tensors(torch.clone, opt.mu),
                                                     nu=map_tensors(torch.clone, opt.nu)),
                                cbefore)
        own, new_opt = ctx.update(cg, opt, cbefore)
        for n, g_c in cg.items():
            scale = max(float(g_c.abs().max()), 1e-30)
            e = float((g_card[n] - g_c).abs().max())
            grad_rel = max(grad_rel, e / scale)
            checks.require(e <= GRAD_TOL * scale, f"{label} step {i} grad {n}: max abs diff {e}")
            w_card = gwrt[n].detach().cpu()
            tol = W_ATOL + W_RTOL * cbefore[n].abs()
            d_opt = (w_card - (cbefore[n] + on_card[n])).abs()
            opt_err = max(opt_err, float(d_opt.max()))
            checks.require(bool((d_opt <= tol).all()), f"{label} step {i} optimizer step {n}")
            d_own = (w_card - (cbefore[n] + own[n])).abs()
            own_err = max(own_err, float(d_own.max()))
            own_over += int((d_own > tol).sum())
            with torch.no_grad():
                cwrt[n].copy_(w_card)  # the next step starts from the card's tensors
        for key in ("batch_stats", "carry"):
            if key not in cupd:
                continue
            for g_t, c_t in zip(_leaves(gupd[key]), _leaves(cupd[key]), strict=True):
                d = (g_t.detach().cpu() - c_t.detach()).abs()
                if key == "batch_stats":
                    stats_err = max(stats_err, float(d.max()))
                else:
                    carry_err = max(carry_err, float(d.max()))
                checks.require(bool((d <= W_ATOL + W_RTOL * c_t.detach().abs()).all()),
                               f"{label} step {i}: {key} card vs cpu, max abs diff {float(d.max())}")
        if "batch_stats" in cupd:
            with torch.no_grad():
                for n, t in cstate.batch_stats.items():
                    t.copy_(cupd["batch_stats"][n])
        runs["cpu"][0] = cstate.replace(
            step=cstate.step + 1, opt_state=new_opt,
            carry=map_tensors(torch.Tensor.detach, cupd["carry"]) if "carry" in cupd
            else cstate.carry)
    out.update(
        grad_max_rel_diff=grad_rel, optimizer_step_max_abs_diff=opt_err,
        weights_max_abs_diff=own_err, weights_over_tolerance=own_over,
        weights=sum(t.numel() for t in cbefore.values()), relu_sign_flips=flips,
        relu_outputs=outputs, relu_flip_bound=RELU_FLIP_SHARE,
    )
    if runs["cpu"][0].batch_stats is not None:
        out["batch_stats_max_abs_diff"] = stats_err
    if runs["cpu"][0].carry is not None:
        out["carry_max_abs_diff"] = carry_err
    return out


def phase_train(checks, args, smi) -> tuple:
    """The full-width 4-bit STE KD train path (see the module docstring) →
    (the fake-quant kernel's row, the trained state)."""
    dev = torch.device("cuda")
    quant, distill = QuantSpec(bits=args.bits), DistillSpec()
    cfg = TrainConfig(learning_rate=1e-3, clip_norm=5.0)
    student, task, batch = kd_setup(args, dev, args.train_batch, args.seed + 10)
    row = phase_train_kernel(checks, student, torch.Generator().manual_seed(args.seed + 3))

    tx = build_optimizer(cfg)
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant, device=dev)
    step = make_train_step(task, tx, quant=quant, distill=distill, device=dev)
    eval_step = make_eval_step(task, quant=quant, device=dev)
    zero_counts()
    metrics = []
    for _ in range(args.train_steps):
        state, m = step(state, batch, args.seed)
        metrics.append(m)
    ev = eval_step(state, batch)
    launches = read_counts()
    loss = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    want = expected(fake_quant_buckets=args.train_steps + 1)
    checks.require(launches == want, f"train path launches {launches}, expected {want}")
    checks.require(all(map(math.isfinite, loss + gnorm)), "train loss or grad_norm not finite")
    checks.require(loss[-1] < loss[0], f"train loss did not fall: {loss[0]} -> {loss[-1]}")
    parity = train_parity(checks, args, quant, distill, cfg)
    emit({
        "phase": "train", "preset": args.preset, "teacher": "teacher", "vocab": args.vocab,
        "batch": args.train_batch, "len": args.src_len, "bits": args.bits, "steps": len(loss),
        "launches": launches, "loss": loss, "grad_norm": gnorm,
        "eval_nll_per_token": float(ev["nll_sum"]) / float(ev["n_tokens"]),
        "parity_cuda_vs_cpu": parity, "card": smi,
    })
    # the graphed step against the eager one, dropout on (the paper's 0.3)
    d_student, d_task, _ = kd_setup(args, dev, args.train_batch, args.seed + 10, dropout=0.3)
    d_tx = build_optimizer(cfg)
    d_state = create_train_state(dict(d_student.named_parameters()), d_tx, quant=quant,
                                 device=dev)
    graph_legs(checks, "train", d_task, d_tx, d_state, batch, args.seed, args, quant=quant,
               control=True)
    return row, state


def settle_joint(task, tx, step, state, batch, seed, quant, distill, cfg):
    """The joint state's updates after its counted steps, before its graphed
    step is checked and its codebooks are taken. Phases 11, 12, 16 and 18
    serve those codebooks, and phase 16 holds the card's f32 tokens from
    the file to the CPU path's exactly: these are the updates its codebooks
    have been held on (with the joint state's 10 counted steps alone, one
    of its 16 sentences parts at step 10). In this order: 7 rounds of two
    joint ``step`` calls and two FP32 steps on the same weights (joint
    first in even rounds, last in odd); 8 optimizer updates at the state's
    step count, from a step's stages run one by one (dropout from a
    generator seeded 0); 4 joint steps. Returns the state."""
    dev = torch.device("cuda")
    fp_state = create_train_state(state.params, build_optimizer(cfg), device=dev)
    fp_step = make_train_step(task, build_optimizer(cfg), quant=None, distill=distill, device=dev)
    holder = {"joint": state, "fp32": fp_state}
    for i in range(7):
        legs = (("joint", step), ("fp32", fp_step))
        for key, fn in legs[:: 1 if i % 2 == 0 else -1]:
            for _ in range(2):
                holder[key] = fn(holder[key], batch, seed)[0]
    state = holder["joint"]
    b = as_batch(batch, dev)
    wrt = trainable(state.params, state.codebooks, "joint")
    stats = state.batch_stats or {}
    drop = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(8):
        qp = quantized_params(state.params, quant, state.codebooks)
        logits, _ = task.student_forward({**qp, **stats}, b, True, drop)
        t_logits = task.teacher_forward(b) if task.teacher_forward else None
        loss, _ = task.loss_and_metrics(logits, t_logits, b, distill)
        grads = dict(zip(wrt, torch.autograd.grad(loss, list(wrt.values()))))
        apply_updates(wrt, tx.update(grads, state.opt_state, wrt)[0])
    for _ in range(4):
        state = step(state, batch, seed)[0]
    return state


def phase_codebook_train(checks, args, smi) -> dict:
    """Differentiable quantization at full width: a joint codebook KD run,
    its eval, card-vs-CPU parity at B = 8, the updates of
    :func:`settle_joint`, the graphed joint step against the eager one, and
    a 2-step ``codebooks`` run. Returns the trained codebooks. The JAX package runs no Pallas kernel on
    this path (its codebook fake-quant is plain XLA), and neither does the
    port: every launch counter must stay at 0."""
    dev = torch.device("cuda")
    quant, distill = QuantSpec(bits=args.bits, method="codebook"), DistillSpec()
    cfg = TrainConfig(learning_rate=1e-3, clip_norm=5.0)
    student, task, batch = kd_setup(args, dev, args.train_batch, args.seed + 30)
    tx = build_optimizer(cfg)
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant, mode="joint",
                               codebook_init="uniform", device=dev)
    w0 = {n: p.detach().clone() for n, p in state.params.items()}
    b0 = {n: b.detach().clone() for n, b in state.codebooks.items()}
    step = make_train_step(task, tx, quant=quant, distill=distill, mode="joint", device=dev)
    eval_step = make_eval_step(task, quant=quant, device=dev)
    zero_counts()
    metrics = []
    for _ in range(args.train_steps):
        state, m = step(state, batch, args.seed)
        metrics.append(m)
    ev = eval_step(state, batch)
    launches = read_counts()
    loss = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    checks.require(launches == expected(), f"codebook train launches {launches}, expected none")
    checks.require(all(map(math.isfinite, loss + gnorm)), "codebook loss or grad_norm not finite")
    checks.require(loss[-1] < loss[0], f"codebook loss did not fall: {loss[0]} -> {loss[-1]}")
    moved_w = sum(not torch.equal(state.params[n], w0[n]) for n in w0)
    moved_b = sum(not torch.equal(state.codebooks[n], b0[n]) for n in b0)
    checks.require(moved_w > 0 and moved_b > 0,
                   f"joint: {moved_w} weight tensors and {moved_b} codebooks moved")
    eval_nll = float(ev["nll_sum"]) / float(ev["n_tokens"])
    checks.require(math.isfinite(eval_nll), "codebook eval nll not finite")
    parity = train_parity(checks, args, quant, distill, cfg, mode="joint")
    state = settle_joint(task, tx, step, state, batch, args.seed, quant, distill, cfg)
    graph_legs(checks, "codebook_train", task, tx, state, batch, args.seed, args, quant=quant,
               mode="joint", fq_per_step=0)
    books = {n: b.detach().clone() for n, b in state.codebooks.items()}

    # differentiable quantization proper: weights frozen, codebooks trained
    cb_tx = build_optimizer(cfg)
    cb_state = create_train_state(state.params, cb_tx, quant=quant, mode="codebooks", device=dev)
    w1 = {n: p.detach().clone() for n, p in cb_state.params.items()}
    b1 = {n: b.detach().clone() for n, b in cb_state.codebooks.items()}
    cb_step = make_train_step(task, cb_tx, quant=quant, distill=distill, mode="codebooks",
                              device=dev)
    cb_loss = []
    for _ in range(2):
        cb_state, m = cb_step(cb_state, batch, args.seed)
        cb_loss.append(float(m["loss"]))
    frozen = all(torch.equal(cb_state.params[n], w1[n]) for n in w1)
    cb_moved = sum(not torch.equal(cb_state.codebooks[n], b1[n]) for n in b1)
    checks.require(frozen, "codebooks mode changed a weight")
    checks.require(cb_moved > 0, "codebooks mode moved no codebook")
    emit({
        "phase": "codebook_train", "preset": args.preset, "teacher": "teacher",
        "vocab": args.vocab, "batch": args.train_batch, "len": args.src_len, "bits": args.bits,
        "mode": "joint", "codebook_init": "uniform", "steps": len(loss), "launches": launches,
        "loss": loss, "grad_norm": gnorm, "weight_tensors_moved": moved_w,
        "codebooks_moved": moved_b, "codebooks": len(b0), "eval_nll_per_token": eval_nll,
        "parity_cuda_vs_cpu": parity,
        "codebooks_mode": {"steps": 2, "loss": cb_loss, "weights_bit_identical": frozen,
                           "codebooks_moved": cb_moved},
        "card": smi,
    })
    return books


def phase_lut_kernels(checks, dec, rows, gen):
    """The LUT variants at the exact codebook deploy's shapes against their
    plain versions: dequant-matmul at the three decode-step shapes for 2/4/8
    bits and f32/bf16 compute, the fused generator at [rows, 256] x [256,
    32000] (padded to 32768 with edge weights, no -1e9 bias), 4-bit, k = 5,
    with exact indices at f32 and the uniform kernel timed at the same
    masked width."""
    row = kernel_dequant_matmul(checks, "dequant_matmul_lut", JAXK + "dequant_matmul.py:113",
                                dec, rows, gen, lut_bits=(2, 4, 8))
    g = dec.generator
    x = torch.randn(rows, g.shape[0], generator=gen).to("cuda")
    i = dequant_matmul_topk(x, g, 5, compute_dtype=torch.float32)[1]
    ri = dequant_matmul_topk_reference(x, g, 5, compute_dtype=torch.float32)[1]
    checks.require(torch.equal(i, ri), "dequant_matmul_topk_lut/f32: indices not exact")
    gu = pack_linear(dequantize_linear(g), g.bits, bias=g.bias, max_group=g.group)
    uniform_ms = graph_ms(lambda: dequant_matmul_topk(x, gu, 5, compute_dtype=torch.bfloat16))
    return [row, kernel_topk(checks, "dequant_matmul_topk_lut", JAXK + "topk_fused.py:197", g,
                             rows, gen, {"uniform_kernel_ms_same_shape": uniform_ms})]


def phase_codebook_path(checks, args, model, params, points, smi):
    """The exact-LUT codebook deploy at full width: launch counts, finite
    scores, f32 tokens equal to the CPU plain path; then a requant8 deploy
    (uniform 8-bit kernels only)."""
    dev = torch.device("cuda")
    cfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    src, src_len = serve_inputs(args)
    group = pick_generator_group(args.batch * args.beam)
    steps = cfg.max_len

    def deploy(lut_mode, cd=torch.bfloat16, device=dev):
        return pack_decoder(params, model.cfg, args.bits, points=points, lut_mode=lut_mode,
                            compute_dtype=cd, generator_group=group, device=device)

    dec = deploy("exact")
    want = expected(dequant_matmul_lut=3 * steps, dequant_matmul_topk_lut=steps,
                    beam_advance=steps)
    for call in ("capture", "replay"):  # the first call captures the graph, then replays it
        zero_counts()
        toks, scores = beam_search_packed(model, dec, src, src_len, cfg, device=dev)
        launches = read_counts()
        checks.require(launches == want,
                       f"codebook path launches ({call}) {launches}, expected {want}")
    checks.require(tuple(toks.shape) == (args.batch, steps), f"tokens shape {tuple(toks.shape)}")
    checks.require(bool(torch.isfinite(scores).all()), "codebook path scores not finite")
    checks.require(bool(((toks >= 0) & (toks < args.vocab)).all()), "token ids out of range")

    ns = args.cpu_sentences
    dec32 = deploy("exact", torch.float32)
    g_toks, g_scores = beam_search_packed(model, dec32, src[:ns], src_len[:ns], cfg, device=dev)
    e_toks, e_scores = beam_search_packed(model, dec32, src[:ns], src_len[:ns], cfg, device=dev,
                                          _eager=True)
    graph_eq = torch.equal(g_toks, e_toks) and torch.equal(g_scores, e_scores)
    checks.require(graph_eq, "codebook f32 graphed search differs from the eager loop on the card")
    cpu_model = make_seq2seq(args.preset, args.vocab, args.vocab, device="cpu", seed=args.seed)
    c_toks, c_scores = beam_search_packed(cpu_model, deploy("exact", torch.float32, "cpu"),
                                          src[:ns], src_len[:ns], cfg, device="cpu")
    tok_equal = torch.equal(g_toks.cpu(), c_toks)
    checks.require(tok_equal, "codebook f32 tokens on the card differ from the CPU plain path")
    score_err = float((g_scores.cpu() - c_scores).abs().max())

    rq = deploy("requant8")
    zero_counts()
    beam_search_packed(model, rq, src, src_len, cfg, device=dev)
    rq_launches = read_counts()
    rq_want = expected(dequant_matmul=3 * steps, dequant_matmul_topk=steps, beam_advance=steps)
    checks.require(rq_launches == rq_want, f"requant8 launches {rq_launches}, expected {rq_want}")
    emit({
        "phase": "codebook_path", "preset": args.preset, "vocab": args.vocab,
        "batch": args.batch, "beam": args.beam, "max_len": steps, "bits": args.bits,
        "points": "generator/kernel codebook of the codebook_train phase",
        "generator_group": group, "generator_padded": dec.generator.n_padded,
        "launches": launches, "requant8_launches": rq_launches,
        "f32_graph_equals_eager": graph_eq, "f32_tokens_equal_cpu": tok_equal,
        "f32_sentences": ns, "f32_score_max_abs_diff": score_err, "card": smi,
    })


def engine_sentences(n: int, args, gen, min_len: int = 6):
    """``n`` seeded source sentences of ``min_len`` to ``args.src_len`` tokens."""
    lens = torch.randint(min_len, args.src_len + 1, (n,), generator=gen)
    return [torch.randint(4, args.vocab, (int(ln),), generator=gen).tolist() for ln in lens]


def serve_arrivals(eng, sents, arrival) -> dict:
    """Submit ``sents[i]`` at the ``step()`` call ``arrival`` gives it; step
    until every one completes → {sentence index: completion}."""
    res, rids, call = {}, {}, 0
    total = sum(len(v) for v in arrival.values())
    while len(res) < total:
        for i in arrival.get(call, []):
            rids[eng.submit(sents[i])] = i
        for c in eng.step():
            res[rids[c.request_id]] = c
        call += 1
        if call > 10000:
            raise RuntimeError("engine did not drain")
    return res


def engine_parity(checks, args, model, dec32, gen) -> dict:
    """f32 on the card: 32 sentences through an 8-slot engine with
    staggered arrivals (max_tgt_len 24) against the offline graphed
    ``beam_search_packed`` on the same sentences, plain and with the
    coverage penalty: tokens equal, scores within rtol 1e-5. A sentence that
    differs is reported with its score gap."""
    n, t_max = 32, 24
    sents = engine_sentences(n, args, gen)
    src = torch.zeros((n, args.src_len), dtype=torch.int64)
    for i, s in enumerate(sents):
        src[i, : len(s)] = torch.tensor(s)
    src_len = torch.tensor([len(s) for s in sents])
    arrival = {0: list(range(8)), 2: list(range(8, 14)), 5: list(range(14, 20)),
               9: list(range(20, 32))}
    out = {}
    for name, beam in (("plain", BeamConfig(beam_size=args.beam, max_len=t_max)),
                       ("coverage", BeamConfig(beam_size=args.beam, max_len=t_max,
                                               length_penalty=0.6, coverage_penalty=0.4))):
        toks, scores = beam_search_packed(model, dec32, src, src_len, beam, device="cuda")
        cfg = ServeConfig(max_slots=8, max_src_len=args.src_len, max_tgt_len=t_max, beam=beam,
                          admit_batch=ADMIT_BATCH, chunk_steps=4)
        res = serve_arrivals(TranslationEngine(model, cfg, dec32, device="cuda"), sents,
                             arrival)
        differ = []
        worst = 0.0
        for i in range(n):
            want_t, want_s = toks[i].cpu().numpy(), float(scores[i])
            rel = abs(res[i].score - want_s) / max(abs(want_s), 1e-30)
            worst = max(worst, rel)
            if not (res[i].tokens == want_t).all() or rel > 1e-5:
                differ.append({"sentence": i, "engine_score": res[i].score,
                               "offline_score": want_s, "score_gap": res[i].score - want_s,
                               "tokens_equal": bool((res[i].tokens == want_t).all())})
        checks.require(not differ, f"engine f32 ({name}) differs from the offline search: "
                                   f"{differ[:3]}")
        out[name] = {"sentences": n, "differing": differ, "score_max_rel_diff": worst}
    return out


def phase_engine(checks, args, model, params, dec, smi):
    """The continuous-batching engine at ``bench.py --engine``'s shape (see
    the module docstring, phase 12)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed + 5)
    s_slots, k = args.batch, args.beam
    group = pick_generator_group(s_slots * k)
    dec32 = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.float32,
                         generator_group=group, device=dev)
    parity = engine_parity(checks, args, model, dec32, gen)
    del dec32

    # full occupancy: every slot live, max_tgt_len 256
    t_big = ENGINE_T_MAX
    cfg = ServeConfig(max_slots=s_slots, max_src_len=args.src_len, max_tgt_len=t_big,
                      beam=BeamConfig(beam_size=k, max_len=t_big),
                      admit_batch=ADMIT_BATCH, chunk_steps=4)
    eng = TranslationEngine(model, cfg, dec, device=dev)
    sents = [torch.randint(4, args.vocab, (args.src_len,), generator=gen).tolist()
             for _ in range(s_slots)]
    for s in sents:
        eng.submit(s)
    eng.step()  # admits every slot
    checks.require(eng.active_slots == s_slots, f"engine admitted {eng.active_slots} slots")
    n_launch = 8
    zero_counts()
    eng.drive_chunks(1, chunk_steps=n_launch)  # replays run under sync-debug "error"
    launches = read_counts()
    want = expected(dequant_matmul=3 * n_launch, dequant_matmul_topk=n_launch,
                    beam_advance=n_launch)
    checks.require(launches == want, f"engine chunk launches {launches}, expected {want}")

    churn = engine_churn(checks, args, model, dec)
    emit({
        "phase": "engine", "preset": args.preset, "vocab": args.vocab, "slots": s_slots,
        "beam": k, "src_len": args.src_len, "admit_batch": ADMIT_BATCH, "bits": args.bits,
        "f32_parity": parity, "launches_per_chunk": {"steps": n_launch, **launches},
        "chunk_sync_free": True,  # the replays ran under sync-debug "error"
        "max_tgt_len": t_big, "churn": churn, "card": smi,
    })


def engine_churn(checks, args, model, dec) -> dict:
    """``bench.py --engine``'s churn: 3 S requests, seeded Poisson arrivals
    at 0.9 offered load, max_tgt_len 64, chunk_steps 4 (1 while requests
    wait), stage_ahead 2. Every request must complete with a finite score.
    Occupancy, steady-state occupancy and idle shares as bench.py defines
    them."""
    dev = torch.device("cuda")
    s_slots, t_churn = args.batch, 64
    cfg = ServeConfig(max_slots=s_slots, max_src_len=args.src_len, max_tgt_len=t_churn,
                      beam=BeamConfig(beam_size=args.beam, max_len=t_churn),
                      admit_batch=ADMIT_BATCH, chunk_steps=4, chunk_steps_busy=1,
                      stage_ahead=2)
    eng = TranslationEngine(model, cfg, dec, device=dev)
    gen = torch.Generator().manual_seed(args.seed + 6)
    sents = [torch.randint(4, args.vocab, (args.src_len,), generator=gen).tolist()
             for _ in range(s_slots)]
    n_req = 3 * s_slots
    lam = 0.9 * s_slots * cfg.chunk_steps / t_churn
    arrivals = torch.poisson(torch.full((10 * n_req,), lam), generator=gen).long().tolist()
    submitted = completed = it = 0
    ss_start = ss_end = None
    idle_queue_empty = idle_midchunk = 0
    scores = []
    while completed < n_req:
        if submitted < n_req:
            for _ in range(arrivals[min(it, len(arrivals) - 1)]):
                if submitted < n_req:
                    eng.submit(sents[submitted % s_slots])
                    submitted += 1
            if submitted >= n_req and ss_end is None:
                ss_end = (eng.steps_run, eng.tokens_emitted)
        if eng.pending or eng.active_slots:
            pend, act = eng.pending, eng.active_slots
            admitted = min(pend, s_slots - act)
            before = eng.steps_run
            done = eng.step()
            chunk = eng.steps_run - before
            idle_queue_empty += (s_slots - act - admitted) * chunk
            idle_midchunk += len(done) * max(chunk - 1, 0) // 2
            completed += len(done)
            scores += [c.score for c in done]
        if completed and ss_start is None:
            ss_start = (eng.steps_run, eng.tokens_emitted)
        it += 1
        if it > 100000:
            break
    checks.require(completed == n_req, f"churn: {completed} of {n_req} requests completed")
    checks.require(all(map(math.isfinite, scores)), "churn: a score is not finite")
    occ = eng.tokens_emitted / max(eng.steps_run * s_slots, 1)
    ss_occ = occ
    if ss_start and ss_end and ss_end[0] > ss_start[0]:
        ss_occ = (ss_end[1] - ss_start[1]) / ((ss_end[0] - ss_start[0]) * s_slots)
    denom = max(eng.steps_run * s_slots, 1)
    return {"requests": n_req, "completed": completed, "offered_load": 0.9,
            "arrival": "poisson", "max_tgt_len": t_churn, "chunk_steps": 4,
            "chunk_steps_busy": 1, "stage_ahead": 2, "occupancy": occ,
            "steady_state_occupancy": ss_occ, "steps_run": eng.steps_run,
            "tokens_emitted": eng.tokens_emitted,
            "idle_frac_queue_empty": idle_queue_empty / denom,
            "idle_frac_midchunk_est": idle_midchunk / denom}


def phase_engine_lut(checks, args, model, params, points, smi):
    """16 requests through an engine on the exact-LUT deploy (bf16): only
    the LUT kernels launch, 3 dequant-matmul, 1 fused top-k and 1 advance
    a step; finite scores."""
    dev = torch.device("cuda")
    group = pick_generator_group(args.batch * args.beam)
    dec = pack_decoder(params, model.cfg, args.bits, points=points, lut_mode="exact",
                       compute_dtype=torch.bfloat16, generator_group=group, device=dev)
    cfg = ServeConfig(max_slots=16, max_src_len=args.src_len, max_tgt_len=args.src_len,
                      beam=BeamConfig(beam_size=args.beam, max_len=args.src_len),
                      admit_batch=ADMIT_BATCH, chunk_steps=4)
    eng = TranslationEngine(model, cfg, dec, device=dev)
    gen = torch.Generator().manual_seed(args.seed + 7)
    for s in engine_sentences(16, args, gen):
        eng.submit(s)
    zero_counts()
    res = eng.run_until_drained()
    launches = read_counts()
    n = eng.steps_run
    want = expected(dequant_matmul_lut=3 * n, dequant_matmul_topk_lut=n, beam_advance=n)
    checks.require(launches == want, f"exact-LUT engine launches {launches}, expected {want}")
    checks.require(len(res) == 16 and all(math.isfinite(c.score) for c in res),
                   "exact-LUT engine: a request did not complete with a finite score")
    emit({"phase": "engine_lut", "requests": len(res), "steps_run": n, "launches": launches,
          "card": smi})


def deploy_from_disk(checks, args, label, path, model, points, want, src, src_len, cfg):
    """Load the artifact ``path`` onto the card, pack it (with ``points``:
    the exact-LUT deploy), run the graphed packed search twice (capture,
    replay) checking the launch counts ``want``, then hold f32 tokens of
    the file on the card to the CPU plain path on the same file. Returns
    (launches, the file's meta, f32 results)."""
    dev = torch.device("cuda")
    restored, meta = load_artifact(str(path), model, device=dev)
    tree = params_to_numpy(restored)
    disk = Seq2Seq(model.cfg, device=dev).load_params(tree)
    group = pick_generator_group(args.batch * args.beam)
    lut = dict(points=points, lut_mode="exact") if points is not None else {}

    def pack(cd, device):
        return pack_decoder(tree, model.cfg, args.bits, compute_dtype=cd, generator_group=group,
                            device=device, **lut)

    dec = pack(torch.bfloat16, dev)
    for call in ("capture", "replay"):
        zero_counts()
        toks, scores = beam_search_packed(disk, dec, src, src_len, cfg, device=dev)
        launches = read_counts()
        checks.require(launches == want, f"{label} from disk launches ({call}) {launches}, "
                                         f"expected {want}")
    checks.require(bool(torch.isfinite(scores).all()), f"{label} from disk: scores not finite")
    ns = args.cpu_sentences
    g_toks, g_scores = beam_search_packed(disk, pack(torch.float32, dev), src[:ns],
                                          src_len[:ns], cfg, device=dev)
    on_cpu, _ = load_artifact(str(path), model, device="cpu")
    c_toks, c_scores = beam_search_packed(
        Seq2Seq(model.cfg, device="cpu").load_params(params_to_numpy(on_cpu)),
        pack(torch.float32, "cpu"), src[:ns], src_len[:ns], cfg, device="cpu")
    equal = torch.equal(g_toks.cpu(), c_toks)
    checks.require(equal, f"{label}: f32 tokens from disk on the card differ from the CPU path")
    return launches, meta, {
        "f32_tokens_equal_cpu": equal, "f32_sentences": ns,
        "f32_score_max_abs_diff": float((g_scores.cpu() - c_scores).abs().max())}


def manager_round_trip(checks, args, state, root) -> dict:
    """Save the train phase's state (full-width student, Adam moments) with
    the experiment manager and restore it into a fresh state on the card:
    every tensor bit-equal, step and optimizer count kept."""
    dev = torch.device("cuda")
    mgr = ExperimentManager(str(root))
    mgr.add_new_model("train_phase", {"preset": args.preset, "vocab": args.vocab})
    mgr.save("train_phase", state, state.step)
    fresh_model = make_seq2seq(args.preset, args.vocab, args.vocab, dropout=0.0, device=dev,
                               seed=args.seed + 99)
    tx = build_optimizer(TrainConfig(learning_rate=1e-3, clip_norm=5.0))
    fresh = create_train_state(dict(fresh_model.named_parameters()), tx,
                               quant=QuantSpec(bits=args.bits), device=dev)
    restored = mgr.restore("train_phase", fresh)
    pairs = list(zip(_leaves(state.params) + _leaves(state.opt_state.mu)
                     + _leaves(state.opt_state.nu),
                     _leaves(restored.params) + _leaves(restored.opt_state.mu)
                     + _leaves(restored.opt_state.nu)))
    equal = all(a.device == b.device and torch.equal(a, b) for a, b in pairs)
    equal = equal and restored.step == state.step and \
        restored.opt_state.count == state.opt_state.count
    checks.require(equal, "manager round trip: the restored train state differs")
    path = root / "train_phase" / "checkpoints" / f"{state.step}.pt"
    return {"bit_equal": equal, "tensors": len(pairs), "step": restored.step,
            "checkpoint_bytes": path.stat().st_size}


def driver_run(checks, root) -> dict:
    """The port's WMT driver once, briefly, on the card, as a subprocess:
    toy corpus, one epoch for the teacher and one for the 4-bit student."""
    workdir = root / "wmt"
    cmd = [sys.executable, "-m", "quantized_distillation_tpu_torch.examples.wmt_distill",
           "--device", "cuda", "--workdir", str(workdir), "--epochs", "1",
           "--teacher-epochs", "1", "--toy-size", "1000"]
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=600)
    events = []
    if (workdir / "metrics.jsonl").exists():
        events = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
    final = events[-1] if events and events[-1]["event"] == "final" else None
    ok = proc.returncode == 0 and final is not None
    checks.require(ok, f"WMT driver on the card: rc {proc.returncode}, final event "
                       f"{final is not None}; stderr tail: {proc.stderr[-2000:]}")
    return {"rc": proc.returncode, "events": [e["event"] for e in events],
            "final": final and {k: v for k, v in final.items() if k != "t"}}


def phase_artifact(checks, args, model, books, train_state, smi):
    """The deploy loop from disk at full width: the seeded student written
    as a 4-bit uniform ``.qdt`` and as a codebook ``.qdt`` (the codebook
    train phase's codebooks), read back onto the card, packed and served by
    the graphed packed search (launch counts, f32 tokens of the file on the
    card equal to the CPU path's); the size report beside the file's size;
    the host codec's round trip. Then the train phase's state through the
    experiment manager, and the WMT driver once."""
    root = Path(__file__).resolve().parent / "runs"
    root.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_artifact_", dir=root))
    cfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    src, src_len = serve_inputs(args)
    steps = cfg.max_len
    try:
        spec = QuantSpec(bits=args.bits)
        stats = save_artifact(str(root / "uniform.qdt"), model, spec,
                              meta={"preset": args.preset, "seed": args.seed})
        weights = dict(model.named_parameters())
        streams = index_streams(weights, spec)
        sizes = param_sizes(weights)
        rep = model_size_report(sizes, args.bits, scaling=spec.scaling, index_streams=streams,
                                exclude=[k for k in sizes if k not in streams])
        coded = {k: native.huffman_encode(v, 1 << args.bits) for k, v in streams.items()}
        back = {k: native.huffman_decode(c[0], c[2], c[1], streams[k].size)
                for k, c in coded.items()}
        checks.require(all(np.array_equal(back[k], streams[k]) for k in streams),
                       "codec round trip of the index streams failed")
        symbols = sum(v.size for v in streams.values())

        want = expected(dequant_matmul=3 * steps, dequant_matmul_topk=steps, beam_advance=steps)
        u_launches, meta, u_f32 = deploy_from_disk(
            checks, args, "uniform", root / "uniform.qdt", model, None, want, src, src_len, cfg)
        checks.require(meta == {"preset": args.preset, "seed": args.seed}, f"meta {meta}")

        cb_spec = QuantSpec(bits=args.bits, method="codebook")
        cb_stats = save_artifact(str(root / "codebook.qdt"), model, cb_spec, codebooks=books)
        want_lut = expected(dequant_matmul_lut=3 * steps, dequant_matmul_topk_lut=steps,
                            beam_advance=steps)
        c_launches, _, c_f32 = deploy_from_disk(
            checks, args, "codebook (exact LUT)", root / "codebook.qdt", model,
            books["generator/kernel"].cpu(), want_lut, src, src_len, cfg)

        est_bytes = rep.total_bits / 8
        emit({
            "phase": "artifact", "preset": args.preset, "vocab": args.vocab, "bits": args.bits,
            "batch": args.batch, "beam": args.beam, "max_len": steps,
            "uniform": {
                "file_bytes": stats["file_bytes"], "fp32_bytes": stats["fp32_bytes"],
                "compression_ratio": stats["compression_ratio"],
                "size_report_bytes": est_bytes,
                "size_report_compression_ratio": rep.compression_ratio,
                "file_over_report": stats["file_bytes"] / est_bytes,
                "mean_bits_per_weight": rep.quantized_bits / max(
                    sum(sizes[k] for k in streams), 1),
                "launches": u_launches, **u_f32,
            },
            "codec": {"symbols": symbols},
            "codebook": {
                "file_bytes": cb_stats["file_bytes"],
                "compression_ratio": cb_stats["compression_ratio"],
                "points": "the codebook train phase's codebooks; deployed exact-LUT on its "
                          "generator/kernel codebook",
                "launches": c_launches, **c_f32,
            },
            "manager": manager_round_trip(checks, args, train_state, root / "manager"),
            "wmt_driver": driver_run(checks, root),
            "card": smi,
        })
    finally:
        shutil.rmtree(root, ignore_errors=True)


WRN_BUCKETS = 10814  # WRN-16-4's 17 quantizable leaves in buckets of 256
LM_BUCKETS = 24096  # the LM student_medium's 18, V = 10000


def fake_quant_at(checks, label, params, quant) -> dict:
    """The fake-quant kernel on the buckets one STE step of ``params`` hands
    it (every quantizable leaf), bit-exact against its plain version, and
    timed like phase 6. Its launches are outside any counted run."""
    buckets = quantizable_buckets(params, quant)
    ok = torch.equal(fake_quant_buckets(buckets, quant.bits),
                     fake_quant_buckets_reference(buckets, quant.bits))
    checks.require(ok, f"{label}: fake_quant at {buckets.shape[0]} buckets not bit-exact")
    ms = graph_ms(lambda: fake_quant_buckets(buckets, quant.bits))
    plain = graph_ms(lambda: fake_quant_buckets_reference(buckets, quant.bits))
    bms, by = bound(8.0 * buckets.numel(), 2 * nbytes(buckets), PEAK_F32)
    return {"n_buckets": buckets.shape[0], "bit_exact": ok, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by}


def kd_steps(checks, label, task, state, batch, quant, distill, tx, steps, seed,
             check_falling=True) -> tuple:
    """``steps`` 4-bit STE KD steps on one batch, then the eval step, with
    the launch counters zeroed before and read after: one fake-quant launch
    a step and one for the eval step, finite losses and gradient norms,
    (``check_falling``) a falling loss, and running statistics that moved.
    Returns (state, a record for the phase's line)."""
    step = make_train_step(task, tx, quant=quant, distill=distill, device="cuda")
    eval_step = make_eval_step(task, quant=quant, device="cuda")
    stats0 = {n: t.clone() for n, t in (state.batch_stats or {}).items()}
    zero_counts()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, seed)
        metrics.append(m)
    ev = eval_step(state, batch)
    launches = read_counts()
    loss = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    want = expected(fake_quant_buckets=steps + 1)
    checks.require(launches == want, f"{label} launches {launches}, expected {want}")
    checks.require(all(map(math.isfinite, loss + gnorm)), f"{label} loss or grad_norm not finite")
    if check_falling:
        checks.require(loss[-1] < loss[0], f"{label} loss did not fall: {loss[0]} -> {loss[-1]}")
    moved = sum(not torch.equal(t, stats0[n]) for n, t in (state.batch_stats or {}).items())
    if stats0:
        checks.require(moved == len(stats0), f"{label}: {moved} of {len(stats0)} statistics moved")
    ev = {k: float(v) for k, v in ev.items() if k != "carry"}
    checks.require(all(map(math.isfinite, ev.values())), f"{label} eval metrics not finite")
    return state, {"steps": steps, "launches": launches, "loss": loss, "grad_norm": gnorm,
                   "statistics_moved": moved, "eval": ev}


def graph_legs(checks, label, task, tx, state, batch, seed, args, *, quant,
               mode: str = "weights", fq_per_step: int = 1, control: bool = False,
               **mesh_kw) -> dict:
    """The graphed train step against the eager one at the phase's width,
    ``args.train_steps`` steps from copies of ``state`` on ``batch`` at
    ``seed``: ``multicard_smoke.graph_leg`` (three eager runs and one
    graphed, every tensor and loss held to the eager runs by its
    ``graph_parity``; one capture, ``fq_per_step`` fake-quant launches a
    step; with ``control``, another seed another loss; ``mesh_kw``:
    ``mesh``, and ``param_specs`` or ``grad_reduce_dtype``, the steps on
    that mesh with the eager step's collectives at every replay). The WRN
    legs run under :func:`cudnn_deterministic`, so their eager runs agree
    bit for bit. Prints the phase ``<label>_graph`` line and returns it."""
    out = {"phase": f"{label}_graph", "steps": args.train_steps, "mode": mode,
           **graph_leg(checks, label, task, tx, state, batch, seed, args.train_steps,
                       torch.device("cuda"), quant=quant, mode=mode, fq_per_step=fq_per_step,
                       control=control, **mesh_kw)}
    emit(out)
    return out


def phase_vision_train(checks, args, smi):
    """WRN-28-10 → WRN-16-4 on CIFAR-100 (see the module docstring)."""
    dev = torch.device("cuda")
    quant, distill = QuantSpec(bits=args.bits), DistillSpec()
    cfg = TrainConfig(learning_rate=1e-3, clip_norm=5.0)

    def models(device, seed):
        teacher = make_wrn("teacher", 100, device=device, seed=seed)
        return make_wrn("student_medium", 100, device=device, seed=seed + 1), teacher

    student, teacher = models(dev, args.seed + 40)
    task = vision_task(student, teacher, device=dev)
    batch = vision_batch(args.vision_batch, 32, 100, args.seed + 42, dev)
    tx = build_optimizer(cfg)
    state = create_train_state(dict(student.named_parameters()), tx,
                               batch_stats=dict(student.named_buffers()), quant=quant, device=dev)
    fq = fake_quant_at(checks, "vision_train", state.params, quant)
    checks.require(fq["n_buckets"] == WRN_BUCKETS, f"vision_train: {fq['n_buckets']} buckets")
    state, record = kd_steps(checks, "vision_train", task, state, batch, quant, distill, tx,
                             args.train_steps, args.seed)

    def setup(device):
        s, t = models(device, args.seed + 40)
        s.load_params(params_to_numpy(state.params)).load_batch_stats(
            batch_stats_to_numpy(state.batch_stats))  # the trained weights and statistics
        tx_ = build_optimizer(cfg)
        return vision_task(s, t, device=device), create_train_state(
            dict(s.named_parameters()), tx_, batch_stats=dict(s.named_buffers()), quant=quant,
            device=device), tx_

    parity = step_parity(checks, "vision_train parity", setup,
                         [vision_batch(args.parity_batch, 32, 100, args.seed + 43, "cpu")],
                         quant, distill)
    with cudnn_deterministic():  # graphed must equal eager bit for bit
        graph_legs(checks, "vision_train", task, tx, state, batch, args.seed, args, quant=quant)

    # differentiable quantization, as examples/cifar100_wrn_diffquant.py trains
    cb_quant = QuantSpec(bits=args.bits, method="codebook")
    cb_tx = build_optimizer(cfg)
    cb_state = create_train_state(state.params, cb_tx, batch_stats=state.batch_stats,
                                  quant=cb_quant, mode="joint", device=dev)
    cb_step = make_train_step(task, cb_tx, quant=cb_quant, distill=distill, mode="joint",
                              device=dev)
    zero_counts()
    cb_loss = []
    for _ in range(2):
        cb_state, m = cb_step(cb_state, batch, args.seed)
        cb_loss.append(float(m["loss"]))
    cb_launches = read_counts()
    checks.require(cb_launches == expected(), f"vision joint launches {cb_launches}, expected none")
    checks.require(all(map(math.isfinite, cb_loss)), "vision joint loss not finite")
    emit({
        "phase": "vision_train", "teacher": "wrn_28_10", "student": "wrn_16_4", "classes": 100,
        "batch": args.vision_batch, "image": [32, 32, 3], "bits": args.bits, **record,
        "teacher_params": sum(p.numel() for p in teacher.parameters()),
        "student_params": sum(p.numel() for p in student.parameters()),
        "fake_quant": fq, "parity_cuda_vs_cpu": parity,
        "joint": {"steps": 2, "loss": cb_loss, "launches": cb_launches}, "card": smi,
    })


def phase_lm_train(checks, args, smi):
    """2x650 → student_medium LSTM LM with the carry threaded (see the
    module docstring)."""
    dev = torch.device("cuda")
    quant, distill = QuantSpec(bits=args.bits), DistillSpec()
    cfg = TrainConfig(learning_rate=1e-3, clip_norm=5.0)
    v, b = args.lm_vocab, args.lm_batch

    def models(device, seed, **kw):
        teacher = make_lm("teacher", v, device=device, seed=seed)
        return make_lm("student_medium", v, device=device, seed=seed + 1, **kw), teacher

    student, teacher = models(dev, args.seed + 50)
    task = lm_task(student, teacher, thread_carry=True, device=dev)
    seen = []  # the carry each train step reads

    def recording(params, batch_, train, generator):
        if train:
            seen.append(batch_["carry"])
        return task.student_forward(params, batch_, train, generator)

    rec_task = Task(recording, task.loss_and_metrics, task.teacher_forward)
    batch = lm_batch(b, v, args.lm_bptt, args.seed + 52, dev)
    tx = build_optimizer(cfg)
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                               carry=lm_initial_carry(student, b, teacher), device=dev)
    fq = fake_quant_at(checks, "lm_train", state.params, quant)
    checks.require(fq["n_buckets"] == LM_BUCKETS, f"lm_train: {fq['n_buckets']} buckets")
    outs = []
    # eager: a replay would not repeat the recording
    step = make_train_step(rec_task, tx, quant=quant, distill=distill, device=dev, _eager=True)
    for _ in range(2):  # the carry handed from step to step, on the card
        state, _ = step(state, batch, args.seed)
        outs.append(state.carry)
    threaded = all(
        torch.equal(a, c) and c.grad_fn is None and not c.requires_grad
        for a, c in zip(_leaves(outs[0]), _leaves(seen[1]), strict=True))
    checks.require(threaded, "lm_train: a step's input carry is not the last step's output")
    checks.require(all(t.grad_fn is None for t in _leaves(outs[1])),
                   "lm_train: the state's carry has gradient history")
    moved = not torch.equal(_leaves(outs[0])[1], _leaves(outs[1])[1])
    checks.require(moved, "lm_train: the carry did not move")
    state, record = kd_steps(checks, "lm_train", task, state, batch, quant, distill, tx,
                             args.train_steps, args.seed)

    def setup(device):
        s, t = models(device, args.seed + 50, dropout=0.0)
        tx_ = build_optimizer(cfg)
        return lm_task(s, t, thread_carry=True, device=device), create_train_state(
            dict(s.named_parameters()), tx_, quant=quant,
            carry=lm_initial_carry(s, args.parity_batch, t), device=device), tx_

    parity = step_parity(checks, "lm_train parity", setup,
                         [lm_batch(args.parity_batch, v, args.lm_bptt, args.seed + 53 + i, "cpu")
                          for i in range(2)], quant, distill)
    graph_legs(checks, "lm_train", task, tx, state, batch, args.seed, args, quant=quant)
    emit({
        "phase": "lm_train", "teacher": "lm_2x650", "student": "student_medium", "vocab": v,
        "batch": b, "bptt": args.lm_bptt, "bits": args.bits, "thread_carry": True, **record,
        "carry_threaded_on_card": threaded, "fake_quant": fq, "parity_cuda_vs_cpu": parity,
        "card": smi,
    })


def phase_vision_families(checks, args, smi):
    """The CNN and the ImageNet ResNet at the widths of their examples (see
    the module docstring)."""
    dev = torch.device("cuda")
    quant, distill = QuantSpec(bits=args.bits), DistillSpec()
    cfg = TrainConfig(learning_rate=1e-3, clip_norm=5.0)
    cnn_small = dataclasses.replace(CNN_PRESETS["student_small"], dropout=0.0)
    families = {
        "cnn": (lambda device, seed, parity: (
            ConvForwardNet(cnn_small, device=device, seed=seed + 1) if parity
            else make_cnn("student_small", device=device, seed=seed + 1),
            make_cnn("teacher", device=device, seed=seed)), 32, 10, args.cnn_batch),
        "resnet": (lambda device, seed, parity: (
            make_resnet("resnet18_half", device=device, seed=seed + 1),
            make_resnet("resnet18", device=device, seed=seed)), 224, 1000, args.resnet_batch),
    }
    record = {}
    for i, (name, (models, size, classes, b)) in enumerate(families.items()):
        seed = args.seed + 60 + 10 * i
        student, teacher = models(dev, seed, False)
        task = vision_task(student, teacher, device=dev)
        batch = vision_batch(b, size, classes, seed + 2, dev)
        tx = build_optimizer(cfg)
        state = create_train_state(dict(student.named_parameters()), tx,
                                   batch_stats=dict(student.named_buffers()), quant=quant,
                                   device=dev)
        fq = fake_quant_at(checks, name, state.params, quant)
        state, rec = kd_steps(checks, name, task, state, batch, quant, distill, tx, 3, args.seed,
                              check_falling=False)

        def setup(device, models=models, seed=seed):
            s, t = models(device, seed, True)
            tx_ = build_optimizer(cfg)
            return vision_task(s, t, device=device), create_train_state(
                dict(s.named_parameters()), tx_, batch_stats=dict(s.named_buffers()),
                quant=quant, device=device), tx_

        parity = step_parity(checks, f"{name} parity", setup,
                             [vision_batch(args.family_parity_batch, size, classes, seed + 3,
                                           "cpu")], quant, distill)
        record[name] = {"batch": b, "image": [size, size, 3], "classes": classes, **rec,
                        "fake_quant": fq, "parity_cuda_vs_cpu": parity}
        del student, teacher, task, state
    emit({"phase": "vision_families", "bits": args.bits,
          "cnn": {"teacher": "teacher", "student": "student_small", **record["cnn"]},
          "resnet": {"teacher": "resnet18", "student": "resnet18_half", **record["resnet"]},
          "card": smi})


# Phase 17: the four paper drivers through their main(argv), on synthetic data.
# The CIFAR-10 epochs are what the synthetic task needs for its quantized
# student to clear CIFAR10_MIN_ACCURACY (the BatchNorm running statistics, at
# momentum 0.99, settle only after a few hundred steps).
CIFAR10_MIN_ACCURACY = 0.2  # chance is 0.1
DRIVER_RUNS = {
    "cifar10": (cifar10_distill, [
        "--teacher", "teacher", "--student", "student_small", "--bits", "4",
        "--synthetic-size", "2560", "--teacher-epochs", "15", "--epochs", "15"]),
    "cifar100_wrn": (cifar100_wrn_diffquant, [
        "--teacher", "teacher", "--student", "student_medium", "--bits", "2", "--auto-bits", "3",
        "--synthetic-size", "2560", "--teacher-epochs", "1", "--epochs", "1",
        "--diffquant-epochs", "1"]),
    "imagenet": (imagenet_resnet_distill, [
        "--teacher", "resnet18", "--student", "resnet18_half", "--image-size", "64",
        "--num-classes", "1000", "--synthetic-size", "2048", "--batch-size", "64",
        "--teacher-epochs", "1", "--epochs", "1"]),
    "ptb": (ptb_lm_distill, [
        "--teacher", "teacher", "--student", "student_medium", "--synthetic-vocab", "10000",
        "--synthetic-tokens", "200000", "--teacher-epochs", "1", "--epochs", "1"]),
}


def vision_driver_launches(n_train, n_test, batch_size, epochs) -> int:
    """Fake-quant launches of a vision driver's student: one per STE step
    (full batches), one per quantized eval batch (a pass after every epoch
    and one for the report; the last batch may be short)."""
    return epochs * (n_train // batch_size) + (epochs + 1) * math.ceil(n_test / batch_size)


def lm_windows(n_tokens, batch_size, bptt) -> int:
    """Contiguous-BPTT windows of ``data/lm.py::lm_batches``."""
    return len(range(0, (n_tokens - 1) // batch_size - bptt + 1, bptt))


def driver_plan(name, a) -> dict:
    """What the driver ``name`` run at the flags ``a`` implies: its
    registry's teacher and student, its fake-quant launches and its student
    model (for the bucket count)."""
    if name == "ptb":
        per_epoch = lm_windows(a.synthetic_tokens, a.batch_size, a.bptt)
        eval_windows = lm_windows(max(a.synthetic_tokens // 10, 2000), a.batch_size, a.bptt)
        return {"models": (f"lm_{a.teacher}_fp32", f"lm_{a.student}_{a.bits}bit"),
                "launches": a.epochs * per_epoch + (a.epochs + 1) * eval_windows,
                "student": make_lm(a.student, a.synthetic_vocab, device="cuda")}
    data_dir = a.data_dir or BASE_DATA_FOLDER
    if name == "imagenet":
        prefix, n_test = "imagenet", (a.synthetic_size or 2000) // 4
        student = make_resnet(a.student, a.num_classes, small_inputs=a.image_size <= 64,
                              device="cuda")
        train = load_imagenet(True, data_dir, a.image_size, a.num_classes, a.synthetic_size,
                              a.seed)
    elif name == "cifar10":
        prefix, n_test = "cifar10", a.synthetic_size
        student = make_cnn(a.student, device="cuda")
        train = load_cifar(10, True, data_dir, a.synthetic_size, a.seed)
    else:
        prefix, n_test = "wrn", a.synthetic_size
        student = make_wrn(a.student, 100, device="cuda")
        train = load_cifar(100, True, data_dir, a.synthetic_size, a.seed)
    n_train = len(train.labels)
    return {"models": (f"{prefix}_{a.teacher}_fp32", f"{prefix}_{a.student}_{a.bits}bit"),
            "launches": vision_driver_launches(n_train, n_test, a.batch_size, a.epochs),
            "student": student}


def phase_drivers(checks, args, smi):
    """The four paper drivers through their ``main(argv)`` with ``--device
    cuda`` at the widths of DRIVER_RUNS, each under its own workdir in a
    temporary directory (see the module docstring)."""
    root = Path(__file__).resolve().parent / "runs"
    root.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_drivers_", dir=root))
    try:
        for name, (module, flags) in DRIVER_RUNS.items():
            a = module.parse_args(flags)
            workdir = root / name
            zero_counts()
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = module.main([*flags, "--device", "cuda", "--workdir", str(workdir)])
            except Exception:  # the phase fails, the script goes on to report it
                traceback.print_exc()
                rc = None
            launches = read_counts()
            path = workdir / "metrics.jsonl"
            events = [json.loads(line) for line in path.read_text().splitlines()] \
                if path.exists() else []
            final = events[-1] if events and events[-1]["event"] == "final" else {}
            numbers = [v for k, v in final.items() if isinstance(v, float) and k != "t"]
            checks.require(rc == 0 and final and all(map(math.isfinite, numbers)),
                           f"{name} driver: rc {rc}, final {final}")
            plan = driver_plan(name, a)
            fq = fake_quant_at(checks, f"{name} driver", dict(plan["student"].named_parameters()),
                               QuantSpec(bits=a.bits))
            got, want = launches["fake_quant_buckets"], plan["launches"]
            checks.require(got == want > 0 and launches == expected(fake_quant_buckets=want),
                           f"{name} driver launches {launches}, expected {want} fake-quant")
            mgr = ExperimentManager(str(workdir))
            saved = {m: mgr.has_model(m) and bool(mgr.latest_step(m)) and (
                workdir / m / "checkpoints" / f"{mgr.latest_step(m)}.pt").is_file()
                for m in plan["models"]}
            checks.require(mgr.list_models() == sorted(saved) and all(saved.values()),
                           f"{name} driver registry {mgr.list_models()}, checkpoints {saved}")
            if name == "cifar10":
                acc = final.get("student_quantized_accuracy", 0.0)
                checks.require(acc > CIFAR10_MIN_ACCURACY,
                               f"cifar10 student quantized accuracy {acc} <= "
                               f"{CIFAR10_MIN_ACCURACY}")
            emit({"phase": "drivers", "driver": name, "argv": flags, "rc": rc,
                  "fake_quant_launches": got, "expected_launches": want,
                  "fake_quant": {"bits": a.bits, **fq}, "registry": saved,
                  "final": {k: v for k, v in final.items() if k not in ("event", "t")},
                  "card": smi})
            del plan
    finally:
        shutil.rmtree(root, ignore_errors=True)


def vision_batch(n, size, classes, seed, device) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.randn(n, size, size, 3, generator=g).to(device),
            "label": torch.randint(0, classes, (n,), generator=g).to(device)}


def lm_batch(n, vocab, bptt, seed, device) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"input": torch.randint(0, vocab, (n, bptt), generator=g).to(device),
            "target": torch.randint(0, vocab, (n, bptt), generator=g).to(device)}


# ------------------------------------------------------------ multi-GPU (18)

MG_SHAPES = ((1, 4), (2, 2))  # the 4 gloo ranks sharing the card
MG_TIMEOUT = 300  # seconds a collective may wait; the spawns' join limit is 600
MG_STEPS = 4  # decode steps of the sharded step against the unsharded one


def _rank_setup():
    """A rank sharing the card: the card current, TF32 off as in the parent."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _mg_serve_rank(rank, world, spec):
    """One of 4 ranks sharing the card over gloo, for each mesh of MG_SHAPES:
    the path's kernels at this rank's shapes against their plain versions
    (the generator at its shard width, dequant-matmul at rows = B K / dp,
    the beam advance on B / dp sentences), the f32 sharded decode step
    against the unsharded one, then the f32 sharded search at full width
    (every check launches before the counted run)."""
    dev = _rank_setup()
    a = argparse.Namespace(**spec["args"])
    checks = Checks()
    model = make_seq2seq(a.preset, a.vocab, a.vocab, device=dev, seed=a.seed)
    params = params_to_numpy(model)
    gk, gb = params["generator"]["kernel"], params["generator"]["bias"]
    decs = {cd: pack_decoder(params, model.cfg, a.bits, compute_dtype=cd,
                             generator_group=spec["group"], device=dev)
            for cd in (torch.float32, torch.bfloat16)}
    src, src_len = serve_inputs(a)
    cfg = BeamConfig(beam_size=a.beam, max_len=a.src_len)
    out = {}
    for shape in MG_SHAPES:
        mesh = make_mesh(*shape)
        sdecs = {cd: shard_decoder(d, mesh, gk, gb) for cd, d in decs.items()}
        rows = a.batch * a.beam // shape[0]
        tag = f"multi_gpu {shape} rank {rank}"
        gen = torch.Generator().manual_seed(a.seed + 40 + rank)
        x = torch.randn(rows, model.cfg.hidden, generator=gen).to(dev)
        kern = {str(cd): check_topk(checks, f"{tag} generator shard", x, sd.generator, a.beam, cd)
                for cd, sd in sdecs.items()}
        dm = {}
        for mat, p, xdt in decode_matrices(sdecs[torch.float32]):
            xm = torch.randn(rows, p.shape[0], generator=gen).to(dev, xdt)
            dm[mat] = check_dequant_matmul(checks, f"{tag} dequant_matmul/{mat}", xm, p)
        adv = {f"t{t}": check_advance(checks, f"{tag} beam_advance", a.batch // shape[0],
                                      a.beam, a.beam, t, a.src_len, gen)
               for t in (0, a.src_len - 1)}
        stp = sharded_step_check(checks, f"{tag} step", model, decs[torch.float32],
                                 sdecs[torch.float32], mesh, src, src_len, a.beam, MG_STEPS)
        zero_counts()
        with collective_budget(mesh) as budget:
            toks, scores = beam_search_sharded(model, sdecs[torch.float32], src, src_len, cfg,
                                               mesh, device=dev)
        out[str(shape)] = {
            "rows": rows, "N": sdecs[torch.float32].generator.shape[1], "kernel": kern,
            "dequant_matmul": dm, "beam_advance_bit_exact": adv, "step": stp,
            "launches": read_counts(), "graphed": capturable(mesh, dev),
            "gathers": {ax: sum(op.kind == "all-gather" and op.axis == ax for op in budget.ops)
                        for ax in ("model", "data", "unknown")},
            "tokens": toks.cpu().numpy(), "scores": scores.cpu().numpy(),
        }
    return {"failed": checks.failed, "shapes": out}


def _mg_kd(a, dev, batch_size, seed, mesh, grad_reduce_dtype):
    """One SGD KD step (lr 1e-2, the JAX package's reduced-precision test)
    of a fresh seeded student → (loss, params, fake-quant launches, whether
    the step ran graphed)."""
    student, task, batch = kd_setup(a, dev, batch_size, seed)
    quant = QuantSpec(bits=a.bits)
    tx = build_optimizer(TrainConfig(learning_rate=1e-2, optimizer="sgd"))
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant, device=dev)
    step = make_train_step(task, tx, quant=quant, distill=DistillSpec(), mesh=mesh,
                           grad_reduce_dtype=grad_reduce_dtype, device=dev)
    if mesh is not None:
        batch = place_batch(batch, mesh, device=dev)
    zero_counts()
    state, m = step(state, batch, a.seed)
    launches = read_counts()["fake_quant_buckets"]
    return float(m["loss"]), state.params, launches, step.graphed


def _params_excess(got, want, rtol, atol) -> float:
    """The largest |got - want| - rtol |want| over every tensor (<= atol
    passes)."""
    return max(float(((g.detach() - want[n].detach()).abs() - rtol * want[n].detach().abs()).max())
               for n, g in got.items())


def _mg_train_rank(rank, world, spec):
    """One of 2 ranks sharing the card over gloo: the B = 8 DP step (f32
    reduce) on a (2, 1) mesh against the one-rank step on all 8 rows, both
    run here."""
    dev = _rank_setup()
    a = argparse.Namespace(**spec["args"])
    seed = a.seed + 30
    loss1, params1, _, _ = _mg_kd(a, dev, a.parity_batch, seed, None, None)
    loss, params, launches, graphed = _mg_kd(a, dev, a.parity_batch, seed, make_mesh(2, 1), None)
    return {"loss": loss, "one_rank_loss": loss1, "fake_quant_launches": launches,
            "graphed": graphed, "params_excess": _params_excess(params, params1, W_RTOL, W_ATOL)}


TP_SHAPES = ((1, 4), (2, 2))  # the seq2seq tensor-parallel step: 4 gloo ranks on the card
LM_TP_SHAPE = (1, 2)
TP_SGD = TrainConfig(learning_rate=1e-2, optimizer="sgd")  # SGD: compare weights, not Adam's
STE_BUCKETS = 105984  # student_medium's 37 quantizable leaves, V = 32000, in buckets of 256


def _tp_models(a, dev, family: str, seed: int):
    """(student, task, batch) of a full-width KD step, dropout 0: the
    seq2seq one of phase 7 (B = ``train_batch``) or the LM one of phase 14
    (2x650 → student_medium, V = ``lm_vocab``, B = ``lm_batch`` x
    ``lm_bptt``, the carry not threaded)."""
    if family == "s2s":
        return kd_setup(a, dev, a.train_batch, seed)
    teacher = make_lm("teacher", a.lm_vocab, dropout=0.0, device=dev, seed=seed)
    student = make_lm("student_medium", a.lm_vocab, dropout=0.0, device=dev, seed=seed + 1)
    batch = lm_batch(a.lm_batch, a.lm_vocab, a.lm_bptt, seed + 2, "cpu")
    return student, lm_task(student, teacher, device=dev), batch


def _tp_step(a, dev, family, seed, mesh, tensor_parallel: bool) -> dict:
    """One SGD KD step of a fresh seeded student (whole, or this rank's
    shards with ``tensor_parallel``) → loss, parameters, fake-quant launches,
    collectives by kind and axis."""
    student, task, batch = _tp_models(a, dev, family, seed)
    quant = QuantSpec(bits=a.bits)
    whole = dict(student.named_parameters())
    specs = placed_pspecs(whole, mesh) if tensor_parallel else None
    params = place_params_seq2seq(whole, mesh, device=dev) if tensor_parallel else whole
    tx = build_optimizer(TP_SGD)
    state = create_train_state(params, tx, quant=quant, device=dev)
    step = make_train_step(task, tx, quant=quant, distill=DistillSpec(), mesh=mesh,
                           param_specs=specs, device=dev)
    if mesh is not None:
        batch = place_batch(batch, mesh, device=dev)
    zero_counts()
    with collective_budget(mesh) as budget:
        state, m = step(state, batch, a.seed)
        loss = float(m["loss"])
    kinds = {}
    for op in budget.ops:
        kinds[f"{op.kind}@{op.axis}"] = kinds.get(f"{op.kind}@{op.axis}", 0) + 1
    return {"loss": loss, "grad_norm": float(m["grad_norm"]), "params": state.params,
            "launches": read_counts()["fake_quant_buckets"], "collectives": kinds,
            "graphed": step.graphed,
            "wire_bytes_by_axis": budget.bytes_by_axis(wire=True),
            "specs": specs, "mp": None if specs is None else ModelParallel(mesh, specs)}


def _shard_excess(got: dict, mp, whole: dict, dev) -> float:
    """:func:`_params_excess` of this rank's shards against the slices of
    the whole tensors ``whole`` (on the CPU)."""
    return _params_excess(got, {n: mp.local(n, t.to(dev)) for n, t in whole.items()},
                          W_RTOL, W_ATOL)


def _tp_fake_quant_exact(a, dev, mp, params) -> dict:
    """The fake-quant kernel on the whole tree gathered from this rank's
    shards, as the TP step hands it the buckets, against its plain version
    (outside any counted run)."""
    quant = QuantSpec(bits=a.bits)
    whole = {**params, **mp.gather(params)}
    buckets = quantizable_buckets(whole, quant)
    got = fake_quant_buckets(buckets, a.bits)
    return {"n_buckets": int(buckets.shape[0]),
            "bit_exact": bool(torch.equal(got, fake_quant_buckets_reference(buckets, a.bits)))}


def _mg_tp_rank(rank, world, spec):
    """One of the ranks sharing the card over gloo: the full-width
    tensor-parallel KD step at each of ``spec["shapes"]``, its SGD-updated
    shard against the slice of the one-process step's (``spec["ref"]``,
    whole, on the CPU), and (first mesh) the fake-quant kernel on the
    gathered tree against its plain version."""
    dev = _rank_setup()
    a = argparse.Namespace(**spec["args"])
    out = {}
    for i, shape in enumerate(spec["shapes"]):
        mesh = make_mesh(*shape)
        r = _tp_step(a, dev, spec["family"], spec["seed"], mesh, True)
        mp = r.pop("mp")
        res = {k: v for k, v in r.items() if k not in ("params", "specs")}
        res["params_excess"] = _shard_excess(r["params"], mp, spec["ref"], dev)
        res["split"] = sum(mp.is_split(n) for n in r["params"])
        if i == 0:  # every rank: the gather is a collective over model
            local = dict(_tp_models(a, dev, spec["family"], spec["seed"])[0].named_parameters())
            res["fake_quant"] = _tp_fake_quant_exact(
                a, dev, mp, place_params_seq2seq(local, mesh, device=dev))
        out[str(shape)] = res
    return out


def mg_tp_train(checks, args, smi):
    """(d) tensor-parallel training: the full-width seq2seq KD step on 4
    gloo ranks at TP_SHAPES and the LM's on 2 at LM_TP_SHAPE, each rank's
    SGD-updated shard against the slice of the one-process step on the card
    (loss LOSS_RTOL, weights W_RTOL / W_ATOL), one fake-quant launch a rank,
    the kernel bit-exact on the gathered tree; then the two scripts."""
    dev = torch.device("cuda", 0)
    out = {}
    for family, shapes, seed in (("s2s", TP_SHAPES, args.seed + 70),
                                 ("lm", (LM_TP_SHAPE,), args.seed + 75)):
        ref = _tp_step(args, dev, family, seed, None, False)
        spec = {"args": vars(args), "family": family, "seed": seed, "shapes": shapes,
                "ref": {n: t.detach().cpu() for n, t in ref["params"].items()}}
        del ref["params"]
        world = shapes[0][0] * shapes[0][1]
        ranks = run_ranks(_mg_tp_rank, world, args=(spec,), timeout=MG_TIMEOUT, join_timeout=600)
        fam = {"one_process": {k: ref[k] for k in ("loss", "grad_norm", "launches")}}
        for shape in shapes:
            per = [r[str(shape)] for r in ranks]
            for rk, p in enumerate(per):
                tag = f"tp_train {family} {shape} rank {rk}"
                checks.require(abs(p["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"]),
                               f"{tag}: loss {p['loss']} vs {ref['loss']}")
                checks.require(abs(p["grad_norm"] - ref["grad_norm"])
                               <= LOSS_RTOL * abs(ref["grad_norm"]),
                               f"{tag}: grad_norm {p['grad_norm']} vs {ref['grad_norm']}")
                checks.require(p["params_excess"] <= W_ATOL,
                               f"{tag}: shard {p['params_excess']} past rtol {W_RTOL}")
                checks.require(p["launches"] == 1, f"{tag}: {p['launches']} fake-quant launches")
                checks.require(not p["graphed"], f"{tag}: a gloo step ran graphed")
                checks.require(p["split"] > 0, f"{tag}: no parameter split over model")
                for k in ("all-gather@model", "reduce-scatter@model", "all-reduce@model"):
                    checks.require(p["collectives"].get(k, 0) > 0, f"{tag}: no {k}")
                if "fake_quant" in p:
                    fq = p["fake_quant"]
                    checks.require(fq["bit_exact"], f"{tag}: fake-quant on the gathered tree "
                                                    "differs from its plain version")
                    want = STE_BUCKETS if family == "s2s" else LM_BUCKETS
                    checks.require(fq["n_buckets"] == want, f"{tag}: {fq['n_buckets']} buckets")
            fam[str(shape)] = per
        out[family] = fam
    out["scripts"] = {
        "comm_budget": run_script(checks, "comm_budget", [], timeout=420),
        "multihost_smoke": run_script(checks, "multihost_smoke", ["--device", "cuda"],
                                      timeout=300),
    }
    emit({"phase": "tp_train", **out, "card": smi})


def run_script(checks, name: str, argv, timeout: float) -> dict:
    """``python -m quantized_distillation_tpu_torch.scripts.<name>`` as a
    subprocess that must exit 0 → its return code and last lines."""
    try:
        r = subprocess.run([sys.executable, "-m", f"quantized_distillation_tpu_torch.scripts.{name}",
                            *argv], capture_output=True, text=True, timeout=timeout)
        rc, stdout, stderr = r.returncode, r.stdout, r.stderr
    except subprocess.TimeoutExpired as e:
        rc, stdout, stderr = "timeout", e.stdout or "", e.stderr or ""
        stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
        stderr = stderr.decode() if isinstance(stderr, bytes) else stderr
    checks.require(rc == 0, f"scripts.{name} exited {rc}: {stderr[-2000:]}")
    return {"rc": rc, "last_lines": stdout.strip().splitlines()[-8:]}


def shard_kernel_times(checks, args, params, points, group) -> dict:
    """The fused generator (uniform and LUT) at the shard widths of MG_SHAPES
    and of (4, 1) (320 rows at the whole vocab, phase 22's data-parallel
    mesh), one process on the card: against its plain version, and timed
    like phase 3 (kernel, plain version, one PyTorch call, bound)."""
    dev = torch.device("cuda")
    gk, gb = params["generator"]["kernel"], params["generator"]["bias"]
    gen = torch.Generator().manual_seed(args.seed + 50)
    out = {}
    for lut in (False, True):
        name = "dequant_matmul_topk_lut" if lut else "dequant_matmul_topk"
        for dp, mp in MG_SHAPES + ((4, 1),):
            full = pack_generator_sharded(gk, gb, args.bits, mp, points=points if lut else None)
            g = generator_shard(full, 0, mp).to(dev)
            rows = args.batch * args.beam // dp
            x = torch.randn(rows, g.shape[0], generator=gen).to(dev)
            stats = {str(cd): check_topk(checks, f"{name} shard {dp}x{mp}", x, g, args.beam, cd)
                     for cd in (torch.float32, torch.bfloat16)}
            g16 = dequantize_linear(g, torch.bfloat16)
            k = args.beam

            def library():
                logits = torch.matmul(x.to(torch.bfloat16), g16).float() + g.bias
                return torch.topk(logits, k), torch.logsumexp(logits, dim=-1)

            ms = graph_ms(lambda: dequant_matmul_topk(x, g, k, compute_dtype=torch.bfloat16))
            plain = graph_ms(lambda: dequant_matmul_topk_reference(
                x, g, k, compute_dtype=torch.bfloat16), calls=5)
            flops = 2.0 * rows * g.shape[0] * g.shape[1]
            byt = nbytes(x) + packed_bytes(g) + rows * (k * 8 + 4)
            bms, by = bound(flops, byt)
            out.setdefault(name, {})[f"{dp}x{mp}"] = {
                "M": rows, "K": g.shape[0], "N": g.shape[1], "ms": ms, "plain_ms": plain,
                "library_ms": graph_ms(library), "bound_ms": bms, "bound_by": by,
                "max_abs_err": stats[str(torch.bfloat16)]["max_abs_err"], "checks": stats,
            }
    return out


def mesh_graph_legs(checks, args, mesh):
    """(a) the KD steps on mesh (1, 1) over NCCL as CUDA graphs, each leg
    through :func:`graph_legs` (three eager runs and one graphed of
    ``args.train_steps`` steps from copies of one state, Adam with
    clipping): the seq2seq (teacher
    2x500 → ``args.preset``, V = ``args.vocab``, B = ``train_batch``, L =
    ``src_len``, dropout 0.3) data parallel with the bf16 gradient reduce,
    then tensor parallel on ``place_params_seq2seq`` shards in modes
    ``weights`` and ``joint``; the LM (2x650 → student_medium, V =
    ``lm_vocab``, B = ``lm_batch`` x ``lm_bptt``) tensor parallel with the
    carry threaded; WRN-28-10 → WRN-16-4 (B = ``vision_batch``) data
    parallel, its running statistics averaged over ``data`` in the graph.
    Graphed equal to eager bit for bit (the WRN under
    :func:`cudnn_deterministic`), one capture, one fake-quant launch a STE
    step and none in ``joint``, the eager step's collectives at every
    replay."""
    dev = torch.device("cuda")
    cfg = TrainConfig(learning_rate=1e-3, clip_norm=5.0)
    quant = QuantSpec(bits=args.bits)
    cb_quant = QuantSpec(bits=args.bits, method="codebook")

    def leg(name, task, state, batch, **kw):
        graph_legs(checks, f"mesh_{name}", task, tx, state, place_batch(batch, mesh, device=dev),
                   args.seed, args, mesh=mesh, **{"quant": quant, **kw})

    seed = args.seed + 80
    student, task, batch = kd_setup(args, dev, args.train_batch, seed, dropout=0.3)
    tx = build_optimizer(cfg)
    leg("dp_bf16", task, create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                            device=dev),
        batch, grad_reduce_dtype=torch.bfloat16, control=True)
    whole = dict(student.named_parameters())
    specs = placed_pspecs(whole, mesh)
    leg("tp_weights", task, create_train_state(place_params_seq2seq(whole, mesh, device=dev), tx,
                                               quant=quant, device=dev),
        batch, param_specs=specs)
    leg("tp_joint", task, create_train_state(place_params_seq2seq(whole, mesh, device=dev), tx,
                                             quant=cb_quant, mode="joint", mesh=mesh,
                                             param_specs=specs, device=dev),
        batch, param_specs=specs, quant=cb_quant, mode="joint", fq_per_step=0)
    del student, task, whole
    teacher = make_lm("teacher", args.lm_vocab, device=dev, seed=seed + 10)
    student = make_lm("student_medium", args.lm_vocab, device=dev, seed=seed + 11)
    whole = dict(student.named_parameters())
    leg("lm_tp", lm_task(student, teacher, thread_carry=True, device=dev),
        create_train_state(place_params_lm(whole, mesh, device=dev), tx, quant=quant,
                           carry=lm_initial_carry(student, args.lm_batch, teacher), device=dev),
        lm_batch(args.lm_batch, args.lm_vocab, args.lm_bptt, seed + 12, dev),
        param_specs=placed_pspecs(whole, mesh))
    del student, teacher, whole
    teacher = make_wrn("teacher", 100, device=dev, seed=seed + 20)
    student = make_wrn("student_medium", 100, device=dev, seed=seed + 21)
    with cudnn_deterministic():  # graphed must equal eager bit for bit
        leg("vision_dp", vision_task(student, teacher, device=dev),
            create_train_state(dict(student.named_parameters()), tx,
                               batch_stats=dict(student.named_buffers()), quant=quant,
                               device=dev),
            vision_batch(args.vision_batch, 32, 100, seed + 22, dev))


def mg_nccl(checks, args, model, params, points, smi) -> dict:
    """(a): NCCL at world size 1, mesh (1, 1), full width, in this process."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    src, src_len = serve_inputs(args)
    group = pick_generator_group(args.batch * args.beam)
    gk, gb = params["generator"]["kernel"], params["generator"]["bias"]
    steps = cfg.max_len
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    torch.distributed.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                         world_size=1, timeout=timedelta(seconds=MG_TIMEOUT))
    try:
        mesh = make_mesh(1, 1)
        out = {"backend": "nccl", "mesh": [1, 1], "graphed": capturable(mesh, dev)}
        checks.require(out["graphed"], "multi_gpu: the NCCL sharded search does not run graphed")
        searches = {}
        for label, kw in (("f32", dict(compute_dtype=torch.float32)),
                          ("lut_f32", dict(compute_dtype=torch.float32, points=points,
                                           lut_mode="exact"))):
            dec = pack_decoder(params, model.cfg, args.bits, generator_group=group, device=dev,
                               **kw)
            searches[label] = (dec, shard_decoder(dec, mesh, gk, gb))
        for label in ("f32", "lut_f32"):
            dec, sdec = searches[label]
            lut = label.startswith("lut")
            want = expected(**{"dequant_matmul_lut" if lut else "dequant_matmul": 3 * steps,
                               "dequant_matmul_topk_lut" if lut else "dequant_matmul_topk": steps,
                               "beam_advance": steps})
            res = {}
            for call in ("capture", "replay"):
                zero_counts()
                with collective_budget(mesh) as budget:
                    toks, scores = beam_search_sharded(model, sdec, src, src_len, cfg, mesh,
                                                       device=dev)
                launches = read_counts()
                checks.require(launches == want, f"multi_gpu {label} sharded search launches "
                                                 f"({call}) {launches}, expected {want}")
                res[call] = {"launches": launches, "all_gathers": budget.count("all-gather")}
                checks.require(budget.count("all-gather") > 0,
                               f"multi_gpu {label}: no all-gather recorded ({call})")
            e_toks, e_scores = beam_search_sharded(model, sdec, src, src_len, cfg, mesh,
                                                   device=dev, _eager=True)
            p_toks, p_scores = beam_search_packed(model, dec, src, src_len, cfg, device=dev)
            res["tokens_equal_unsharded"] = torch.equal(toks, p_toks)
            res["graph_equals_eager"] = torch.equal(toks, e_toks) and torch.equal(scores, e_scores)
            res["score_max_abs_diff"] = float((scores - p_scores).abs().max())
            checks.require(res["tokens_equal_unsharded"],
                           f"multi_gpu {label}: sharded tokens differ from beam_search_packed")
            checks.require(res["graph_equals_eager"],
                           f"multi_gpu {label}: graphed sharded search differs from eager")
            checks.require(res["score_max_abs_diff"] <= F32_TOL,
                           f"multi_gpu {label}: scores {res['score_max_abs_diff']} apart")
            out[label] = res
        # the engine on the mesh: 16 requests against the offline sharded search
        dec32, sdec32 = searches["f32"]
        n = 16
        sents = engine_sentences(n, args, torch.Generator().manual_seed(args.seed + 60))
        esrc = torch.zeros((n, args.src_len), dtype=torch.int64)
        for i, s in enumerate(sents):
            esrc[i, : len(s)] = torch.tensor(s)
        elen = torch.tensor([len(s) for s in sents])
        o_toks, _ = beam_search_sharded(model, sdec32, esrc, elen, cfg, mesh, device=dev)
        ecfg = ServeConfig(max_slots=8, max_src_len=args.src_len, max_tgt_len=steps, beam=cfg,
                           admit_batch=ADMIT_BATCH, chunk_steps=4)
        eng = TranslationEngine(model, ecfg, sdec32, mesh=mesh, device=dev)
        zero_counts()
        with collective_budget(mesh) as budget:
            res = serve_arrivals(eng, sents, {0: list(range(8)), 2: list(range(8, n))})
        e_launches = read_counts()
        equal = all((res[i].tokens == o_toks[i].cpu().numpy()).all() for i in range(n))
        checks.require(equal, "multi_gpu: the mesh engine's tokens differ from the offline "
                              "sharded search")
        checks.require(e_launches["dequant_matmul_topk"] > 0 and e_launches["beam_advance"] > 0,
                       f"multi_gpu engine launches {e_launches}")
        out["engine"] = {"requests": n, "tokens_equal_offline": equal, "launches": e_launches,
                         "all_gathers": budget.count("all-gather"), "graphed": eng._graph
                         is not None, "steps": eng.steps_run}
        # a full-width KD step with the bf16 reduce against the mesh-less step
        loss_m, params_m, fq_m, graphed_m = _mg_kd(args, dev, args.train_batch, args.seed + 10,
                                                   mesh, torch.bfloat16)
        loss_1, params_1, fq_1, _ = _mg_kd(args, dev, args.train_batch, args.seed + 10, None,
                                           None)
        checks.require(graphed_m, "multi_gpu KD bf16: the NCCL mesh step did not run graphed")
        excess = _params_excess(params_m, params_1, 0.05, 1e-4)
        checks.require(abs(loss_m - loss_1) <= LOSS_RTOL * abs(loss_1),
                       f"multi_gpu KD bf16 loss {loss_m} vs {loss_1}")
        checks.require(excess <= 1e-4, f"multi_gpu KD bf16 params {excess} past rtol 0.05")
        checks.require(fq_m == 1 and fq_1 == 1, f"multi_gpu KD fake-quant launches {fq_m}, {fq_1}")
        out["kd_bf16_reduce"] = {"batch": args.train_batch, "loss": loss_m,
                                 "mesh_less_loss": loss_1, "params_excess_over_rtol": excess,
                                 "fake_quant_launches": fq_m, "graphed": graphed_m}
        # the tensor-parallel step's code path at mesh (1, 1) against the
        # mesh-less step (one-rank collectives over NCCL)
        seed = args.seed + 70
        one = _tp_step(args, dev, "s2s", seed, None, False)
        tp1 = _tp_step(args, dev, "s2s", seed, mesh, True)
        tp_excess = _shard_excess(tp1["params"], tp1["mp"],
                                  {n: t.detach().cpu() for n, t in one["params"].items()}, dev)
        checks.require(abs(tp1["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"]),
                       f"multi_gpu TP (1, 1) loss {tp1['loss']} vs {one['loss']}")
        checks.require(tp_excess <= W_ATOL, f"multi_gpu TP (1, 1) params {tp_excess} past rtol")
        checks.require(tp1["launches"] == 1, f"multi_gpu TP (1, 1): {tp1['launches']} fake-quant "
                                             "launches")
        checks.require(tp1["graphed"], "multi_gpu TP (1, 1): the NCCL mesh step did not run graphed")
        checks.require(tp1["collectives"].get("reduce-scatter@unknown", 0) > 0,
                       "multi_gpu TP (1, 1): the TP path issued no reduce-scatter")
        out["kd_tp_1x1"] = {"batch": args.train_batch, "loss": tp1["loss"],
                            "mesh_less_loss": one["loss"], "params_excess_over_rtol": tp_excess,
                            "fake_quant_launches": tp1["launches"],
                            "collectives": tp1["collectives"], "graphed": tp1["graphed"]}
        mesh_graph_legs(checks, args, mesh)
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


def phase_multi_gpu(checks, args, model, params, points, smi) -> dict:
    """Phase 18: (a) NCCL at world size 1, (b) 4 ranks sharing the card over
    gloo, (c) 2 ranks over gloo, then the generator at the shard widths and
    (d) tensor-parallel training. Returns the generator rows' device times
    at the shard widths, by kernel."""
    a = mg_nccl(checks, args, model, params, points, smi)
    spec = {"args": vars(args), "group": pick_generator_group(args.batch * args.beam)}
    # the one-process f32 search, for a count of the sentences the sharded
    # search decodes alike (a candidate within an ulp or two of the beam's
    # last place may go either way: the sharded lse sums in another order;
    # the ranks' step checks hold the step itself)
    cfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    src, src_len = serve_inputs(args)
    dec32 = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.float32,
                         generator_group=spec["group"], device="cuda")
    want_toks = beam_search_packed(model, dec32, src, src_len, cfg, device="cuda")[0].cpu().numpy()
    del dec32
    ranks = run_ranks(_mg_serve_rank, 4, args=(spec,), timeout=MG_TIMEOUT, join_timeout=600)
    b = {}
    steps = args.src_len
    want = expected(dequant_matmul=3 * steps, dequant_matmul_topk=steps, beam_advance=steps)
    for shape in MG_SHAPES:
        key = str(shape)
        per = [r["shapes"][key] for r in ranks]
        equal = all(np.array_equal(p["tokens"], per[0]["tokens"])
                    and np.array_equal(p["scores"], per[0]["scores"]) for p in per)
        checks.require(equal, f"multi_gpu gloo {shape}: the ranks return different results")
        for r, p in enumerate(per):
            checks.require(p["launches"] == want, f"multi_gpu gloo {shape} rank {r} launches "
                                                  f"{p['launches']}, expected {want}")
            checks.require(not p["graphed"], "multi_gpu: a gloo search ran graphed")
        b[key] = {"ranks_equal": equal, "N": per[0]["N"], "rows": per[0]["rows"],
                  "sentences_equal_one_process": int(
                      (per[0]["tokens"] == want_toks).all(axis=1).sum()),
                  "sentences": len(want_toks),
                  "launches": [p["launches"] for p in per],
                  "all_gathers": [p["gathers"] for p in per],
                  "step": [p["step"] for p in per],
                  "kernel_max_abs_err": [{cd: k["max_abs_err"] for cd, k in p["kernel"].items()}
                                         for p in per],
                  "dequant_matmul_max_abs_err": [p["dequant_matmul"] for p in per],
                  "beam_advance_bit_exact": [p["beam_advance_bit_exact"] for p in per]}
    for r in ranks:
        checks.failed += r["failed"]
    train = run_ranks(_mg_train_rank, 2, args=(spec,), timeout=MG_TIMEOUT, join_timeout=600)
    for r, t in enumerate(train):
        checks.require(abs(t["loss"] - t["one_rank_loss"]) <= LOSS_RTOL * abs(t["one_rank_loss"]),
                       f"multi_gpu DP rank {r}: loss {t['loss']} vs {t['one_rank_loss']}")
        checks.require(t["params_excess"] <= W_ATOL,
                       f"multi_gpu DP rank {r}: params {t['params_excess']} past rtol {W_RTOL}")
        checks.require(t["fake_quant_launches"] == 1,
                       f"multi_gpu DP rank {r}: {t['fake_quant_launches']} fake-quant launches")
        checks.require(not t["graphed"], f"multi_gpu DP rank {r}: a gloo step ran graphed")
    shards = shard_kernel_times(checks, args, params, points, spec["group"])
    mg_tp_train(checks, args, smi)
    emit({"phase": "multi_gpu", "nccl": a, "gloo_serve": b, "gloo_dp_train": train,
          "shard_kernels": shards, "card": smi})
    return shards


# ------------------------------------------------------- quality scripts (19)

# Phase 19: the quality scripts on trained models, in this process through
# their main(argv): scripts/topk_divergence.py at the serving vocabulary and
# scripts/accuracy_grid.py --wrn at the JAX script's defaults, its WRN grid
# cut to QUALITY_WRN_DATA images: at its default 2,048 the WRN cells stay at
# chance and cost 140 s, so this grid is here for its launches and
# finiteness only (the default grid runs as its own command, README.md).
QUALITY_VOCAB = 32000
QUALITY_WRN_DATA = 256
TOPK_KEYS = ["vocab", "beam", "bits", "steps", "seeds", "per_step", "end_to_end",
             "f32_shared_rounding_unsound"]
GRID_KEYS = ["cnn_synthetic_cifar100", "wrn_synthetic_cifar100", "nmt_toy", "contract_checks"]
CNN_TEACHER_MIN_ACCURACY = 0.2  # chance is 0.01; the JAX package read 0.885 (BASELINE.md:159)
NMT_TEACHER_MIN_BLEU = 50.0  # the JAX package read 100.0 (BASELINE.md:70)
# the JAX package's own runs, printed beside the port's (not compared)
JAX_GRIDS = {
    "cnn_synthetic_cifar100": {
        "source": "BASELINE.md:155-163, JAX package on the CPU, the script's defaults",
        "teacher_acc": 0.885, "cells": {
            "student_small@fp32": 0.574, "student_small@8": 0.565, "student_small@4": 0.553,
            "student_small@2": 0.528, "student_medium@fp32": 0.878, "student_medium@8": 0.869,
            "student_medium@4": 0.855, "student_medium@2": 0.803}},
    "wrn_synthetic_cifar100": {
        "source": "BASELINE.md:141-149, JAX package on a TPU, 4096 images, teacher 40 and "
                  "students 30 epochs (not the defaults)",
        "teacher_acc": 0.759, "cells": {
            "student_small@fp32": 0.925, "student_small@4": 0.927, "student_small@2": 0.941,
            "student_medium@fp32": 0.931, "student_medium@4": 0.932,
            "student_medium@2": 0.930}},
    "nmt_toy": {
        "source": "BASELINE.md:68-75, JAX package on the CPU, the script's defaults",
        "teacher_bleu": 100.0, "cells": {
            "narrow_64h@fp32": 99.3, "narrow_64h@4": 98.0, "narrow_64h@2": 96.2,
            "wide_128h@fp32": 99.3, "wide_128h@4": 100.0, "wide_128h@2": 99.9}},
}
JAX_TOPK = {"source": "BASELINE.md:375-381, JAX package on a TPU, V = 32000, slots 2",
            "rows": 6718, "topk_set_mismatch_rate": 0.0231, "top1_mismatch_rate": 0.00089,
            "mismatch_value_gap_rel_max": 0.0019, "token_agreement_min": 0.9984,
            "bleu": "fused equal to exact on 3 seeds"}


def grid_fake_quant_launches(a) -> dict:
    """Fake-quant launches of ``scripts.accuracy_grid`` at the flags ``a``,
    by grid, as its code implies: one a quantized student's STE step (full
    batches), one a quantized eval batch (the last may be short), and one a
    quantized NMT deploy (``quantize_tree_hard``'s single launch); the
    teachers and the FP students none."""
    def vision(n_data, n_bits):  # two student presets
        n_train = len(load_cifar(100, True, accuracy_grid.NO_DATA_DIR, n_data, a.seed).labels)
        n_test = len(load_cifar(100, False, accuracy_grid.NO_DATA_DIR, n_data // 4,
                                a.seed).labels)
        return 2 * n_bits * (a.epochs * (n_train // a.batch) + math.ceil(n_test / a.batch))

    corpus = toy_corpus(n=a.nmt_data, vocab_size=200, min_len=5, max_len=9, seed=a.seed)
    steps = sum(1 for e in range(a.nmt_epochs)
                for _ in nmt_batches(corpus, a.batch, seed=e, drop_remainder=True))
    return {"cnn": 0 if a.skip_cnn else vision(a.cnn_data, 3),
            "wrn": vision(a.wrn_data, 2) if a.wrn else 0,
            "nmt": 0 if a.skip_nmt else 4 * (steps + 1)}


def run_main(module, argv, report) -> tuple:
    """``module.main(argv, report=report)`` in this process with the
    counters at 0 → (its return code, its last stdout line as JSON, the
    other stdout lines, the launches)."""
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv, report=report)
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), lines[:-1], read_counts()


def quality_topk(checks, smi):
    """``topk_divergence --vocab 32000`` (see the module docstring, phase
    19)."""
    report = {}
    rc, out, _, launches = run_main(
        topk_divergence, ["--vocab", str(QUALITY_VOCAB)], report)
    ex = out["per_step"]["exact"]
    checks.require(rc == 0 and list(out) == TOPK_KEYS and list(out["per_step"]) == ["exact"],
                   f"topk_divergence: rc {rc}, keys {list(out)}, per_step {list(out['per_step'])}")
    checks.require(ex["mismatch_value_gap_rel_max"] <= topk_divergence.BF16_NOISE_REL,
                   f"topk_divergence: a bf16 mismatch {ex['mismatch_value_gap_rel_max']} past "
                   f"{topk_divergence.BF16_NOISE_REL} relative")
    checks.require(report["f32_mismatch_past_bound"] == 0,
                   f"topk_divergence: {report['f32_mismatch_past_bound']} f32-control "
                   f"mismatches past {report['f32_noise_rel']}")
    bleus = [r[k] for r in out["end_to_end"] for k in ("bleu_fused", "bleu_exact")]
    checks.require(all(map(math.isfinite, bleus)), f"topk_divergence: BLEU {bleus}")
    # a decode step: a dequant-matmul for each LSTM layer and attn_out, 1
    # generator and 1 advance in the fused search; one more dequant-matmul
    # (the logits) and no generator in the exact one; the walks (the deploy
    # on every seed, the f32 control on the first) both paths' kernels
    dm = SEQ2SEQ_PRESETS[topk_divergence.PRESET]["num_layers"] + 1
    n = out["seeds"] * out["steps"]
    walk = (out["seeds"] + 1) * out["steps"]
    searches = {"fused": {"dequant_matmul": dm * n, "dequant_matmul_topk": n, "beam_advance": n},
                "exact": {"dequant_matmul": (dm + 1) * n}}
    want = expected(dequant_matmul=(2 * dm + 1) * n + (dm + 1) * walk,
                    dequant_matmul_topk=n + walk, beam_advance=n)
    got = {name: path_counts(c) for name, c in report["search_launches"].items()}
    checks.require(got == searches and launches == want,
                   f"topk_divergence launches: searches {report['search_launches']}, expected "
                   f"{searches}; run {launches}, expected {want}")
    emit({"phase": "quality", "script": "topk_divergence", "rc": rc,
          "train_losses": report["train_losses"],
          "vocab": out["vocab"], "per_step": ex, "end_to_end": out["end_to_end"],
          "f32_control": {"mismatches": out["f32_shared_rounding_unsound"],
                          "past_bound": report["f32_mismatch_past_bound"],
                          "bound_rel_row_scale": report["f32_noise_rel"],
                          "largest_gap_rel_row_scale":
                              report["f32_mismatch_value_gap_scaled_max"]},
          "bf16_noise_rel": report["bf16_noise_rel"],
          "search_launches_per_step": {k: {c: v / n for c, v in d.items()}
                                       for k, d in report["search_launches"].items()},
          "launches": launches, "jax_package_reference": JAX_TOPK, "card": smi})


def quality_grid(checks, smi):
    """``accuracy_grid --wrn`` at the JAX script's defaults but
    QUALITY_WRN_DATA WRN images (see the module docstring, phase 19)."""
    argv = ["--wrn", "--wrn-data", str(QUALITY_WRN_DATA)]
    want = grid_fake_quant_launches(accuracy_grid.parse_args(argv))
    report = {}
    rc, out, _, launches = run_main(accuracy_grid, argv, report)
    checks.require(rc == 0 and list(out) == GRID_KEYS, f"accuracy_grid: rc {rc}, keys {list(out)}")
    for key, label in (("cnn_synthetic_cifar100", "cnn"), ("wrn_synthetic_cifar100", "wrn"),
                       ("nmt_toy", "nmt")):
        g = out[key]
        hi = 100.0 if label == "nmt" else 1.0
        values = [g["teacher_bleu" if label == "nmt" else "teacher_acc"], *g["cells"].values()]
        checks.require(all(math.isfinite(v) and 0.0 <= v <= hi for v in values),
                       f"accuracy_grid {label}: values {values} not finite in [0, {hi}]")
        got = path_counts(report[label]["launches"])
        checks.require(got == ({"fake_quant_buckets": want[label]} if want[label] else {}),
                       f"accuracy_grid {label}: launches {got}, expected {want[label]} fake-quant")
        emit({"phase": "quality", "script": "accuracy_grid", "grid": key, "flags": argv, **g,
              "fake_quant_launches": got.get("fake_quant_buckets", 0),
              "expected_launches": want[label], "jax_package_run": JAX_GRIDS[key],
              "card": smi})
    tacc, tbleu = out["cnn_synthetic_cifar100"]["teacher_acc"], out["nmt_toy"]["teacher_bleu"]
    checks.require(tacc >= CNN_TEACHER_MIN_ACCURACY,
                   f"accuracy_grid: CNN teacher accuracy {tacc} < {CNN_TEACHER_MIN_ACCURACY}")
    checks.require(tbleu >= NMT_TEACHER_MIN_BLEU,
                   f"accuracy_grid: NMT teacher BLEU {tbleu} < {NMT_TEACHER_MIN_BLEU}")
    checks.require(launches == expected(fake_quant_buckets=sum(want.values())),
                   f"accuracy_grid launches {launches}, expected {sum(want.values())} fake-quant")
    # the paper's orderings are reported, not gated: the JAX run at these
    # defaults breaks its own cnn_4bit_within_2pts_of_fp (0.574 → 0.553)
    emit({"phase": "quality", "script": "accuracy_grid", "rc": rc,
          "contract_checks": out["contract_checks"], "card": smi})


def phase_quality(checks, smi):
    """Phase 19: the two quality scripts."""
    quality_topk(checks, smi)
    quality_grid(checks, smi)


# -------------------------------------------------------- graft entry (20)

GRAFT_GLOO_RANKS = 4  # dryrun_multichip over gloo: mesh (2, 2), 4 ranks sharing the card


def graft_dryrun(checks, label: str, n: int, step_seconds: float, dropout) -> dict:
    """``graft_entry.dryrun_multichip(n)`` on the card (without the
    multi-process smoke: phase 18 runs the same command) → its report (None
    where it raised), with each rank's launches checked (one fake-quant a
    KD step, the one-layer toy student's search: 2 dequant-matmul, 1
    generator, 1 advance a step; and decode step) and its results held to
    the same dry run on the CPU (:func:`graft_vs_cpu`)."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            report = graft_entry.dryrun_multichip(n, step_seconds=step_seconds, dropout=dropout,
                                                  dcn_smoke=False)
        report["vs_cpu"] = graft_vs_cpu(checks, label, report, dropout)
    except Exception:  # recorded: the phase reports what else it can
        checks.require(False, f"graft {label}: dryrun_multichip({n}) raised:\n"
                              f"{traceback.format_exc()}\n{out.getvalue()}")
        return None
    report["dropout"] = dropout
    report["lines"] = out.getvalue().splitlines()
    steps = graft_entry.SEARCH.max_len
    dm = SEQ2SEQ_PRESETS["student_small"]["num_layers"] + 1
    want = {"f32": {"fake_quant_buckets": 1}, "reduced": {"fake_quant_buckets": 1},
            "search": {"dequant_matmul": dm * steps, "dequant_matmul_topk": steps,
                       "beam_advance": steps},
            "decode_step": {"dequant_matmul": dm, "dequant_matmul_topk": 1}}
    for r, launches in enumerate(report["launches"]):
        launches = {key: path_counts(c) for key, c in launches.items()}
        checks.require(launches == want, f"graft {label} rank {r}: launches {launches}, "
                                         f"expected {want}")
    checks.require(report["backend"] == label, f"graft {label}: backend {report['backend']}")
    nccl = report["backend"] == "nccl"
    checks.require(report["graphed"] == [nccl] * n,
                   f"graft {label}: graphed steps {report['graphed']} over {report['backend']}")
    checks.require(all(math.isfinite(x) for xs in report["losses"].values() for x in xs),
                   f"graft {label}: losses {report['losses']}")
    proj = [line for line in report["lines"] if "1->2 host projection" in line]
    checks.require(len(proj) == 4 and all(report["card"] in line for line in proj),
                   f"graft {label}: projection lines {proj} do not name the card")
    checks.require(not any("TPU" in line or "bench_flagship_train" in line
                           for line in report["lines"]), f"graft {label}: a TPU figure printed")
    return report


def graft_vs_cpu(checks, label: str, report: dict, dropout) -> dict:
    """The card's dry run against the same one on the CPU (gloo ranks,
    every kernel's plain version, the same seeded weights): each rank's
    search tokens equal and scores within ``F32_TOL`` (rtol = atol), and
    at dropout 0 each rank's loss with the f32 and the reduced gradient
    reduce too → the largest differences."""
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = graft_entry.dryrun_multichip(report["n"], device="cpu", dropout=dropout,
                                           dcn_smoke=False)
    pairs = list(zip(report["search"], cpu["search"]))
    tokens_equal = all(np.array_equal(c["tokens"], h["tokens"]) for c, h in pairs)
    checks.require(tokens_equal, f"graft {label}: the card's search tokens differ from the CPU's")
    scores_ok = all(np.allclose(c["scores"], h["scores"], rtol=F32_TOL, atol=F32_TOL)
                    for c, h in pairs)
    score_err = max(float(np.abs(c["scores"] - h["scores"]).max()) for c, h in pairs)
    checks.require(scores_ok, f"graft {label}: search scores card vs CPU max |diff| {score_err}")
    out = {"tokens_equal": tokens_equal, "scores_max_abs": score_err}
    if dropout == 0.0:  # with dropout the card's and the host's masks differ
        losses = [(a, b) for key in ("f32", "reduced")
                  for a, b in zip(report["losses"][key], cpu["losses"][key])]
        checks.require(all(math.isclose(a, b, rel_tol=F32_TOL, abs_tol=F32_TOL)
                           for a, b in losses),
                       f"graft {label}: losses card vs CPU {losses}")
        out["losses_max_abs"] = max(abs(a - b) for a, b in losses)
    return out


def phase_graft(checks, smi):
    """Phase 20: ``graft_entry.entry()`` eager and as a CUDA graph against
    a CPU run of the same forward, then ``dryrun_multichip`` over NCCL (one
    rank a card) and over gloo (4 ranks sharing the card), both projecting
    from the flagship step measured on the card
    (``graft_entry.measure_flagship_step``)."""
    fn, example = graft_entry.entry()
    params, *inputs = example
    zero_counts()
    with torch.no_grad():
        eager = fn(*example)
    eager_launches = read_counts()
    call = graft_entry.graphed_entry(fn, example)  # the capture counts nothing
    zero_counts()
    graphed = call(*params.values(), *inputs)[0]
    graph_launches = read_counts()
    cpu_fn, (_, *cpu_inputs) = graft_entry.entry(device="cpu")
    with torch.no_grad():
        cpu = cpu_fn({n: t.cpu() for n, t in params.items()}, *cpu_inputs)
    err = float((eager.cpu() - cpu).abs().max())
    one = expected(fake_quant_buckets=1)
    checks.require(eager_launches == one and graph_launches == one,
                   f"graft entry launches eager {eager_launches}, graph {graph_launches}, "
                   f"expected {one}")
    bit_equal = torch.equal(graphed, eager)
    checks.require(bit_equal, "graft entry: the graphed forward is not bit-equal to the eager one")
    checks.require(err <= F32_TOL, f"graft entry: card vs CPU max |diff| {err} > {F32_TOL}")
    shape = tuple(eager.shape)
    del fn, example, params, inputs, eager, graphed, call, cpu_fn, cpu_inputs, cpu
    step_seconds = graft_entry.measure_flagship_step()

    # the NCCL run at the preset's dropout (the JAX function's call), the
    # gloo one at 0 so that its losses hold to the CPU's too
    runs = {"nccl": graft_dryrun(checks, "nccl", torch.cuda.device_count(), step_seconds, None),
            "gloo": graft_dryrun(checks, "gloo", GRAFT_GLOO_RANKS, step_seconds, 0.0)}
    done = {k: r for k, r in runs.items() if r is not None}
    if "gloo" in done:
        checks.require(done["gloo"]["mesh"] == {"data": 2, "model": 2},
                       f"graft gloo: mesh {done['gloo']['mesh']}")
    emit({"phase": "graft", "entry": {"shape": shape, "dtype": "float32",
                                      "launches_eager": eager_launches["fake_quant_buckets"],
                                      "launches_graph": graph_launches["fake_quant_buckets"],
                                      "graph_bit_equal_eager": bit_equal, "card_vs_cpu_max_abs": err},
          "dryrun": {k: {key: r[key] for key in ("n", "mesh", "backend", "rule", "dropout", "loss",
                                                  "losses", "graphed", "vs_cpu", "payloads",
                                                  "projection", "step_seconds")}
                     for k, r in done.items()},
          "budgets": {k: {key: budget_summary(b) for key, b in r["budgets"].items()}
                      for k, r in done.items()},
          "card": smi})


# ------------------------------------------------------------- bench (21)

BENCH_CHAINS = ["--lo", "1", "--hi", "2", "--trials", "1"]
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]  # bench.py:18
BENCH_ENGINE_KEYS = BENCH_KEYS + [  # bench.py:423-448
    "offline_same_process_tokens_per_s", "vs_offline_same_process", "occupancy_at_0.9_load",
    "steady_state_occupancy", "offered_load", "arrival", "stage_ahead", "requests_churned",
    "idle_frac_queue_empty", "idle_frac_midchunk_est"]
FLAGSHIP_KEYS = ["workload", "device", "card", "train_step_seconds", "fp32_step_seconds",
                 "grad_payload_f32_bytes", "written_by", "timestamp"]  # bench.py:226-236 + card
BENCH_RUNS = {"serve": [], "engine": ["--engine"],
              **{f"train_{f}": ["--train", "--family", f] for f in ("seq2seq", "wrn", "lm")}}


def bench_run(checks, label: str, flags, units: int, step_launches: dict) -> dict:
    """``bench.main(BENCH_CHAINS + flags)`` → its line and launches, with
    the line's keys and values checked and the launches
    held to ``units`` (the 4-bit or packed units the run chains) times
    ``step_launches`` (the engine: its 3 / 1 / 1 ratio)."""
    zero_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            line = bench.main(BENCH_CHAINS + flags)
    except Exception:  # recorded: the phase reports what else it can
        checks.require(False, f"bench {label}: raised\n{traceback.format_exc()}")
        return {"line": None, "launches": {}}
    launches = read_counts()
    keys, positive = BENCH_KEYS, ["value", "vs_baseline"]
    if label == "engine":  # vs_baseline is null without --offline-tok-s
        keys, positive = BENCH_ENGINE_KEYS, ["value", "offline_same_process_tokens_per_s",
                                             "vs_offline_same_process", "occupancy_at_0.9_load",
                                             "steady_state_occupancy"]
    checks.require(list(line) == keys, f"bench {label}: keys {list(line)}, expected {keys}")
    values = {k: line.get(k) for k in positive}
    checks.require(all(isinstance(v, float) and math.isfinite(v) and v > 0
                       for v in values.values()),
                   f"bench {label}: values {values} not finite and positive")
    if label == "engine":
        k = launches["dequant_matmul_topk"]
        want = expected(dequant_matmul=3 * k, dequant_matmul_topk=k, beam_advance=k)
        checks.require(k > 0 and launches == want,
                       f"bench engine launches {launches}: not 3 / 1 / 1 a step")
    else:
        want = expected(**{n: units * c for n, c in step_launches.items()})
        checks.require(launches == want, f"bench {label} launches {launches}, expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"line": line, "launches": launches}


def bench_topk(checks, rows: int, width: int, k: int) -> dict:
    """``topk_sorted`` on the card at [rows, width] with ties, -inf runs and
    ±0 against ``torch.sort(stable=True)``, and its device ms against the
    sort's and one ``torch.topk``'s."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.round(torch.randn(rows, width, device="cuda", generator=gen) * 8) / 8  # ties
    x[0] = -math.inf
    x[1, : width // 2] = -math.inf
    x[2] = torch.where(x[2] > 0, 0.0, -0.0)  # ±0 only
    x[3, ::7] = x[3].max()  # the row's largest value many times over
    sort_v, sort_i = torch.sort(x, dim=-1, descending=True, stable=True)
    with torch.no_grad():
        v, i = topk_sorted(x, k)
    idx_equal = torch.equal(i, sort_i[:, :k])
    val_equal = torch.equal(v.view(torch.int32), sort_v[:, :k].contiguous().view(torch.int32))
    checks.require(idx_equal and val_equal,
                   f"topk_sorted at [{rows}, {width}] differs from the stable sort "
                   f"(indices equal {idx_equal}, values {val_equal})")
    ms = graph_ms(lambda: topk_sorted(x, k))
    sort_ms = graph_ms(lambda: torch.sort(x, dim=-1, descending=True, stable=True))
    library_ms = graph_ms(lambda: torch.topk(x, k, dim=-1))
    read_ms, _ = bound(0, x.numel() * x.element_size())
    return {"shape": [rows, width], "k": k, "indices_equal": idx_equal, "values_equal": val_equal,
            "ms": ms, "stable_sort_ms": sort_ms, "torch_topk_ms": library_ms,
            "bound_ms_read_once": read_ms}


def phase_bench(checks, args, smi):
    """Phase 21 (see the module docstring)."""
    steps = args.src_len
    search = {"dequant_matmul": 3 * steps, "dequant_matmul_topk": steps, "beam_advance": steps}
    ns = bench.parse_args(BENCH_CHAINS)
    units = (ns.lo + ns.hi) * (1 + ns.trials)  # warm-up chains, then each trial's
    runs = {}
    for label, flags in BENCH_RUNS.items():
        per_unit = search if label == "serve" else {"fake_quant_buckets": 1}
        runs[label] = bench_run(checks, label, flags, units, per_unit)
    record = None
    if bench.FLAGSHIP_FILE.exists():
        record = json.loads(bench.FLAGSHIP_FILE.read_text())
    checks.require(record is not None and list(record) == FLAGSHIP_KEYS
                   and record["card"] == smi and record["train_step_seconds"] > 0,
                   f"bench flagship record {record}")

    # the bench's own serving loops: launches of one chain
    fp_loop, q_loop = bench.build(bench.parse_args([]))
    loops = {}
    for name, loop, n, per_search in (("packed", q_loop, 3, search), ("dense_fp32", fp_loop, 2,
                                                                        {})):
        float(loop(1))  # captures the search's graph
        zero_counts()
        float(loop(n))
        launches = read_counts()
        want = expected(**{c: n * m for c, m in per_search.items()})
        checks.require(launches == want, f"bench {name} chain of {n}: launches {launches}, "
                                         f"expected {want}")
        loops[name] = {"chain": n, "launches": launches}
    del fp_loop, q_loop
    gc.collect()
    torch.cuda.empty_cache()
    topk = bench_topk(checks, args.batch, args.beam * args.vocab, args.beam)
    emit({"phase": "bench", "flags": BENCH_CHAINS,
          "runs": {label: {"keys": list(r["line"] or {}), "launches": r["launches"]}
                   for label, r in runs.items()},
          "flagship_record_keys": list(record or {}), "loops": loops, "topk_sorted": topk,
          "card": smi})


# ------------------------------------------------------------ multi-card (22)

MULTI_CARDS = 4


def phase_multi_card(checks, smi) -> dict:
    """Phase 22 (see the module docstring) → each kernel's launches a rank,
    by mesh and search, as its line prints them; empty where it did not
    run."""
    n = torch.cuda.device_count()
    if n < MULTI_CARDS:
        emit({"phase": "multi_card", "ran": False, "cards": n})
        return {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_multicard_"))
    try:
        res = run_script(checks, "multicard_smoke",
                         ["--cards", str(MULTI_CARDS), "--out", str(root / "report.json")],
                         timeout=3000)
        report = json.loads((root / "report.json").read_text()) if res["rc"] == 0 else None
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {}
    for mesh, s in (report or {}).get("searches", {}).items():
        for label in ("f32", "bf16", "lut_f32"):
            for name in expected():
                per = [r[name] for r in s[label]["launches_a_rank"]]
                if any(per):
                    launches.setdefault(name, {})[f"{mesh} {label}"] = per
        if "engine" in s:
            for name in expected():
                per = [r[name] for r in s["engine"]["launches_a_rank"]]
                if any(per):
                    launches.setdefault(name, {})[f"{mesh} engine"] = per
    for leg, rec in (report or {}).get("train", {}).items():
        if rec["launches"]["fake_quant_buckets"]:
            launches.setdefault("fake_quant_buckets", {})[f"{leg} rank 0"] = \
                rec["launches"]["fake_quant_buckets"]
    emit({"phase": "multi_card", "ran": True, "cards": n, "rc": res["rc"],
          "last_lines": res["last_lines"], "launches": launches, "card": smi})
    return launches


def budget_summary(budget) -> dict:
    """Wire bytes by axis and collectives by kind of a ``CommBudget``."""
    kinds = {}
    for op in budget.ops:
        kinds[f"{op.kind}@{op.axis}"] = kinds.get(f"{op.kind}@{op.axis}", 0) + 1
    return {"wire_bytes_by_axis": budget.bytes_by_axis(), "collectives": kinds}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="student_medium")
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--src-len", type=int, default=24)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-sentences", type=int, default=16)
    ap.add_argument("--train-batch", type=int, default=128)
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--parity-batch", type=int, default=8)
    ap.add_argument("--vision-batch", type=int, default=256)
    ap.add_argument("--lm-batch", type=int, default=256)
    ap.add_argument("--lm-vocab", type=int, default=10000)
    ap.add_argument("--lm-bptt", type=int, default=35)
    ap.add_argument("--cnn-batch", type=int, default=128)
    ap.add_argument("--resnet-batch", type=int, default=64)
    ap.add_argument("--family-parity-batch", type=int, default=4)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    dev, smi = phase_device()
    # f32 matmuls (the f32 parity runs) in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = Checks()
    phase_build(checks)
    phase_sass(checks)
    model = make_seq2seq(args.preset, args.vocab, args.vocab, device="cuda", seed=args.seed)
    params = params_to_numpy(model)
    rows = args.batch * args.beam
    group = pick_generator_group(rows)
    dec = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.bfloat16,
                       generator_group=group, device="cuda")
    table = phase_kernels(checks, dec, rows, torch.Generator().manual_seed(args.seed + 2))
    phase_main_path(checks, args, model, params, smi)
    phase_engine(checks, args, model, params, dec, smi)
    del dec
    fq_row, train_state = phase_train(checks, args, smi)
    table.append(fq_row)
    phase_grouped_kernel(checks, args.seed + 5)
    phase_lstm_kernel(checks, args)

    books = phase_codebook_train(checks, args, smi)
    points = books["generator/kernel"].cpu()
    dec = pack_decoder(params, model.cfg, args.bits, points=points, lut_mode="exact",
                       compute_dtype=torch.bfloat16, generator_group=group, device="cuda")
    table += phase_lut_kernels(checks, dec, rows, torch.Generator().manual_seed(args.seed + 4))
    del dec
    phase_codebook_path(checks, args, model, params, points, smi)
    phase_engine_lut(checks, args, model, params, points, smi)
    phase_artifact(checks, args, model, books, train_state, smi)
    del train_state
    phase_vision_train(checks, args, smi)
    phase_lm_train(checks, args, smi)
    phase_vision_families(checks, args, smi)
    phase_drivers(checks, args, smi)
    shards = phase_multi_gpu(checks, args, model, params, points, smi)
    for row in table:
        if row["name"] in shards:
            row["shard_widths"] = shards[row["name"]]
    phase_quality(checks, smi)
    phase_graft(checks, smi)
    phase_bench(checks, args, smi)
    phase_multi_card(checks, smi)
    if checks.failed:
        print(f"{len(checks.failed)} check(s) failed", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
