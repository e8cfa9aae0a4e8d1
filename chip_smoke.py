#!/usr/bin/env python3
"""Drives the PyTorch/H100 port of GLASS, serving, training and the
experiment CLI, on one CUDA card and checks it.

Run from the root of the repository, on a machine with one card:

    python3 chip_smoke.py

Phases, one printed line each:
  1. device  — no CUDA means a non-zero exit; prints the card's name and
               power limit as nvidia-smi gives them.
  2. build   — compiles every CUDA source of glass_tpu_torch/csrc with nvcc
               (one process per source, all started together).
     native — the host library (native/glass_host.cpp, built by g++ into
               build/glass_tpu_torch/) loaded, or the run fails; on the
               em_user stand-in its RCM order twice, equal (and the share of
               positions scipy's order, the fallback, agrees on), and the
               CSR, band and BCSR builds against the numpy branches,
               byte-equal, each timed.
     probe_small — the HBM read probes (csrc/hbm_probe.cu, both TPU bodies
               of tools/hbm_probe.py) against their plain versions,
               bit-equal, repeats bit-identical, at S 1-8, three chunk sizes
               and iters 1 and 3;
     probe_main — tools/torch_hbm_probe.py's probes at 512 MiB: GB/s and
               the share of 3.35 TB/s of the copy probe, read at S 1-8 and
               read2 at S 2 and 4.
  3. kernel vs plain, small layout — the f32 BCSR kernel (3xTF32 over the
               live blocks) against its plain PyTorch version on a layout
               with empty row blocks, CHUNK padding and a row of more than 8
               nonzero blocks and on one whose values span 2^-20 to 2^4,
               with f32 and bf16 x, at H = 17 and 128; and a small GLASS on
               the card against the same model on the CPU.
  4. main path at the em_user configuration (glass_tpu/configs/em_user.yml)
     on a 57,344-node, 9M-edge stand-in graph (the recipe of
     bench.py::clustered_graph): the graph build; the kernel against its
     plain version, timed beside torch.sparse.mm, also at component's H =
     17; then requests of 1, 6 and 64 subgraphs served through Predictor,
     each sent twice (a bucket's first call runs eagerly and captures its
     program, the second replays it: serve_requests), the card's launches
     read around them against the captures' counts, the replay checked
     bit-identical to the first call and the logits checked against the
     independent "segment" SpMM mode; train_bcsr — Trainer epochs of the
     em_user configuration on the same BCSR layout (the BCSR backward at
     full scale), 2 BCSR launches per conv layer and step, losses falling.
  5. the band kernel and the backward passes on small layouts:
     kernel_band_small — the band kernel (f32 slabs: 3xTF32 on the tensor
               cores) against its plain version at H = 17, 64 and 128 on an
               affine layout (negative offset, bottom overhang), a
               per-group layout (the affine gate rejects a piecewise
               profile), a layout with empty groups and n % 128 != 0 and
               one whose values span 2^-20 to 2^4, each call repeated
               bit-identically;
     grad_small — on an asymmetric ("mean") graph, dx through each kernel's
               autograd Function against dx through its plain version's
               autograd, band and BCSR;
     train_small — a small GLASS trained 3 steps on the card and on the CPU
               with dropout 0, band and BCSR, losses and parameters compared.
  6. the training path at the em_user configuration on the same stand-in
     graph, banded-slab layout at the planner's rps, window and affine law
     (EM_USER_BAND_LAW): graph_band (the build), kernel_band_main
     (the kernel against its plain version at H = 17, 64 and 128, timed at
     64 beside torch.sparse.mm and its bounds: FMA, 3xTF32 and the lesser),
     train (Trainer epochs with em_user's dropout, batch and
     lr on synthetic subgraphs labelled by size, the band kernel's launches
     read around them: 2 per conv layer and step), request_band (requests
     served on the band graph, checked as in 4).
  7. mixed precision, small: kernel_q_small — every bf16 and int8
     instantiation of both kernels (the TMA + wgmma pipeline) against its
     plain version (band: bf16 and int8 slabs x f32 and bf16 x on the
     layouts of 5 at H = 17, 64, 128; BCSR: bf16 and int8 blocks on the
     layout of 3; the int8 dense kernel, csrc/dense_q_spmm.cu, at n = 700
     and 1,100 with an all-zero row, H = 17, 64 and 200, f32 and bf16 x,
     one CTA per output tile over the whole k window), each call repeated
     bit-identically; grad_q_small — dx through each autograd
     Function against the plain autograd on an asymmetric graph, in x's
     dtype; train_q_small — 3 steps card vs CPU with bf16 compute on int8
     and bf16 adjacencies.
  8. the em_user path in mixed precision (dense_dtype "int8", compute_dtype
     "bfloat16") on the stand-in: graph_band_q (the planner's rps 1,
     window 3, clo = g - 1), kernel_band_q_main, train_q
     (2 int8-band launches per step and no other SpMM kernel, losses falling,
     micro-F1 beside the f32 run's), request_band_q (requests against the
     f32 "segment" model with the same weights, within the JAX package's own
     bf16 bound); then the bf16 band and the int8 BCSR layouts at the
     em_user shape: kernel_band_bf16_main, kernel_bcsr_q_main and requests
     served on each.
  9. the dense route at hpo scale (glass_tpu/configs/hpo_metab.yml on the
     14,587-node, 2.6M-edge recipe of bench.py::hpo_graph, dense_dtype
     "int8"): graph_dense_q (dense_q built, dense_q_t is dense_q),
     kernel_dense_q_main (the TMA + wgmma kernel of csrc/dense_q_spmm.cu
     beside its bound and torch.matmul of q's bf16 copy, then the scale),
     train_dense_q (6 synthetic classes, ce loss, 2 launches per step and
     no band kernel), then eval_graph and request_graph on that model (as
     in 10b).
 9b. the layout planner (phases 1-9 force their layouts):
     planner_rates — the rates the calibration does not fit: torch.matmul
               at the hpo shape (f32, bf16), the "segment" SpMM at em_user,
               and the card's fill (the band kernel alone against a busy
               card at 32-96 and 448 row blocks);
     autotune — ensure_autotune on the card into a temporary file (the
               CLI's --autotune), the fitted constants printed, the em_user
               stand-in planned under them;
     planner_main — the planner's choice (kind, rps, window, modeled costs)
               on the em_user and hpo stand-ins, f32 and int8, built as the
               protocol's "pallas" route builds them, each kernel of the
               chosen layout against its plain version and the SpMM timed;
               on hpo one training epoch, its launches those of the chosen
               layout, and the layout ranked next built and timed;
     hybrid_main — the em_user stand-in plus 8,000 far edges between the
               first and last communities with sparse_layout="hybrid": the
               band carries the bulk, the per-group band kernel and the BCSR
               residue held against their plain versions and timed, 2 band
               and 2 BCSR launches per training step, requests within rtol
               1e-4 of the "segment" mode.
 10. the fused GraphNorm (glass_tpu_torch/csrc/graph_norm.cu; phases 1-9
     run with GLASS_TPU_FUSED_NORM=0, the JAX package's default):
     kernel_norm_small — each of the five passes against its plain version
               (the reductions' sums and every derived vector each within
               KERNEL_TOL of its own max; K3 and K5 bit-equal) at N in (1,
               3001, 1000, 3001), F in (17, 64, 200), f32 and bf16 x with a
               zero-variance column, and at component's 17,260 x 17, repeats
               bit-identical, the second N = 3001 (after other N, so
               another P) bit-equal to the first; x and dy as views one
               element into their buffers (the one-value path); 1 x 514
               and 3 x 1025 (a column period longer than its chunks' CTAs);
               the autograd Function against the plain Function and the
               unfused graph_norm's autograd (at N = 1 its dx against the
               exact f64 gradient, within 16 f32 roundings of the
               formula's own terms times the variance's condition, plus
               one rounding to x's dtype: dx_error_bound);
     norm_dx_draws — that N = 1 check on 8 draws of each F (17, 64, 200)
               in f32 and bf16;
     kernel_norm_main — each pass at the em_user shape (57,344 x 64), f32
               and bf16 (K3 and K5 also at 17,260 x 17), timed as the SpMM
               kernels are (eager and cold device time) beside its bound,
               its plain version and the library call where there is one,
               with its host work per call; one norm's forward + backward
               fused and unfused: its kernels counted by the profiler and
               its eager time by CUDA events;
     train_norm_small — 3 steps card vs CPU with the fused norm.
     Every Trainer here trains as on the card it always does: the first
     step after init eager, then one captured step replayed per batch. A
     wrapper counts a launch when it is called, so a captured step counts
     once, at its capture, and its replays nothing: where a path trains,
     the launches it checks and reports are those the card ran, which
     every kernel counts itself on the device (a counter in its library
     that thread 0 of CTA 0 adds to, read by card_counts), and each
     capture's own count is checked as one step's.
 10b. the captured training step:
     train_graph_small — on small layouts of every kernel family a step
               reaches (BCSR f32, bf16, int8; band f32, int8, per-group;
               the int8 dense layout; the fused norm on a band and, with
               bf16 activations, on an int8 BCSR), a GLASS with dropout 0.5
               trained 3 epochs of 10 steps from one seed eagerly and
               graphed, the plateau halving the rate between epochs:
               losses within rtol 1e-6, parameters within 1e-5 x
               max|param|, the kernels the card ran equal both ways (and
               eager equal to the wrappers' counts), a step's launches by
               kernel at capture equal to the card's own count and the
               profiler's over 3 replays, the fused norm's tickets 0 after
               them; and graphed again with GLASS_TPU_REMAT=1: losses and
               parameters bit-equal to the graphed run without, the
               capture counting the step's launches plus remat's (each
               conv's SpMM and, fused, its K1-K3 once more), the card's
               counters those of the capture once a step;
     embedding_bwd — the fixed-order embedding backward
               (csrc/embedding_bwd.cu, one launch: each slice of id-sorted
               rows sums its runs, each chunk of 16 slices its ids'
               pieces, each id its chunk partials) against its plain
               version, bit-equal and within 1e-6 x max|plain|, f32 and
               bf16 cotangents, repeats bit-identical, at the stand-in's
               57,344 degree ids, the hpo stand-in's 14,587, 57,344 rows of
               one id and the ladder's 2,293,760 ids over 16 values, timed
               eager and cold beside its bound, and at em_user's ids
               untimed widths 17 f32, 20 bf16 (one value a lane) and 160
               f32 (two column tiles); its kernels line record (em_user,
               f32) timed beside index_add;
     train_graph — em_user at full width (dropout 0.5, batch 6, lr 1e-3),
               eager against graphed, on the stand-in through the CLI's
               default route (native RCM, the planner's layout) and then
               on the forced band with the fused norm: ms per step by host
               clock, device ms per step (profiler), the card's idle share
               both ways, the planner's choices after RCM, the kernels the
               card ran in the profiled epoch both ways; losses and
               parameters bit-equal (the embedding's backward sums in a
               fixed order), the embedding backward's launch once a
               step on the card both ways and once a replay, losses
               falling; on each
               route then eval_graph — evaluate_score of a 60-subgraph val
               and test split (the last batch padded) graphed and eager
               (Trainer._graphed cleared): host ms, device ms, idle share,
               logits bit-equal, F1 counts equal, one program a kind and
               shape counting nb forwards, the card's counters those of
               the captures times (1 + replays) — and request_graph —
               20 requests of each of 1, 6 and 64 subgraphs through a
               Predictor of the trained model graphed and eager: host ms
               (median), device ms, idle share, logits bit-equal, the
               reserved memory each bucket's capture adds, the card's
               counters as in eval_graph;
     remat — GLASS_TPU_REMAT on against off inside the captured step,
               em_user at 1 and 2 conv layers on both train_graph routes,
               PyTorch's default algorithms: 3 steps' losses and the parameters bit-equal, the card's
               launches against the remat term, the peak allocated bytes
               over the first epoch and ms a step over 20 replays, on and
               off; remat_small — the same on the small bf16 band and
               hybrid layouts; remat_embedding_spread — nn.Embedding's
               backward over the stand-in's degree ids repeated 6 times,
               by default and deterministic, and the fixed-order backward
               by default: the last two spread 0;
     scale_ladder — tools/torch_max_scale.py's rung 4 (229,376 nodes, 36M
               directed edges): built through build_graph (native CSR and
               fills, the planner's layout) in int8 slabs with bf16
               activations and in f32, the host's peak resident bytes by
               build phase, the plan, edge arrays and layout tensors held
               to pinned digests (byte-equal to the build before it was
               made lean); each SpMM kernel of the layout,
               forward and transposed, against its plain version on x in
               the rung's compute dtype (check_kernels, KERNEL_TOL); 10 steps eager against graphed, losses and
               parameters bit-equal, the card's counters one capture's
               count once a step and the embedding backward once a step,
               check_replays; the tool's timed run (ms a step, device ms,
               idle share, peak allocated, G edge-traversals a second),
               losses finite and falling; the rung's record line;
     serve_graph_small — on small layouts of every kernel family (the int8
               dense layout; BCSR f32 and int8; band f32, bf16 and int8; a
               hybrid split; band f32 with the fused norm), a request in
               every bucket (1, 8, 64, 256) x (16, 64, 256) served twice
               through Predictor's captured programs and once eagerly:
               replays bit-identical to first calls, graphed logits
               bit-equal to eager, each capture one forward's launches,
               the card's counters the captures' counts times (1 +
               replays), the fused norm's tickets 0 after the replays.
 11. cli_em_user — the experiment CLI (glass_tpu_torch.cli.glass_test.main,
     in this process) at em_user on a SubGNN-format stand-in written to a
     temporary directory (the graph of 4, size-labelled subgraphs split
     240/60/60): 2 repeats with the fused norm, the run's launches
     checked against the model (2 band launches per conv layer and
     step, K1-K5 once per GraphNorm and step), the best-val checkpoint
     served through Predictor.from_checkpoint; the same command unfused, 1
     repeat, its first epoch losses held to the fused run's and both runs'
     times per step printed (the A/B); cli_em_user_q — 1 repeat with int8
     slabs and bf16 activations, every norm pass in bf16; cli_em_user_auto
     — the CLI's default route, no --spmm and no --sparse_layout (RCM, the
     "pallas" route, the planner's layout), its launches per step checked
     against the planned layout and the layout's kernels against their
     plain versions. Every CLI run trains on captured steps and evaluates
     through captured eval programs: each step capture counts one step's
     launches and each eval program's capture nb forwards', the card runs
     a step's once a training step and the forward's once an eval batch,
     and nothing else (the card's counters over the whole run); the eval
     ms an epoch after the gate is printed beside the ms a step;
     predict_cli — python -m
     glass_tpu_torch.cli.glass_predict with the fused run's checkpoint
     on the default route, on the test split and on a --subgraphs TSV
     (two processes side by side): one row per subgraph, the input's original ids, the
     logits within rtol 1e-5 of Trainer.evaluate on the same RCM graph.
 12. SSL pretraining (glass_tpu_torch/train/ssl.py, the gnn_emb path) on
     the same stand-in, nodeid feature:
     ssl_em_user — pretrain_once at SSLConfig's defaults (hidden 64, 3
               conv layers, dropout 0.3, "mean", 131,072-pair batches, 10
               an epoch) on the "pallas" route, 6 epochs, its pairs on the
               card and its step, node table and val logits captured: the
               planner's layout and each of its kernels (and the
               transposed ones) against their plain versions at the
               path's shape; the card's launches: 2 per conv layer and
               training step (one step's, read between steps; the step's
               capture), 1 per conv layer at each program's capture, and
               over the run each capture's count times (1 + its replays);
               finite losses, the last epoch's below the first's; host ms
               per step (median, epochs 3-5), device ms per step (the
               profiler over epoch 2), the idle share, the same profile's
               host side (self CPU ms per step in PyTorch's ops, the rest
               outside them, kernels per step, the top ops), an epoch's
               seconds, the peak allocated bytes, the seconds of
               get_lp_dataset (the native sampler) and of the build and
               plan; ssl_em_user_eager — 3 epochs from the same seed and
               state eagerly (_graphed cleared), twice, and captured: the
               eager repeats' spread of losses and best table, 0, the
               captured run within it, the eager host and device ms, idle
               share and epoch seconds; then the first loss within rtol
               1e-4 of the same step on "segment"; ssl_em_user_fused_norm
               — one epoch with GLASS_TPU_FUSED_NORM=1: K1-K5 once per
               GraphNorm (2 per conv layer but the last) at the step's
               capture, K1-K3 at each program's, the card's counters
               likewise;
     ssl_cli — python -m glass_tpu_torch.cli.gnn_emb --use_nodeid --spmm
               pallas, 1 TPE trial of 6 epochs, in a subprocess: a line
               per trial, a finite (57,344, 64) em_user_64.npz, the study
               em_user.db; the same command again logs "resumed study: 1
               completed trials" and trains nothing; ssl_glass_test —
               glass_test --use_nodeid on the default route (RCM, the
               planner) for 3 epochs: the trunk's embedding at its first
               epoch equals the table row for row (x holds the original
               ids in RCM order).
 13. GNN-seg (glass_tpu_torch/train/seg_protocol.py, the gnn_seg path) on
     the same stand-in, one-hot degree feature; it runs none of the kernels
     above (batched dense products, as in JAX):
     seg_em_user — python -m glass_tpu_torch.cli.gnn_seg --dataset em_user
               --max_epochs 30 (em_user's best hyperparameters: 1 GCN
               layer, hidden 64, dropout 0.4) in this process, on its
               captured step and eval programs, then run_seg_experiment
               eagerly (_graphed cleared) from the same seed: epoch
               losses and iter lines equal, one step capture replayed
               every later step, one eval program a batch shape;
               segregate's seconds (the native induced adjacencies), L and
               F, the bytes of the resident (S, L, L) tensors, host and
               device ms per step (epoch wall / steps; the profiler over
               one epoch), the idle share and eval ms a |test|-sized batch
               both ways, seconds to the first epoch, the peak allocated
               bytes, the log's final mean; finite, falling losses and
               log lines in JAX's format;
     seg_depth — ppi_bp's best hyperparameters (8 GCN layers, hidden 64)
               through run_seg_experiment for 3 epochs, captured and
               eager as in seg_em_user, then from one
               state with dropout 0 and the norms' parameters drawn: 3
               steps on the card against 3 on the CPU (losses within rtol
               1e-5), the logits of one eval batch within 1e-5 x
               max|logit|, and the gin conv on one batch (logits and loss
               likewise); the same 3 steps from the initial state are
               reported (Adam there steps on rounding noise);
     attention_small — sddmm (both modes), segment_softmax and one
               AttentionConv forward and backward on a 3,000-node graph,
               card against CPU, within 1e-5 x max|CPU result|;
     profiling — trace writes a Chrome trace with the card's kernels
               around one GNN-seg step; nan_check_mode raises at a NaN
               made by a forward op and by a backward op, lets a finite
               step through, and is off after the block.
 14. the sharded paths (glass_tpu_torch/parallel/, on torch.distributed),
     last; the card has one H100, so every multi-rank run shares it:
     sharded_kernels_main — the em_user stand-in partitioned over the 2
               graph shards that sharded_train runs (nb = 28,672) as BCSR,
               band and hybrid (the hybrid phase's graph), f32 and int8:
               sharded_train's own partitions (shard_builds: built once,
               with the unsharded graphs, side by side in worker
               processes); each shard's forward (local rows x global columns) and
               transposed (global rows x local columns, the band's
               row-range trimmed: glass_band_spmm's out_row0) kernel
               against its plain version, the shards' forward outputs
               stacked against the unsharded kernel's A @ x and their
               transposed outputs summed against its A^T g (int8 where
               the quantized rows differ: within SHARD_Q_TOL), each timed
               eager and cold beside the unsharded kernel; the kernels
               line's per-shard records (their launches: sharded_train's,
               on these layouts);
     sharded_train — 4 ranks (2 data x 2 graph) spawned on the card over
               gloo (NCCL refuses two ranks of one communicator on one
               device; gloo moves CUDA operands through the host), each
               loading those partitions, 3 steps of JAX's dry-run matrix at em_user width with dropout 0
               (all-gather segment, overlap, ring, BCSR, band and hybrid in
               f32 and int8) and the AutoTrainer over 4 data ranks and over
               2 graph ranks (the density-scale dense graph): every rank's
               losses equal, within rtol 1e-5 of the one-process card
               Trainer on the same layout (int8 1e-3), each rank's
               launches by the card's counters 2 per conv layer and step;
     sharded_nccl — world size 1 over NCCL (the halo all-gather and the
               all-reduces on CUDA tensors), the BCSR layout, within rtol
               1e-6 of the one-process Trainer;
     sharded_cli — glass_test --graph_shards 2 --data_shards 2 --spmm
               pallas on the em_user stand-in in 4 processes
               (--coordinator/--num_processes/--process_id
               --cpu_collectives gloo), 2 epochs: rank 0's log in JAX's
               format, its epoch losses finite and falling.
Then the card line again, one {"kernels": [...]} JSON line and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero without that line.
In the kernels line an SpMM or norm kernel's "ms", "plain_ms" and
"library_ms" are CUDA-event times of eager calls (time_ms), which include
the host's work where the card outruns it; "device_ms", "plain_device_ms"
and "library_device_ms" are the same three calls' device time with the L2
cache flushed before each call (cold_ms; an empty call reads about 5 us by
it). A probe's "ms" is the time of one 512 MiB pass. A kernel's
"launches" are those of its path: the card's own count (card_counts)
where the path trains or serves (captured steps and captured inference
programs); the wrappers' count where it probes, which is eager and
launches once a call.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from glass_tpu_torch import (GLASS, Predictor, TrainConfig, Trainer,
                             build_graph, make_eval_batches,
                             make_train_batches)
from glass_tpu_torch import native
from glass_tpu_torch.data.basegraph import relabel_pos
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops import bcsr_spmm as bs
from glass_tpu_torch.ops import dense_q as dq
from glass_tpu_torch.ops import embedding as eb
from glass_tpu_torch.ops import fused_norm as fn
from glass_tpu_torch.ops import hbm_probe as hp
from glass_tpu_torch.ops._common import BLOCK
from glass_tpu_torch.ops.graph import EDGE_BUCKET, degrees
from glass_tpu_torch.ops.norm import graph_norm
from glass_tpu_torch.ops.spmm import spmm
from glass_tpu_torch.serve import _bucket
from glass_tpu_torch.train.metrics import pad_eval_labels
from glass_tpu_torch.utils.graphs import (InferenceProgram,
                                          InferencePrograms, StepGraph)

# glass_tpu/configs/em_user.yml; activation "elu" as the experiment protocol
# builds GLASS (glass_tpu/train/protocol.py::make_glass_model).
EM_USER = dict(hidden_dim=64, conv_layer=1, pool="size", z_ratio=0.75, jk=True,
               aggr="gcn", batch_size=6, activation="elu", dropout=0.5,
               lr=1e-3, resi=0.7)
N_COMM, COMM_SIZE, UNDIRECTED_EDGES = 448, 128, 4_500_000
# (rps, w_blocks, affine stride, affine offset) of the band the planner
# gives the stand-in under the H100's constants, at every dense_dtype (the
# JAX builder's TPU constants give (2, 4, 2, -1))
EM_USER_BAND_LAW = (1, 3, 1, -1)
REQUEST_BATCHES = (1, EM_USER["batch_size"], 64)
NARROW_H = 17  # glass_tpu/configs/component.yml's hidden width
# the training phase: synthetic subgraphs (train + eval) and epochs
TRAIN_SUBGRAPHS, EVAL_SUBGRAPHS, TRAIN_EPOCHS = 240, 60, 4
# the CPU parity tolerances of tests/test_torch_train.py
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL_LRS = 1e-4, 3

# glass_tpu/configs/hpo_metab.yml
HPO_METAB = dict(hidden_dim=64, conv_layer=1, pool="sum", z_ratio=0.55,
                 jk=True, aggr="gcn", batch_size=59, activation="elu",
                 dropout=0.5, lr=1e-3, resi=0.2)
HPO_NODES, HPO_DIRECTED_EDGES, HPO_CLASSES = 14587, 2_600_000, 6
HPO_SUBGRAPHS, HPO_EPOCHS = 6 * 59, 3
HPO_EVAL_SPLIT = 240  # hpo_metab's 2,400 subgraphs split 80/10/10
# card vs CPU with bf16 compute: bf16 rounds at other places on the two
# devices (cuBLAS and the CPU's GEMMs), as between JAX and PyTorch, where
# tests/test_torch_train.py measured 2.0e-3 at most
TRAIN_Q_LOSS_RTOL = 1e-2
# requests of the int8 + bf16 model against the same weights in f32 on the
# exact f32 "segment" SpMM: the JAX package's own bound for its bf16 mode
# (tests/test_mixed_precision.py:54)
QUANT_RTOL, QUANT_ATOL = 0.1, 0.05

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, dense bf16 and
# TF32 on the tensor cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12

KERNEL_TOL = 1e-5  # max |kernel - plain| <= KERNEL_TOL * max |plain|


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] {json.dumps(fields)}", flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def clustered_graph(n_comm=N_COMM, csz=COMM_SIZE, e=UNDIRECTED_EDGES,
                    intra_frac=0.95, seed=0):
    """em_user-scale synthetic with community structure (cross edges between
    chain-adjacent communities), standing in for an RCM-ordered real graph;
    the recipe of bench.py::clustered_graph, drawn by
    tools/torch_max_scale.py's generator at scale 1. Returns (edge_index,
    n)."""
    return load_tool("torch_max_scale").clustered_graph(
        1, n_comm, csz, e, intra_frac, seed=seed)


def small_layout_edges(seed=1):
    """A 1,445-node directed graph (n % 128 != 0) whose row block 0 touches
    10 column blocks (two chunks), row blocks 3 and 5 have no edges, and
    some edges repeat."""
    rng = np.random.default_rng(seed)
    n = 11 * BLOCK + 37
    rows, cols = [], []
    for cb in range(10):
        rows.append(rng.integers(0, BLOCK, 40))
        cols.append(cb * BLOCK + rng.integers(0, BLOCK, 40))
    r = rng.integers(BLOCK, n, 3000)
    r = r[(r // BLOCK != 3) & (r // BLOCK != 5)]
    rows.append(r)
    cols.append(rng.integers(0, n, r.size))
    ei = np.stack([np.concatenate(rows), np.concatenate(cols)])
    ei = np.concatenate([ei, ei[:, :200]], axis=1)  # duplicates
    return ei, rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32), n


def time_ms(fn, groups=15, per_group=10, warmup=3) -> float:
    """Median over groups of the mean time of one call, from CUDA events
    around ``per_group`` back-to-back calls (so the card never waits on the
    host between them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / per_group for s, e in spans)


# an SpMM record's times and bound, as its phase line prints them
TIME_KEYS = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
             "library_device_ms", "bound_ms", "bound_by")


def timed(fn, plain, library) -> dict:
    """A kernels-line record's times of a kernel, its plain version and the
    library call (None where there is none), each two ways, so that every pair of numbers compares
    like with like: "ms", "plain_ms", "library_ms" by time_ms (eager
    calls); "device_ms", "plain_device_ms", "library_device_ms" by
    cold_ms (the call's kernels alone, the L2 cache flushed before it)."""
    out = {}
    for key, f in (("", fn), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"] = None if f is None else time_ms(f)
        out[f"{key}device_ms"] = None if f is None else cold_ms(f)
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_vs_plain(what: str, fn, plain, x) -> tuple:
    """(max |kernel - plain|, max |plain|) of fn(x) against plain(x); fails
    past the tolerance, on a non-finite value or if a repeated call differs
    in any bit."""
    out, again, ref = fn(x), fn(x), plain(x)
    sync(x.device)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(out.dtype == torch.float32 and out.shape == ref.shape,
          f"{what}: output {out.dtype} {tuple(out.shape)}")
    check(torch.isfinite(out).all().item(), f"{what}: non-finite output")
    check(torch.equal(out, again), f"{what}: repeated call differs")
    check(err <= KERNEL_TOL * scale,
          f"{what}: max|diff| {err} > {KERNEL_TOL} * {scale}")
    return err, scale


def nonzero_blocks(bcsr) -> int:
    """Stored 128x128 blocks that hold at least one nonzero (this data's
    work; the rest is CHUNK padding)."""
    b = bcsr.blocks.view(-1, BLOCK, bs.CHUNK, BLOCK)
    return int((b != 0).any(dim=3).any(dim=1).sum())


def reckonings(nz: int, blocks, table_bytes: int, x, n_out: int) -> dict:
    """Each way this card can compute out = A @ x at the layout's
    precision -> (ms, "bytes" | "operations"), the larger of its two terms
    on the card's published peaks. Bytes: the ``nz`` nonzero 128x128 blocks
    of the layout's ``blocks`` tensor (at its itemsize), its index and
    scale tables (``table_bytes``) and x read once, the f32 output written
    once. Operations: 2 * 128 * 128 * H products per nonzero block. bf16
    and int8 blocks multiply bf16 x: one way, bf16 products on the tensor
    cores ("bf16"). f32 blocks have two f32-accurate ways: f32 FMA outside
    the tensor cores ("fma") and three TF32 products on them ("3xtf32")."""
    h = x.shape[1]
    nbytes = (nz * BLOCK * BLOCK * blocks.element_size() + table_bytes
              + x.numel() * x.element_size() + n_out * h * 4)
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    flop = 2.0 * nz * BLOCK * BLOCK * h
    ops = ({"fma": flop / PEAK_F32_FLOPS, "3xtf32": 3 * flop / PEAK_TF32_FLOPS}
           if blocks.dtype == torch.float32 else
           {"bf16": flop / PEAK_BF16_FLOPS})
    return {k: ((t * 1e3, "operations") if t * 1e3 >= t_bytes
                else (t_bytes, "bytes")) for k, t in ops.items()}


def least_ms(nz: int, blocks, table_bytes: int, x, n_out: int) -> tuple:
    """(least time in ms, "bytes" | "operations") for out = A @ x: the
    lesser of the layout's reckonings (for f32 blocks the FMA one and the
    3xTF32 one, each the larger of its bytes and operations terms)."""
    return min(reckonings(nz, blocks, table_bytes, x, n_out).values())


def scale_bytes(layout) -> int:
    return 0 if layout.row_scale is None else layout.row_scale.numel() * 4


def bound_ms(bcsr, x) -> tuple:
    """least_ms of a BCSR layout: its nonzero blocks, their column ids, the
    row pointers and the row scale."""
    nz = nonzero_blocks(bcsr)
    return least_ms(nz, bcsr.blocks,
                    nz * 4 + (bcsr.n_rb + 1) * 4 + scale_bytes(bcsr), x,
                    bcsr.n_node)


def csr_adjacency(graph) -> torch.Tensor:
    """The normalized adjacency as a torch CSR tensor: the library
    yardstick's input (torch.sparse.mm), timed only, never used by the
    port."""
    n, n_e = graph.n_node, graph.n_edge
    with warnings.catch_warnings():  # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([graph.row[:n_e], graph.col[:n_e]]),
            graph.weight[:n_e], (n, n), check_invariants=True,
        ).coalesce().to_sparse_csr()


def make_request(rng, batch: int, n_comm: int, csz: int):
    """``batch`` subgraphs of 8-250 nodes, each drawn from 1-3 neighbouring
    communities."""
    subs = []
    for _ in range(batch):
        k = int(rng.integers(1, 4))
        c0 = int(rng.integers(0, n_comm - k + 1))
        size = min(int(rng.integers(8, 251)), k * csz)
        nodes = rng.choice(np.arange(c0 * csz, (c0 + k) * csz), size, replace=False)
        subs.append(nodes.tolist())
    return subs


def degree_features(ei, n) -> np.ndarray:
    """(n, 1) degree-bucket feature ids (glass_tpu/data/basegraph.py
    set_degree_feature): the rank of each node's degree among the unique
    degrees."""
    deg = degrees(ei, None, n).astype(np.int64)
    _, inv = np.unique(deg, return_inverse=True)
    return inv.reshape(n, 1)


def em_user_model(max_deg: int, spmm_mode: str, device,
                  dropout: float = 0.0, compute_dtype=None,
                  layers: int = EM_USER["conv_layer"]) -> GLASS:
    return GLASS(max_deg, EM_USER["hidden_dim"], layers, (1,),
                 (EM_USER["pool"],), activation=EM_USER["activation"],
                 z_ratio=EM_USER["z_ratio"], jk=EM_USER["jk"],
                 dropout=dropout, spmm_mode=spmm_mode,
                 compute_dtype=compute_dtype, seed=0, device=device)


def wide_range_bcsr(device):
    """An f32 BCSR layout whose values span 2^-20 to 2^4 ("sum" keeps
    them)."""
    rng = np.random.default_rng(19)
    ei, n = clustered_graph(10, BLOCK, 5000, seed=9)
    w = np.exp2(rng.uniform(-20, 4, ei.shape[1])).astype(np.float32)
    bcsr = build_graph(ei, w, n, "sum", materialize_dense=False,
                       materialize_bcsr=True, sparse_layout="bcsr",
                       device=device).bcsr
    nz = bcsr.blocks[bcsr.blocks != 0].abs()
    check(float(nz.min()) < 2.0 ** -18 and float(nz.max()) > 2.0 ** 2,
          "the wide-range BCSR layout does not span 2^-20 to 2^4")
    return bcsr


def phase_small(device) -> None:
    """The f32 kernel on small layouts (f32 and bf16 x), and a small model
    card-vs-CPU."""
    gen = torch.Generator().manual_seed(0)
    ei, w, n = small_layout_edges()
    graph = build_graph(ei, w, n, "sum", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout="bcsr",
                        device=device)
    bcsr = graph.bcsr
    ptr = bcsr.block_row_ptr.cpu().numpy()
    counts = np.diff(ptr)
    check(counts[0] > 8 and counts[3] == 0 and counts[5] == 0,
          f"small layout lacks its cases: blocks per row {counts.tolist()}")
    check(bcsr.live_blocks < bcsr.nnz_blocks,
          "the small layout has no CHUNK padding to skip")
    layouts = {"wide_row_empty_rows": bcsr,
               "wide_range": wide_range_bcsr(device)}
    for name, layout in layouts.items():
        for xdt in X_DTYPES:  # bf16 x: widened exactly
            for h in (17, 128):
                x = torch.randn(layout.n_node, h, generator=gen).to(device,
                                                                    xdt)
                err, scale = check_vs_plain(
                    f"bcsr {name} x {xdt} H={h}",
                    lambda v: bs.bcsr_spmm(layout, v),
                    lambda v: bs.bcsr_spmm_reference(layout, v), x)
                emit("kernel_small", layout=name, x=str(xdt), H=h,
                     n_node=layout.n_node, stored_blocks=layout.nnz_blocks,
                     live_blocks=layout.live_blocks, max_abs_err=err,
                     max_abs_ref=scale)

    sym = np.concatenate([ei, ei[::-1]], axis=1)
    feats = np.random.default_rng(2).integers(0, 6, (n, 1))
    subs = make_request(np.random.default_rng(3), 8, 11, BLOCK)
    logits = {}
    for dev in (device, torch.device("cpu")):
        g = build_graph(sym, None, n, "gcn", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout="bcsr", device=dev)
        model = em_user_model(5, "pallas", dev)
        pred = Predictor(model, g, torch.from_numpy(feats).to(dev), device=dev)
        logits[dev.type] = pred(subs)
    ref = logits["cpu"]
    err = float(np.abs(logits[device.type] - ref).max())
    check(err <= 1e-4 * np.abs(ref).max() + 1e-6,
          f"small GLASS card vs CPU: max|diff| {err}")
    emit("model_small", n_node=n, subgraphs=len(subs), max_abs_err=err,
         max_abs_ref=float(np.abs(ref).max()))


def phase_main(device, n_comm=N_COMM, csz=COMM_SIZE, edges=UNDIRECTED_EDGES):
    """The em_user main path. Returns the kernel's record for the kernels
    line."""
    gen = torch.Generator().manual_seed(1)
    ei, n = clustered_graph(n_comm, csz, edges)
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="bcsr", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    bcsr = graph.bcsr
    emit("graph", n_node=n, directed_edges=graph.n_edge,
         nonzero_blocks=nonzero_blocks(bcsr), stored_blocks=bcsr.nnz_blocks,
         row_blocks=bcsr.n_rb, symmetric=graph.bcsr_t is bcsr,
         build_s=build_s)

    h = EM_USER["hidden_dim"]
    x = torch.randn(n, h, generator=gen).to(device)
    err, scale = check_vs_plain("em_user bcsr",
                                lambda v: bs.bcsr_spmm(bcsr, v),
                                lambda v: bs.bcsr_spmm_reference(bcsr, v), x)
    adj = csr_adjacency(graph)
    lib = torch.sparse.mm(adj, x)
    lib_err = float((lib - bs.bcsr_spmm_reference(bcsr, x)).abs().max())
    record = dict(
        name="bcsr_spmm", route="cuda",
        source="glass_tpu_torch/csrc/bcsr_spmm.cu",
        replaces="glass_tpu/ops/pallas_spmm.py:411",
        tpu=["glass_tpu/ops/pallas_spmm.py:321 _bcsr_chunk_kernel",
             "glass_tpu/ops/pallas_spmm.py:411 _bcsr_chunk_kernel_large"],
        max_abs_err=err,
        **timed(lambda: bs.bcsr_spmm(bcsr, x),
                lambda: bs.bcsr_spmm_reference(bcsr, x),
                lambda: torch.sparse.mm(adj, x)),
    )
    record["bound_ms"], record["bound_by"] = bound_ms(bcsr, x)
    emit("kernel_main", H=h, max_abs_err=err, max_abs_ref=scale,
         library_max_abs_diff=lib_err, live_blocks=bcsr.live_blocks,
         **{k: record[k] for k in TIME_KEYS})
    # component's width (glass_tpu/configs/component.yml) at this shape
    x17 = torch.randn(n, NARROW_H, generator=gen).to(device)
    err17, scale17 = check_vs_plain(
        f"em_user bcsr H={NARROW_H}", lambda v: bs.bcsr_spmm(bcsr, v),
        lambda v: bs.bcsr_spmm_reference(bcsr, v), x17)
    narrow = dict(H=NARROW_H, max_abs_err=err17, max_abs_ref=scale17,
                  **timed(lambda: bs.bcsr_spmm(bcsr, x17),
                          lambda: bs.bcsr_spmm_reference(bcsr, x17),
                          lambda: torch.sparse.mm(adj, x17)))
    narrow["bound_ms"], narrow["bound_by"] = bound_ms(bcsr, x17)
    emit("kernel_main_narrow", **narrow)
    record["narrow_h"] = narrow
    del adj, lib, x17

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    max_deg = int(feats_np.max())
    model = em_user_model(max_deg, "pallas", device)
    pred = Predictor(model, graph, feats, device=device)
    rng = np.random.default_rng(4)
    requests = [make_request(rng, b, n_comm, csz) for b in REQUEST_BATCHES]
    torch.cuda.reset_peak_memory_stats(device)
    served, launches = serve_requests(pred, requests, {"bcsr": "float32"},
                                      EM_USER["conv_layer"])
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    model_seg = em_user_model(max_deg, "segment", device)
    pred_seg = Predictor(model_seg, graph, feats, device=device)
    for subs, out, ms_first, ms_repeat in served:
        ref = pred_seg(subs)
        diff = float(np.abs(out - ref).max())
        scale = float(np.abs(ref).max())
        check(np.allclose(out, ref, rtol=1e-4, atol=1e-5 * scale),
              f"batch {len(subs)}: pallas vs segment max|diff| {diff}")
        emit("request", batch=len(subs), width=max(map(len, subs)),
             ms_first=ms_first, ms_repeat=ms_repeat,
             max_abs_diff_vs_segment=diff, max_abs_logit=scale)
    emit("main_path", requests=2 * len(served), kernel_launches=launches,
         peak_mem_gib=peak_gib)
    record["launches"] = launches
    return record


def phase_train_bcsr(device, record: dict, n_comm=N_COMM, csz=COMM_SIZE,
                     edges=UNDIRECTED_EDGES) -> None:
    """em_user trained at full width on the forced BCSR layout, f32: the
    BCSR backward at full scale (Trainer epochs with em_user's dropout,
    batch and lr, the recipe of phase_band_main), 2 BCSR launches per conv
    layer and step and no other SpMM kernel, finite and falling losses.
    Adds the launches to the BCSR kernel's record."""
    ei, n = clustered_graph(n_comm, csz, edges)
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="bcsr", device=device)
    check(graph.bcsr is not None and graph.bcsr_t is graph.bcsr
          and graph.band is None and graph.bcsr.blocks.dtype == torch.float32,
          "the em_user graph has no symmetric f32 BCSR layout")
    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    model = em_user_model(int(feats_np.max()), "pallas", device,
                          dropout=EM_USER["dropout"])
    rng = np.random.default_rng(15)
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS + EVAL_SUBGRAPHS,
                                     n_comm, csz)
    bsz = EM_USER["batch_size"]
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=EM_USER["lr"], resi=EM_USER["resi"], batch_size=bsz, loss="bce"))
    trainer.init(0)
    losses, steps, step_ms = [], 0, []
    with card_launches() as ran:
        for _ in range(TRAIN_EPOCHS):
            pos_b, y_b = make_train_batches(rng, pos[:TRAIN_SUBGRAPHS],
                                            y[:TRAIN_SUBGRAPHS], bsz)
            t0 = time.perf_counter()
            res = trainer.train_epoch(pos_b, y_b)  # ends in a readback
            step_ms.append((time.perf_counter() - t0) * 1e3
                           / len(res.step_losses))
            losses.append(res.loss)
            steps += len(res.step_losses)
    want = 2 * EM_USER["conv_layer"] * steps
    check(ran.card == counts_form(bcsr={"float32": want}),
          f"the card ran {ran.card}: expected {want} f32 BCSR launches "
          "and no other kernel of this repo")
    launches = ran.card["bcsr"]["float32"]
    check(np.isfinite(losses).all(), f"non-finite epoch losses {losses}")
    check(losses[-1] < losses[0], f"epoch losses did not fall: {losses}")
    emit("train_bcsr", epochs=len(losses), steps=steps, batch=bsz,
         dropout=EM_USER["dropout"], bcsr_launches=launches,
         launches_per_step=launches / steps, epoch_losses=losses,
         ms_per_step=step_ms,
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    record["launches_train"] = launches
    record["launches_per_step_train"] = launches / steps


# ------------------------------------------------------------ banded slabs

BAND_TPU = [
    "glass_tpu/ops/pallas_band.py:658 _band_kernel_affine",
    "glass_tpu/ops/pallas_band.py:465 _band_kernel",
    "glass_tpu/ops/pallas_band.py:505 _band_kernel_xvmem",
    "glass_tpu/ops/pallas_band.py:543 _band_kernel_xvmem_gps",
    "glass_tpu/ops/pallas_band.py:605 _band_kernel_gps",
    "glass_tpu/ops/pallas_band.py:793 _band_kernel_striped",
]


def piecewise_edges(rng, n):
    """Directed band whose window law jumps at half depth (the recipe of
    tests/test_pallas_band.py::_piecewise_directed): per-group windows stay
    narrow, one affine law would inflate them past the gate."""
    half = n // 2
    r1 = np.arange(half)
    c1 = np.clip(r1 + rng.integers(-48, 48, half), 0, n - 1)
    r2 = np.arange(half, n)
    c2 = np.clip(r2 - half + rng.integers(-48, 48, half), 0, n - 1)
    return np.stack([np.concatenate([r1, r2]), np.concatenate([c1, c2])])


def small_band_layouts(device, dense_dtype: str = "f32") -> dict:
    """name -> BandedAdj for the kernel's cases, with slabs of
    ``dense_dtype``'s type; fails if a layout lacks the case it stands
    for."""
    rng = np.random.default_rng(11)
    ei, n = clustered_graph(12, BLOCK, 6000, seed=5)
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="band", dense_dtype=dense_dtype, device=device)
    affine = build_graph(ei, None, n, "gcn", **kw).band
    top = affine.n_groups - 1
    check(affine.affine_stride is not None and affine.affine_off < 0
          and top * affine.affine_stride + affine.affine_off
          + affine.w_blocks > affine.n_cb,
          "the affine layout lacks a negative offset or a bottom overhang")

    n = 16 * BLOCK
    per_group = build_graph(piecewise_edges(rng, n), None, n, "sum",
                            **kw).band
    check(per_group.affine_stride is None, "the affine gate took the jump")

    n = 10 * BLOCK + 37
    r = rng.integers(0, n, 4000)
    r = r[(r // BLOCK < 2) | (r // BLOCK > 3)]  # group 1 of rps 2 is empty
    c = np.clip(r + rng.integers(-200, 200, r.size), 0, n - 1)
    w = rng.uniform(0.5, 2.0, r.size).astype(np.float32)
    empty = build_graph(np.stack([r, c]), w, n, "sum", band_rps=2,
                        **kw).band
    check(bool((empty.slabs != 0).flatten(1).any(dim=1).logical_not().any()),
          "the ragged layout has no empty group")
    return {"affine": affine, "per_group": per_group,
            "empty_groups_ragged": empty}


def nonzero_band_blocks(band) -> int:
    """128x128 blocks of the slabs that hold at least one nonzero (this
    data's work; the rest of the band is zeros)."""
    b = band.slabs.view(band.n_groups, band.rps, BLOCK, band.w_blocks, BLOCK)
    return int((b != 0).any(dim=4).any(dim=2).sum())


def band_args(band, x) -> tuple:
    """least_ms's arguments for a band layout: its nonzero blocks, the
    window table and the row scale."""
    return (nonzero_band_blocks(band), band.slabs,
            band.n_groups * 4 + scale_bytes(band), x, band.n_node)


def band_bound_ms(band, x) -> tuple:
    return least_ms(*band_args(band, x))


def wide_range_band(device):
    """An f32 band whose values span 2^-20 to 2^4 ("sum" keeps them)."""
    rng = np.random.default_rng(18)
    ei, n = clustered_graph(10, BLOCK, 5000, seed=9)
    w = np.exp2(rng.uniform(-20, 4, ei.shape[1])).astype(np.float32)
    band = build_graph(ei, w, n, "sum", materialize_dense=False,
                       materialize_bcsr=True, sparse_layout="band",
                       device=device).band
    nz = band.slabs[band.slabs != 0].abs()
    check(float(nz.min()) < 2.0 ** -18 and float(nz.max()) > 2.0 ** 2,
          "the wide-range layout does not span 2^-20 to 2^4")
    return band


def phase_band_small(device) -> None:
    gen = torch.Generator().manual_seed(12)
    layouts = small_band_layouts(device)
    layouts["wide_range"] = wide_range_band(device)
    for name, band in layouts.items():
        for xdt in X_DTYPES:  # bf16 x: widened exactly, loaded by the threads
            for h in (17, 64, 128):
                x = torch.randn(band.n_node, h, generator=gen).to(device, xdt)
                err, scale = check_vs_plain(
                    f"band {name} x {xdt} H={h}",
                    lambda v: bd.band_spmm(band, v),
                    lambda v: bd.band_spmm_reference(band, v), x)
                emit("kernel_band_small", layout=name, x=str(xdt), H=h,
                     n_node=band.n_node, rps=band.rps,
                     w_blocks=band.w_blocks,
                     affine_stride=band.affine_stride,
                     affine_off=band.affine_off, max_abs_err=err,
                     max_abs_ref=scale)


def phase_grad_small(device) -> None:
    """dx = A^T g through each kernel's autograd Function against the plain
    version's autograd, on an asymmetric graph."""
    gen = torch.Generator().manual_seed(13)
    ei, n = clustered_graph(12, BLOCK, 6000, seed=5)
    h = 64
    x = torch.randn(n, h, generator=gen).to(device)
    w = torch.randn(n, h, generator=gen).to(device)
    for layout in ("band", "bcsr"):
        g = build_graph(ei, None, n, "mean", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout=layout,
                        device=device)
        if layout == "band":
            fwd, bwd, mod, plain = g.band, g.band_t, bd.band_spmm, \
                bd.band_spmm_reference
        else:
            fwd, bwd, mod, plain = g.bcsr, g.bcsr_t, bs.bcsr_spmm, \
                bs.bcsr_spmm_reference
        check(fwd is not None and bwd is not fwd,
              f"the mean graph's {layout} layout is not an asymmetric pair")
        before = mod.launches
        xk = x.clone().requires_grad_()
        (dx,) = torch.autograd.grad((mod(fwd, xk, bwd) * w).sum(), xk)
        launches = mod.launches - before
        xp = x.clone().requires_grad_()
        (dx_ref,) = torch.autograd.grad((plain(fwd, xp) * w).sum(), xp)
        torch.cuda.synchronize()
        err = float((dx - dx_ref).abs().max())
        scale = float(dx_ref.abs().max())
        check(launches == 2, f"{layout}: {launches} launches for fwd + bwd")
        check(err <= KERNEL_TOL * scale,
              f"{layout} dx vs plain autograd: max|diff| {err} > "
              f"{KERNEL_TOL} * {scale}")
        emit("grad_small", layout=layout, n_node=n, H=h, launches=launches,
             max_abs_err=err, max_abs_ref=scale)


def size_labelled_subgraphs(rng, count: int, n_comm: int, csz: int):
    """(pos, y): ``count`` subgraphs drawn like make_request, padded with
    -1, labelled 1 iff the subgraph has more nodes than the median."""
    subs = make_request(rng, count, n_comm, csz)
    sizes = np.array([len(s) for s in subs])
    pos = np.full((count, sizes.max()), -1, dtype=np.int64)
    for i, s in enumerate(subs):
        pos[i, : len(s)] = s
    return pos, (sizes > np.median(sizes)).astype(np.float32)


def small_training(device, layout: str, dense_dtype: str = "f32",
                   compute_dtype=None):
    """(step losses, parameters on the CPU) of a small GLASS (dropout 0)
    after one 3-step epoch on an asymmetric graph."""
    ei, n = clustered_graph(8, BLOCK, 3000, seed=6)
    graph = build_graph(ei, None, n, "mean", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout=layout,
                        dense_dtype=dense_dtype, device=device)
    check((graph.band if layout == "band" else graph.bcsr) is not None,
          f"the small training graph has no {layout} layout")
    feats = np.random.default_rng(7).integers(0, 6, (n, 1))
    model = GLASS(5, 16, 2, (1,), ("size",), dropout=0.0,
                  spmm_mode="pallas", compute_dtype=compute_dtype, seed=0,
                  device=device)
    pos, y = size_labelled_subgraphs(np.random.default_rng(8), 18, 8, BLOCK)
    trainer = Trainer(model, graph, torch.from_numpy(feats).to(device),
                      TrainConfig(lr=EM_USER["lr"], batch_size=6, loss="bce"))
    trainer.init(0)
    pos_b, y_b = make_train_batches(np.random.default_rng(9), pos, y, 6)
    res = trainer.train_epoch(pos_b, y_b)
    return res.step_losses, {k: v.cpu() for k, v in model.state_dict().items()}


def phase_train_small(device) -> None:
    for layout in ("band", "bcsr"):
        losses, params = small_training(device, layout)
        losses_cpu, params_cpu = small_training(torch.device("cpu"), layout)
        loss_err = float(np.abs(losses - losses_cpu).max())
        param_err = max(float((params[k] - params_cpu[k]).abs().max())
                        for k in params)
        check(np.isfinite(losses).all(), f"{layout}: non-finite losses")
        check(np.allclose(losses, losses_cpu, rtol=TRAIN_LOSS_RTOL, atol=0),
              f"{layout}: card losses {losses} vs CPU {losses_cpu}")
        check(param_err <= TRAIN_PARAM_ATOL_LRS * EM_USER["lr"],
              f"{layout}: parameters differ by {param_err} after 3 steps")
        emit("train_small", layout=layout, steps=len(losses),
             losses=losses.tolist(), max_abs_loss_diff=loss_err,
             max_abs_param_diff=param_err)


def phase_band_main(device, n_comm=N_COMM, csz=COMM_SIZE,
                    edges=UNDIRECTED_EDGES) -> dict:
    """The em_user training path on the banded layout, then requests
    served on it. Returns the band kernel's record for the kernels line and
    the trained model's eval micro-F1."""
    gen = torch.Generator().manual_seed(14)
    ei, n = clustered_graph(n_comm, csz, edges)
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="band", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    band = graph.band
    check(band is not None and graph.band_t is band,
          "the em_user graph has no symmetric band layout")
    law = (band.rps, band.w_blocks, band.affine_stride, band.affine_off)
    check(law == EM_USER_BAND_LAW,
          f"(rps, w_blocks, stride, off) {law}, expected {EM_USER_BAND_LAW}")
    stored = band.n_groups * band.rps * band.w_blocks
    nz = nonzero_band_blocks(band)
    emit("graph_band", n_node=n, directed_edges=graph.n_edge, rps=band.rps,
         w_blocks=band.w_blocks, affine_stride=band.affine_stride,
         affine_off=band.affine_off, groups=band.n_groups,
         slab_bytes=band.slabs.numel() * 4, stored_blocks=stored,
         nonzero_blocks=nz, fill=nz / stored, build_s=build_s)

    h = EM_USER["hidden_dim"]
    for width in (17, 128):  # the f32 band at other widths of H
        w_err, w_scale = check_vs_plain(
            f"em_user band H={width}", lambda v: bd.band_spmm(band, v),
            lambda v: bd.band_spmm_reference(band, v),
            torch.randn(n, width, generator=gen).to(device))
        emit("kernel_band_main_width", H=width, max_abs_err=w_err,
             max_abs_ref=w_scale)
    x = torch.randn(n, h, generator=gen).to(device)
    err, scale = check_vs_plain("em_user band",
                                lambda v: bd.band_spmm(band, v),
                                lambda v: bd.band_spmm_reference(band, v), x)
    adj = csr_adjacency(graph)
    lib = torch.sparse.mm(adj, x)
    lib_err = float((lib - bd.band_spmm_reference(band, x)).abs().max())
    record = dict(
        name="band_spmm", route="cuda",
        source="glass_tpu_torch/csrc/band_spmm.cu",
        replaces="glass_tpu/ops/pallas_band.py:658", tpu=BAND_TPU,
        max_abs_err=err,
        **timed(lambda: bd.band_spmm(band, x),
                lambda: bd.band_spmm_reference(band, x),
                lambda: torch.sparse.mm(adj, x)),
    )
    record["bound_ms"], record["bound_by"] = band_bound_ms(band, x)
    emit("kernel_band_main", H=h, max_abs_err=err, max_abs_ref=scale,
         library_max_abs_diff=lib_err,
         bounds_by_reckoning=reckonings(*band_args(band, x)),
         **{k: record[k] for k in TIME_KEYS})
    del adj, lib, x

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    max_deg = int(feats_np.max())
    model = em_user_model(max_deg, "pallas", device,
                          dropout=EM_USER["dropout"])
    rng = np.random.default_rng(15)
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS + EVAL_SUBGRAPHS,
                                     n_comm, csz)
    bsz = EM_USER["batch_size"]
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=EM_USER["lr"], resi=EM_USER["resi"], batch_size=bsz, loss="bce"))
    trainer.init(0)
    torch.cuda.reset_peak_memory_stats(device)
    epochs = []
    with card_launches() as ran:
        for epoch in range(TRAIN_EPOCHS):
            pos_b, y_b = make_train_batches(rng, pos[:TRAIN_SUBGRAPHS],
                                            y[:TRAIN_SUBGRAPHS], bsz)
            t0 = time.perf_counter()
            res = trainer.train_epoch(pos_b, y_b)  # ends in a readback
            ms = (time.perf_counter() - t0) * 1e3
            epochs.append(dict(epoch=epoch, mean_loss=res.loss,
                               steps=len(res.step_losses),
                               ms_per_step=ms / len(res.step_losses)))
            emit("train_epoch", **epochs[-1])
    launches = ran.card["band"].get("float32", 0)
    check(ran.card == counts_form(band={"float32": launches}),
          f"the f32 band path ran other kernels: {ran.card}")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = sum(e["steps"] for e in epochs)
    losses = [e["mean_loss"] for e in epochs]
    check(np.isfinite(losses).all(), f"non-finite epoch losses {losses}")
    check(losses[-1] < losses[0], f"epoch losses did not fall: {losses}")
    check(launches == 2 * EM_USER["conv_layer"] * steps,
          f"{launches} band launches for {steps} steps of "
          f"{EM_USER['conv_layer']} conv layer(s)")
    pos_e, y_e, _ = make_eval_batches(pos[TRAIN_SUBGRAPHS:],
                                      y[TRAIN_SUBGRAPHS:], bsz)
    y_pad, mask = pad_eval_labels(y_e, pos_e.shape[0], bsz)
    score = trainer.evaluate_score(pos_e, y_pad, mask)
    emit("train", epochs=len(epochs), steps=steps, batch=bsz,
         dropout=EM_USER["dropout"], lr=EM_USER["lr"],
         band_launches=launches, launches_per_step=launches / steps,
         epoch_losses=losses, eval_micro_f1=score, peak_mem_gib=peak_gib)
    record["launches"] = launches
    record["launches_per_step"] = launches / steps

    pred = Predictor(model, graph, feats, device=device)
    model_seg = em_user_model(max_deg, "segment", device)
    model_seg.load_state_dict(model.state_dict())
    pred_seg = Predictor(model_seg, graph, feats, device=device)
    rng = np.random.default_rng(16)
    requests = [make_request(rng, b, n_comm, csz) for b in REQUEST_BATCHES]
    served, _ = serve_requests(pred, requests, {"band": "float32"},
                               EM_USER["conv_layer"])
    for subs, out, ms, ms_repeat in served:
        ref = pred_seg(subs)
        diff = float(np.abs(out - ref).max())
        ref_scale = float(np.abs(ref).max())
        check(np.allclose(out, ref, rtol=1e-4, atol=1e-5 * ref_scale),
              f"band batch {len(subs)}: vs segment max|diff| {diff}")
        emit("request_band", batch=len(subs), width=max(map(len, subs)),
             ms_first=ms, ms_repeat=ms_repeat,
             max_abs_diff_vs_segment=diff, max_abs_logit=ref_scale)
    return record, score


# ---------------------------------------------------------- mixed precision

X_DTYPES = (torch.float32, torch.bfloat16)


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    bs.bcsr_spmm.launches = bd.band_spmm.launches = 0
    dq.dense_q_spmm.launches = fn.fused_graph_norm.launches = 0
    eb.embedding_backward.launches = 0
    bs.bcsr_spmm.launches_by_dtype.clear()
    bd.band_spmm.launches_by_dtype.clear()
    fn.fused_graph_norm.launches_by_kernel.clear()
    fn.fused_graph_norm.launches_by_dtype.clear()


def launch_counts() -> dict:
    """The launch counts since reset_counts, by kernel and slab type; the
    fused GraphNorm's by pass."""
    return {"bcsr": dict(bs.bcsr_spmm.launches_by_dtype),
            "band": dict(bd.band_spmm.launches_by_dtype),
            "dense_q": dq.dense_q_spmm.launches,
            "norm": dict(fn.fused_graph_norm.launches_by_kernel)}


def full_counts() -> dict:
    """launch_counts() with the fused norm's passes by x's dtype."""
    return dict(launch_counts(),
                norm_dtype=dict(fn.fused_graph_norm.launches_by_dtype))


def counts_form(bcsr=None, band=None, dense_q=0, norm=None,
                norm_dtype=None) -> dict:
    """A full_counts()-form dict, zeros dropped: ``bcsr`` and ``band`` by
    dtype, ``norm`` by pass, its passes all of ``norm_dtype``."""
    def live(d):
        return {k: v for k, v in (d or {}).items() if v}
    norm = live(norm)
    return {"bcsr": live(bcsr), "band": live(band), "dense_q": dense_q,
            "norm": norm, "norm_dtype": live(
                {norm_dtype: sum(norm.values())} if norm else {})}


def scaled_sum(*terms) -> dict:
    """The sum of k * counts over ``(k, counts)`` terms of full_counts()'
    form, zeros dropped."""
    out = counts_form()
    for k, counts in terms:
        for key, v in counts.items():
            if isinstance(v, dict):
                for d, n in v.items():
                    out[key][d] = out[key].get(d, 0) + k * n
            else:
                out[key] += k * v
    return {key: ({d: n for d, n in v.items() if n} if isinstance(v, dict)
                  else v) for key, v in out.items()}


# this repo's kernels (csrc/*.cu) as the profiler names them, demangled or
# not; PyTorch's own kernels of like names (at::native::reduce_kernel,
# elementwise_kernel_with_index) match none
TYPE_NAMES = {"float": "float32", "f": "float32", "unsigned short":
              "bfloat16", "t": "bfloat16", "signed char": "int8", "a": "int8"}
NORM_PASSES = {("reduce", "0"): "colsum", ("reduce", "1"): "varsum",
               ("reduce", "2"): "bwd_reduce", ("elementwise", "0"): "affine",
               ("elementwise", "1"): "bwd_dx"}
_F32_SPMM = re.compile(r"(bcsr|band)_tf32_kernel")
_TC_SPMM = re.compile(r"spmm_kernel(?:<(signed char|unsigned short),|I([at])N)"
                      r".*?(Bcsr|Band)Walk")
_NORM = re.compile(
    r"^(?:void )?\(anonymous namespace\)::(reduce|elementwise)_kernel<"
    r"(float|unsigned short), \d+, (\d+)>"
    r"|_GLOBAL__N_1\d+(reduce|elementwise)_kernelI([ft])Li\d+ELi(\d+)E")
_OURS = re.compile(r"(Band|Bcsr)Walk|_GLOBAL__N_1\d+(reduce|elementwise)_"
                   r"kernelI|^(?:void )?\(anonymous namespace\)::(reduce|"
                   r"elementwise)_kernel<")


def card_kernel(name: str):
    """(kind, slab dtype or norm pass, x dtype of a norm pass) of one of
    this repo's kernels by its profiler name; None for another kernel."""
    if m := _F32_SPMM.search(name):
        return m[1], "float32", None
    if m := _TC_SPMM.search(name):
        return m[3].lower(), TYPE_NAMES[m[1] or m[2]], None
    if "dense_q_kernel" in name:
        return "dense_q", None, None
    if m := _NORM.search(name):
        kind, t, mode = (m[1], m[2], m[3]) if m[1] else (m[4], m[5], m[6])
        return "norm", NORM_PASSES[kind, mode], TYPE_NAMES[t]
    check(not _OURS.search(name), f"a kernel of this repo's name that "
          f"card_kernel cannot read: {name[:200]}")
    return None


def profiled_counts(prof) -> tuple:
    """(this repo's kernels that ran in a torch.profiler session, in
    full_counts()' form; their counts by profiler name)."""
    card, names = counts_form(), {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = card_kernel(e.key)
        if key is None:
            continue
        names[e.key[:90]] = names.get(e.key[:90], 0) + e.count
        kind, sub, x_dtype = key
        if kind == "dense_q":
            card["dense_q"] += e.count
            continue
        card[kind][sub] = card[kind].get(sub, 0) + e.count
        if kind == "norm":
            nd = card["norm_dtype"]
            nd[x_dtype] = nd.get(x_dtype, 0) + e.count
    return card, names


@contextlib.contextmanager
def profiled_kernels():
    """This repo's kernels in the block by torch.profiler (CUDA activity),
    which waits PROFILER_SETTLE_S after it starts and before it stops:
    yields a dict that gets ``card`` (full_counts()' form) and ``names``
    (by profiler name) when the block ends. The profiler loses kernel
    records now and then (PERF.md §7), so it confirms; card_counts
    counts."""
    out = {}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILER_SETTLE_S)
        yield out
        torch.cuda.synchronize()
        time.sleep(PROFILER_SETTLE_S)
    out["card"], out["names"] = profiled_counts(prof)


# the device counters' slots (csrc/spmm_common.cuh and graph_norm.cu
# count_launch): SpMM by slab dtype code, the norm by x dtype and pass
SLAB_SLOTS = ("float32", "bfloat16", "int8")
NORM_SLOTS = ("colsum", "varsum", "bwd_reduce", "affine", "bwd_dx")


def card_read(lib: str, n: int, reset: bool) -> list:
    """A kernel library's n device launch counters (glass_launches),
    zeroed after the read if ``reset``."""
    buf = (ctypes.c_ulonglong * n)()
    rc = _build.load(lib).glass_launches(buf, int(reset))
    check(rc == 0, f"{lib}: glass_launches returned CUDA error {rc}")
    return list(buf)


def card_counts(reset: bool = False) -> dict:
    """The launches the card ran since the counters were last reset, in
    full_counts()' form: every kernel adds one to its library's device
    counter when it runs (thread 0 of CTA 0), a replay of a captured step
    as much as an eager call; zeroed after the read if ``reset``."""
    torch.cuda.synchronize()
    out = counts_form()
    for lib, kind in (("bcsr_spmm", "bcsr"), ("band_spmm", "band")):
        out[kind] = {d: n for d, n in zip(SLAB_SLOTS,
                                          card_read(lib, 3, reset)) if n}
    out["dense_q"] = card_read("dense_q_spmm", 3, reset)[2]
    norm = card_read("graph_norm", 10, reset)
    for i, dt in enumerate(("float32", "bfloat16")):
        for j, name in enumerate(NORM_SLOTS):
            if n := norm[5 * i + j]:
                out["norm"][name] = out["norm"].get(name, 0) + n
                out["norm_dtype"][dt] = out["norm_dtype"].get(dt, 0) + n
    return out


def card_embedding(reset: bool = False) -> int:
    """The card's launches of the embedding backward (one a backward)
    since the counter was last reset (csrc/embedding_bwd.cu
    count_launch); zeroed after the read if ``reset``."""
    torch.cuda.synchronize()
    return card_read("embedding_bwd", 1, reset)[0]


class Launches:
    """What a span of the script launched: ``card``, the launches the
    card ran (card_counts), and ``counted``, the wrappers' counts (a
    captured step counts once, at its capture, and its replays nothing),
    both in full_counts()' form."""
    card: dict
    counted: dict


@contextlib.contextmanager
def card_launches(probe=None):
    """Measures the launches of the block (the kernels line's "launches"
    on a path that trains or serves, which replays captured steps and
    programs): the wrappers' and the card's counts set to 0 at its start
    and read at its end. Fails if the card ran a kernel that no wrapper
    counted in the span, nor the capture of a program that ``probe`` (a
    ProgramProbe over the span) saw replayed."""
    out = Launches()
    reset_counts()  # the path starts here
    card_counts(reset=True)
    yield out
    out.card = card_counts()  # ... and ends here
    out.counted = full_counts()
    seen = scaled_sum((1, out.counted), *(
        (1, p.counts) for p, _ in (probe.replays.values() if probe else ())))
    ran = {(k, d) for k in ("bcsr", "band", "norm") for d in out.card[k]}
    counted = {(k, d) for k in ("bcsr", "band", "norm") for d in seen[k]}
    check(ran <= counted and (out.card["dense_q"] == 0
                              or seen["dense_q"] > 0),
          f"the card ran {out.card}, the wrappers counted {out.counted}")


DENSE_ZERO_ROW = 5  # an isolated node: an all-zero row of the layout


def dense_q_graph(device, n=700, seed=22):
    """A random directed graph of n nodes under "mean" normalization with
    the int8 dense layout (A^T a layout of its own); node DENSE_ZERO_ROW
    has no edges."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, 8 * n))
    ei = ei[:, (ei != DENSE_ZERO_ROW).all(axis=0)]
    graph = build_graph(ei, None, n, "mean", materialize_dense=True,
                        dense_dtype="int8", device=device)
    check(graph.dense_q is not None and graph.dense_q_t is not graph.dense_q,
          "the small graph has no asymmetric int8 dense pair")
    check(not graph.dense_q.q[DENSE_ZERO_ROW].any(),
          "the small int8 dense layout has no all-zero row")
    return graph


def phase_kernel_q_small(device) -> None:
    """Every bf16 and int8 instantiation against its plain version."""
    gen = torch.Generator().manual_seed(21)
    for dd in ("bf16", "int8"):
        for name, band in small_band_layouts(device, dd).items():
            for xdt in X_DTYPES:
                for h in (17, 64, 128):
                    x = torch.randn(band.n_node, h, generator=gen).to(
                        device, xdt)
                    err, scale = check_vs_plain(
                        f"band {dd} {name} x {xdt} H={h}",
                        lambda v: bd.band_spmm(band, v),
                        lambda v: bd.band_spmm_reference(band, v), x)
                    emit("kernel_q_small", kernel="band", layout=name,
                         slabs=str(band.slabs.dtype), x=str(xdt), H=h,
                         max_abs_err=err, max_abs_ref=scale)
    ei, w, n = small_layout_edges()
    for dd in ("bf16", "int8"):
        bcsr = build_graph(ei, w, n, "sum", materialize_dense=False,
                           materialize_bcsr=True, sparse_layout="bcsr",
                           dense_dtype=dd, device=device).bcsr
        for xdt in X_DTYPES:
            for h in (17, 128):
                x = torch.randn(n, h, generator=gen).to(device, xdt)
                err, scale = check_vs_plain(
                    f"bcsr {dd} x {xdt} H={h}",
                    lambda v: bs.bcsr_spmm(bcsr, v),
                    lambda v: bs.bcsr_spmm_reference(bcsr, v), x)
                emit("kernel_q_small", kernel="bcsr",
                     blocks=str(bcsr.blocks.dtype), x=str(xdt), H=h,
                     max_abs_err=err, max_abs_ref=scale)
    for n in (700, 1100):  # n % 128 != 0, an all-zero row
        layout = dense_q_graph(device, n).dense_q
        for xdt in X_DTYPES:
            for h in (17, 64, 200):  # 200: four column tiles
                x = torch.randn(n, h, generator=gen).to(device, xdt)
                err, scale = check_vs_plain(
                    f"dense_q n={n} x {xdt} H={h}",
                    lambda v: dq.dense_q_spmm(layout, None, v),
                    lambda v: dq.dense_q_spmm_reference(layout, v), x)
                emit("kernel_q_small", kernel="dense_q", n_node=n,
                     x=str(xdt), H=h, max_abs_err=err, max_abs_ref=scale)


def phase_grad_q_small(device) -> None:
    """dx through each autograd Function on an asymmetric graph against the
    plain version over the transposed layout, in x's dtype: within
    KERNEL_TOL * max for f32 x; for bf16 x also one bf16 ulp of each value
    (the same f32 sum, taken in another order, may round to the
    neighbouring bf16 value)."""
    gen = torch.Generator().manual_seed(23)
    ei, n = clustered_graph(12, BLOCK, 6000, seed=5)
    h = 64
    w = torch.randn(n, h, generator=gen).to(device)
    for layout, dd in (("band", "int8"), ("band", "bf16"), ("bcsr", "int8"),
                       ("bcsr", "bf16"), ("dense", "int8")):
        kw = (dict(materialize_dense=True) if layout == "dense" else
              dict(materialize_dense=False, materialize_bcsr=True,
                   sparse_layout=layout))
        g = build_graph(ei, None, n, "mean", dense_dtype=dd, device=device,
                        **kw)
        fwd, bwd, fn, plain = {
            "band": (g.band, g.band_t, bd.band_spmm, bd.band_spmm_reference),
            "bcsr": (g.bcsr, g.bcsr_t, bs.bcsr_spmm, bs.bcsr_spmm_reference),
            "dense": (g.dense_q, g.dense_q_t,
                      lambda a, v, a_t: dq.dense_q_spmm(a, a_t, v),
                      dq.dense_q_spmm_reference)}[layout]
        check(fwd is not None and bwd is not fwd,
              f"the mean graph's {layout} {dd} layout is not an asymmetric "
              "pair")
        for xdt in X_DTYPES:
            x = torch.randn(n, h, generator=gen).to(device, xdt)
            reset_counts()
            xk = x.clone().requires_grad_()
            (dx,) = torch.autograd.grad((fn(fwd, xk, bwd) * w).sum(), xk)
            c = launch_counts()
            launches = sum(c["band"].values()) + sum(c["bcsr"].values()) \
                + c["dense_q"]
            dx_ref = plain(bwd, w).to(xdt)
            sync(device)
            err = float((dx.float() - dx_ref.float()).abs().max())
            scale = float(dx_ref.float().abs().max())
            tol = KERNEL_TOL * scale
            if xdt == torch.bfloat16:
                tol = tol + 2.0 ** -8 * dx_ref.float().abs()
            check(dx.dtype == xdt, f"{layout} {dd}: dx of {dx.dtype}")
            check(launches == 2, f"{layout} {dd}: {launches} launches")
            check(bool(((dx.float() - dx_ref.float()).abs() <= tol).all()),
                  f"{layout} {dd} x {xdt}: dx vs plain max|diff| {err}")
            emit("grad_q_small", layout=layout, adjacency=dd, x=str(xdt),
                 n_node=n, H=h, launches=launches, max_abs_err=err,
                 max_abs_ref=scale)


def phase_train_q_small(device) -> None:
    """3 steps with bf16 compute, card vs CPU, on int8 and bf16 layouts."""
    for layout, dd in (("band", "int8"), ("bcsr", "bf16")):
        losses, params = small_training(device, layout, dd, "bfloat16")
        losses_cpu, params_cpu = small_training(torch.device("cpu"), layout,
                                                dd, "bfloat16")
        loss_err = float(np.abs(losses - losses_cpu).max())
        param_err = max(float((params[k] - params_cpu[k]).abs().max())
                        for k in params)
        check(np.isfinite(losses).all(), f"{layout} {dd}: non-finite losses")
        check(np.allclose(losses, losses_cpu, rtol=TRAIN_Q_LOSS_RTOL, atol=0),
              f"{layout} {dd}: card losses {losses} vs CPU {losses_cpu}")
        check(param_err <= TRAIN_PARAM_ATOL_LRS * EM_USER["lr"],
              f"{layout} {dd}: parameters differ by {param_err}")
        check(all(v.dtype == torch.float32 for v in params.values()),
              "a parameter left f32")
        emit("train_q_small", layout=layout, adjacency=dd,
             compute="bfloat16", steps=len(losses), losses=losses.tolist(),
             max_abs_loss_diff=loss_err, max_abs_param_diff=param_err)


def kernel_record(name: str, source: str, replaces: str, tpu: list, fn,
                  plain, library, x, bound: tuple, err: float) -> dict:
    """A kernels-line record: the kernel, its plain version and the library
    call timed on x (``timed``)."""
    rec = dict(name=name, route="cuda", source=source, replaces=replaces,
               tpu=tpu, max_abs_err=err,
               **timed(lambda: fn(x), lambda: plain(x), lambda: library(x)))
    rec["bound_ms"], rec["bound_by"] = bound
    return rec


class ProgramProbe:
    """Wraps the captured inference programs (utils/graphs.py) while a span
    lasts: ``programs``, those captured in it, each with ``counts``, its
    launches as the wrappers counted them at the capture (one call's);
    and the replays in the span of every program captured under a probe.
    A program's first call runs eagerly just before its capture, so over
    the span the card runs the counts of each program captured in it once
    for that call, and those of every program once a replay (``want``)."""

    target = InferenceProgram

    def __init__(self):
        self.programs, self.replays = [], {}

    def __enter__(self):
        cls = self.target
        self._real = cls.__init__, cls.__call__
        real_init, real_call = self._real

        def init(prog, *args, **kw):
            before = full_counts()
            real_init(prog, *args, **kw)
            if prog.graph is not None:
                prog.counts = counts_delta(before, full_counts())
                self.programs.append(prog)

        def call(prog, *inputs):
            check(hasattr(prog, "counts"), "a program captured outside a "
                  "probe replayed inside one")
            self.replays.setdefault(id(prog), [prog, 0])[1] += 1
            return real_call(prog, *inputs)

        cls.__init__, cls.__call__ = init, call
        return self

    def __exit__(self, *exc):
        self.target.__init__, self.target.__call__ = self._real

    def want(self) -> dict:
        """The launches the card ran for the span's programs: each
        capture's counts once, and each program's once a replay."""
        return scaled_sum(*((1, p.counts) for p in self.programs),
                          *((n, p.counts) for p, n in self.replays.values()))

    def replayed(self) -> int:
        """The replays in the span."""
        return sum(n for _, n in self.replays.values())


class StepProbe(ProgramProbe):
    """ProgramProbe over the captured training steps (utils/graphs.py's
    StepGraph: Trainer's, pretrain_once's and the GNN-seg protocol's):
    ``programs``, the steps captured in the span with their ``counts``
    (one step's launches), and their replays. A step's first call runs
    eagerly just before its capture, so ``want`` is again the launches the
    card ran for the span's steps."""

    target = StepGraph


def check_served(what: str, ran: Launches, probe: ProgramProbe,
                 per_call: dict) -> None:
    """A span that served through captured programs only: every capture
    counted ``per_call`` (one request's or eval's launches), and the card
    ran the captures' counts once for each first (eager) call and once a
    replay, and nothing else."""
    check(probe.programs or probe.replays, f"{what}: no program ran")
    for i, p in enumerate(probe.programs
                          + [p for p, _ in probe.replays.values()]):
        check(p.counts == per_call, f"{what}: program {i} counted "
              f"{p.counts}, a call is {per_call}")
    check(ran.card == probe.want(), f"{what}: the card ran {ran.card}, the "
          f"captures' counts times (1 + replays) are {probe.want()}")


def serve_requests(pred, requests, expect: dict, per_request: int) -> tuple:
    """Serves each request twice (checked bit-identical), each in a bucket
    of its own: the first call of a bucket runs eagerly and captures its
    program, the second replays it. The card's counters and the captures'
    counts are read around them: fails unless each capture counted
    ``expect`` scaled to ``per_request`` launches and the card ran that
    twice a request (check_served). Returns (served (subs, logits, first
    ms, repeat ms) list, the card's launches)."""
    check(len({pred_bucket(pred, subs) for subs in requests})
          == len(requests), "two requests share a bucket")
    served = []
    probe = ProgramProbe()
    with card_launches(probe) as ran, probe:
        for subs in requests:  # the serving path starts here
            t0 = time.perf_counter()
            out = pred(subs)
            t1 = time.perf_counter()
            again = pred(subs)
            t2 = time.perf_counter()
            check(out.shape == (len(subs), 1) and out.dtype == np.float32
                  and np.isfinite(out).all(),
                  f"request logits {out.shape} {out.dtype}")
            check(np.array_equal(out, again), "repeated request differs")
            served.append((subs, out, (t1 - t0) * 1e3, (t2 - t1) * 1e3))
    per = counts_form(**{k: ({v: per_request} if isinstance(v, str)
                             else per_request) for k, v in expect.items()})
    check_served("serving", ran, probe, per)  # ... and ends here
    return served, 2 * len(requests) * per_request


def pred_bucket(pred, subs) -> tuple:
    """The (batch, width) bucket a request lands in."""
    return (_bucket(len(subs), pred.batch_buckets),
            _bucket(max(map(len, subs)), pred.width_buckets))


def phase_band_q_main(device, f32_score: float, n_comm=N_COMM, csz=COMM_SIZE,
                      edges=UNDIRECTED_EDGES) -> dict:
    """em_user with dense_dtype "int8" and compute_dtype "bfloat16" on the
    stand-in: the layout, the int8 band kernel at its training shape,
    training and requests. Returns the kernel's record."""
    gen = torch.Generator().manual_seed(24)
    ei, n = clustered_graph(n_comm, csz, edges)
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="band", dense_dtype="int8",
                        device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    band = graph.band
    check(band is not None and graph.band_t is band
          and band.slabs.dtype == torch.int8,
          "the em_user graph has no symmetric int8 band layout")
    law = (band.rps, band.w_blocks, band.affine_stride, band.affine_off)
    check(law == EM_USER_BAND_LAW,
          f"(rps, w_blocks, stride, off) {law}, expected {EM_USER_BAND_LAW}")
    nz = nonzero_band_blocks(band)
    emit("graph_band_q", n_node=n, rps=band.rps, w_blocks=band.w_blocks,
         affine_stride=band.affine_stride, affine_off=band.affine_off,
         groups=band.n_groups, slab_bytes=band.slabs.numel(),
         scale_bytes=scale_bytes(band), nonzero_blocks=nz, build_s=build_s)

    h = EM_USER["hidden_dim"]
    x = torch.randn(n, h, generator=gen).to(device, torch.bfloat16)
    err, scale = check_vs_plain("em_user int8 band",
                                lambda v: bd.band_spmm(band, v),
                                lambda v: bd.band_spmm_reference(band, v), x)
    adj = csr_adjacency(graph)
    record = kernel_record(
        "band_spmm_int8", "glass_tpu_torch/csrc/band_spmm.cu",
        "glass_tpu/ops/pallas_band.py:714",
        ["glass_tpu/ops/pallas_band.py:714 _band_kernel_affine_q"],
        lambda v: bd.band_spmm(band, v),
        lambda v: bd.band_spmm_reference(band, v),
        lambda v: torch.sparse.mm(adj, v.float()), x,
        band_bound_ms(band, x), err)
    emit("kernel_band_q_main", H=h, x="bfloat16", max_abs_err=err,
         max_abs_ref=scale, **{k: record[k] for k in TIME_KEYS})
    del adj, x

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    max_deg = int(feats_np.max())
    model = em_user_model(max_deg, "pallas", device,
                          dropout=EM_USER["dropout"], compute_dtype="bfloat16")
    rng = np.random.default_rng(15)  # the f32 run's subgraphs and batches
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS + EVAL_SUBGRAPHS,
                                     n_comm, csz)
    bsz = EM_USER["batch_size"]
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=EM_USER["lr"], resi=EM_USER["resi"], batch_size=bsz, loss="bce"))
    trainer.init(0)
    torch.cuda.reset_peak_memory_stats(device)
    losses, steps, step_ms = [], 0, []
    with card_launches() as ran:
        for epoch in range(TRAIN_EPOCHS):
            pos_b, y_b = make_train_batches(rng, pos[:TRAIN_SUBGRAPHS],
                                            y[:TRAIN_SUBGRAPHS], bsz)
            t0 = time.perf_counter()
            res = trainer.train_epoch(pos_b, y_b)
            step_ms.append((time.perf_counter() - t0) * 1e3
                           / len(res.step_losses))
            losses.append(res.loss)
            steps += len(res.step_losses)
            emit("train_q_epoch", epoch=epoch, mean_loss=res.loss,
                 steps=len(res.step_losses), ms_per_step=step_ms[-1])
    want = 2 * EM_USER["conv_layer"] * steps
    check(ran.card == counts_form(band={"int8": want}),
          f"the card ran {ran.card}: expected {want} int8-band launches "
          "and no other kernel of this repo")
    launches = ran.card["band"]["int8"]
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    check(np.isfinite(losses).all(), f"non-finite epoch losses {losses}")
    check(losses[-1] < losses[0], f"epoch losses did not fall: {losses}")
    pos_e, y_e, _ = make_eval_batches(pos[TRAIN_SUBGRAPHS:],
                                      y[TRAIN_SUBGRAPHS:], bsz)
    y_pad, mask = pad_eval_labels(y_e, pos_e.shape[0], bsz)
    score = trainer.evaluate_score(pos_e, y_pad, mask)
    emit("train_q", adjacency="int8", compute="bfloat16", epochs=len(losses),
         steps=steps, int8_band_launches=launches,
         launches_per_step=launches / steps, epoch_losses=losses,
         ms_per_step=step_ms, eval_micro_f1=score,
         f32_eval_micro_f1=f32_score, peak_mem_gib=peak_gib)
    record["launches"] = launches
    record["launches_per_step"] = launches / steps

    pred = Predictor(model, graph, feats, device=device)
    model_seg = em_user_model(max_deg, "segment", device)
    model_seg.load_state_dict(model.state_dict())
    pred_seg = Predictor(model_seg, graph, feats, device=device)
    requests = [make_request(np.random.default_rng(16), b, n_comm, csz)
                for b in REQUEST_BATCHES]
    served, _ = serve_requests(pred, requests, {"band": "int8"},
                               EM_USER["conv_layer"])
    for subs, out, ms, _ in served:
        ref = pred_seg(subs)
        diff = float(np.abs(out - ref).max())
        check(np.allclose(out, ref, rtol=QUANT_RTOL, atol=QUANT_ATOL),
              f"int8/bf16 batch {len(subs)} vs f32 segment: max|diff| {diff}")
        emit("request_band_q", batch=len(subs), width=max(map(len, subs)),
             ms_first=ms, max_abs_diff_vs_f32_segment=diff,
             max_abs_logit=float(np.abs(ref).max()))
    return record


def phase_q_layouts_main(device, n_comm=N_COMM, csz=COMM_SIZE,
                         edges=UNDIRECTED_EDGES) -> list:
    """The bf16 band and the int8 BCSR layouts at the em_user shape: each
    kernel against its plain version and timed, then requests of a bf16
    model served on the layout. Returns the two kernels' records."""
    gen = torch.Generator().manual_seed(25)
    ei, n = clustered_graph(n_comm, csz, edges)
    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    h = EM_USER["hidden_dim"]
    records = []
    for layout, dd, name, replaces, tpu in (
            ("band", "bf16", "band_spmm_bf16",
             "glass_tpu/ops/pallas_band.py:658", BAND_TPU),
            ("bcsr", "int8", "bcsr_spmm_int8",
             "glass_tpu/ops/pallas_spmm.py:411",
             ["glass_tpu/ops/pallas_spmm.py:321 _bcsr_chunk_kernel",
              "glass_tpu/ops/pallas_spmm.py:411 _bcsr_chunk_kernel_large"])):
        graph = build_graph(ei, None, n, EM_USER["aggr"],
                            materialize_bcsr=True, sparse_layout=layout,
                            dense_dtype=dd, device=device)
        held = graph.band if layout == "band" else graph.bcsr
        want = torch.bfloat16 if dd == "bf16" else torch.int8
        check(held is not None and (held.slabs if layout == "band"
                                    else held.blocks).dtype == want,
              f"the em_user graph has no {dd} {layout} layout")
        check(layout != "band" or (held.rps, held.w_blocks, held.affine_stride,
                                   held.affine_off) == EM_USER_BAND_LAW,
              f"the {dd} band is not the planner's {EM_USER_BAND_LAW}")
        fn = bd.band_spmm if layout == "band" else bs.bcsr_spmm
        plain = (bd.band_spmm_reference if layout == "band"
                 else bs.bcsr_spmm_reference)
        x = torch.randn(n, h, generator=gen).to(device, torch.bfloat16)
        err, scale = check_vs_plain(f"em_user {dd} {layout}",
                                    lambda v: fn(held, v),
                                    lambda v: plain(held, v), x)
        adj = csr_adjacency(graph)
        bound = (band_bound_ms(held, x) if layout == "band"
                 else bound_ms(held, x))
        rec = kernel_record(
            name, f"glass_tpu_torch/csrc/{layout}_spmm.cu", replaces, tpu,
            lambda v: fn(held, v),
            lambda v: plain(held, v), lambda v: torch.sparse.mm(adj, v.float()),
            x, bound, err)
        emit(f"kernel_{layout}_{dd}_main", H=h, x="bfloat16",
             max_abs_err=err, max_abs_ref=scale,
             **{k: rec[k] for k in TIME_KEYS})
        del adj, x
        model = em_user_model(int(feats_np.max()), "pallas", device,
                              compute_dtype="bfloat16")
        pred = Predictor(model, graph, feats, device=device)
        requests = [make_request(np.random.default_rng(17), b, n_comm, csz)
                    for b in REQUEST_BATCHES]
        served, rec["launches"] = serve_requests(
            pred, requests, {layout: "bfloat16" if dd == "bf16" else "int8"},
            EM_USER["conv_layer"])
        for subs, out, ms, _ in served:
            emit(f"request_{layout}_{dd}", batch=len(subs), ms_first=ms,
                 max_abs_logit=float(np.abs(out).max()))
        records.append(rec)
        del graph, held, pred, model
    return records


def hpo_graph(n=HPO_NODES, e_directed=HPO_DIRECTED_EDGES):
    """Unstructured random graph at the hpo_metab scale, the recipe of
    bench.py::hpo_graph. Returns (edge_index, n)."""
    rng = np.random.default_rng(7)
    e = e_directed // 2
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    return np.stack([np.concatenate([src, dst]),
                     np.concatenate([dst, src])]), n


def class_labelled_subgraphs(rng, count: int, n: int, classes: int):
    """(pos, y): ``count`` random node sets of 4-64 nodes, padded with -1,
    labelled by size into ``classes`` equal-count bins."""
    sizes = rng.integers(4, 65, count)
    pos = np.full((count, sizes.max()), -1, dtype=np.int64)
    for i, k in enumerate(sizes):
        pos[i, :k] = rng.choice(n, k, replace=False)
    edges = np.quantile(sizes, np.linspace(0, 1, classes + 1)[1:-1])
    return pos, np.digitize(sizes, edges).astype(np.int64)


def phase_dense_q_main(device) -> dict:
    """The dense route at hpo scale with dense_dtype "int8": the layout,
    the kernel at its training shape beside torch.matmul of q's bf16 copy,
    and training with hpo_metab's settings. Returns the kernel's record."""
    gen = torch.Generator().manual_seed(26)
    ei, n = hpo_graph()
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, HPO_METAB["aggr"], materialize_dense=True,
                        dense_dtype="int8", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    layout = graph.dense_q
    check(graph.dense is None and layout is not None
          and graph.dense_q_t is layout,
          "the hpo graph has no symmetric int8 dense layout")
    n_rp, n_cp = layout.q.shape[0] // BLOCK, layout.q.shape[1] // BLOCK
    nz = int((layout.q.view(n_rp, BLOCK, n_cp, BLOCK) != 0)
             .any(dim=3).any(dim=1).sum())
    h = HPO_METAB["hidden_dim"]
    emit("graph_dense_q", n_node=n, directed_edges=graph.n_edge,
         q_bytes=layout.q.numel(), nonzero_blocks=nz, blocks=n_rp * n_cp,
         build_s=build_s)

    x = torch.randn(n, h, generator=gen).to(device)  # f32 compute
    err, scale = check_vs_plain(
        "hpo dense_q", lambda v: dq.dense_q_spmm(layout, None, v),
        lambda v: dq.dense_q_spmm_reference(layout, v), x)
    q_bf16 = layout.q.to(torch.bfloat16)

    def library(v):
        v_pad = v.new_zeros((layout.q.shape[1], h), dtype=torch.bfloat16)
        v_pad[:n] = v
        return torch.matmul(q_bf16, v_pad) * layout.scale[:, None]

    record = kernel_record(
        "dense_q_spmm", "glass_tpu_torch/csrc/dense_q_spmm.cu",
        "glass_tpu/ops/pallas_dense.py:82",
        ["glass_tpu/ops/pallas_dense.py:82 _kernel"],
        lambda v: dq.dense_q_spmm(layout, None, v),
        lambda v: dq.dense_q_spmm_reference(layout, v), library, x,
        least_ms(nz, layout.q, layout.scale.numel() * 4, x, n), err)
    lib_err = float((library(x)[:n] - dq.dense_q_spmm_reference(layout, x))
                    .abs().max())
    emit("kernel_dense_q_main", H=h, x="float32",
         max_abs_err=err, max_abs_ref=scale, library_max_abs_diff=lib_err,
         **{k: record[k] for k in TIME_KEYS})
    del q_bf16, x

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    model = GLASS(int(feats_np.max()), h, HPO_METAB["conv_layer"],
                  (HPO_CLASSES,), (HPO_METAB["pool"],),
                  activation=HPO_METAB["activation"],
                  z_ratio=HPO_METAB["z_ratio"], jk=HPO_METAB["jk"],
                  dropout=HPO_METAB["dropout"], spmm_mode="dense", seed=0,
                  device=device)
    rng = np.random.default_rng(27)
    pos, y = class_labelled_subgraphs(rng, HPO_SUBGRAPHS, n, HPO_CLASSES)
    bsz = HPO_METAB["batch_size"]
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=HPO_METAB["lr"], resi=HPO_METAB["resi"], batch_size=bsz,
        loss="ce"))
    trainer.init(0)
    torch.cuda.reset_peak_memory_stats(device)
    losses, steps, step_ms = [], 0, []
    with card_launches() as ran:
        for epoch in range(HPO_EPOCHS):
            pos_b, y_b = make_train_batches(rng, pos, y, bsz)
            t0 = time.perf_counter()
            res = trainer.train_epoch(pos_b, y_b)
            step_ms.append((time.perf_counter() - t0) * 1e3
                           / len(res.step_losses))
            losses.append(res.loss)
            steps += len(res.step_losses)
    want = 2 * HPO_METAB["conv_layer"] * steps
    check(ran.card == counts_form(dense_q=want),
          f"the card ran {ran.card}: expected {want} dense_q launches only")
    launches = ran.card["dense_q"]
    check(np.isfinite(losses).all(), f"non-finite epoch losses {losses}")
    emit("train_dense_q", epochs=len(losses), steps=steps, batch=bsz,
         classes=HPO_CLASSES, loss="ce", dense_q_launches=launches,
         launches_per_step=launches / steps, epoch_losses=losses,
         ms_per_step=step_ms,
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    record["launches"] = launches
    record["launches_per_step"] = launches / steps

    per_fwd = forward_launches(graph, model, False)
    splits = {s: class_labelled_subgraphs(rng, HPO_EVAL_SPLIT, n, HPO_CLASSES)
              for s in ("val", "test")}
    phase_eval_graph("hpo_dense_q", trainer, splits, per_fwd)
    phase_request_graph(
        "hpo_dense_q", Predictor(model, graph, feats, device=device),
        lambda r, b: [r.choice(n, k, replace=False).tolist()
                      for k in r.integers(4, 65, b).tolist()], per_fwd)
    return record


# ------------------------------------------------------- fused GraphNorm

# each pass's TPU kernel (glass_tpu/ops/pallas_norm.py)
NORM_TPU = {
    "colsum": "glass_tpu/ops/pallas_norm.py:61 _colsum_kernel",
    "varsum": "glass_tpu/ops/pallas_norm.py:71 _varsum_kernel",
    "affine": "glass_tpu/ops/pallas_norm.py:86 _affine_kernel",
    "bwd_reduce": "glass_tpu/ops/pallas_norm.py:92 _bwd_reduce_kernel",
    "bwd_dx": "glass_tpu/ops/pallas_norm.py:106 _bwd_dx_kernel",
}
# the fused norm's gradients against the plain Function's and the unfused
# graph_norm's: sums in another order feed s^3-scaled terms, so 1e-4 *
# max|ref| (tests/test_torch_fused_norm.py's VJP tolerance)
NORM_GRAD_TOL = 1e-4
# a zero-variance column (s = rsqrt(eps) ~ 316 amplifies the rounding of
# c - alpha*mu): its values are rounding noise, held within 2e-3 * max|ref|
# of the whole tensor, the bound measured on the CPU against the JAX
# package (tests/test_torch_fused_norm.py, at most 6.7e-4 there)
ZERO_VAR_TOL = 2e-3
ZERO_VAR_COL = 3
BF16_ULP = 2.0 ** -7
# dx at N = 1 against the exact f64 gradient: within this many f32
# roundings of the formula's terms times 1 + kappa (dx_error_bound); the
# plain Function and graph_norm's autograd read at most 6.4 of them on the
# CPU (30 draws each of N 1-3, F 17, 64, 200, f32 and bf16 x)
NORM_DX_ROUNDINGS = 16
NORM_DX_DRAWS = 8
# N = 3001 comes again after N = 1000: each N has its own P (CTAs of a
# reduction), so a ticket counter that a launch failed to reset would show
# as a wrong or non-repeatable result at the second 3001
NORM_SMALL_N, NORM_SMALL_F = (1, 3001, 1000, 3001), (17, 64, 200)
NORM_EPS = 1e-5
# component's activations (glass_tpu/configs/component.yml: 17,260 nodes,
# hidden 17), where no F is a multiple of a 16-byte chunk
COMPONENT_N = 17_260
# an F that 16-byte chunks divide, for the unaligned views (one value a
# load) against the aligned path
NORM_UNALIGNED_SHAPE = (3001, 64)
# few rows of a long column period (F / gcd(F, 16-byte chunk)): one
# period of K3/K5's walking threads is more than the CTAs its chunks need
NORM_LONG_PERIOD_SHAPES = ((1, 514), (3, 1025))
HOST_CALLS, HOST_GROUPS = 200, 5


@contextlib.contextmanager
def env_switch(name: str, on: bool):
    """The environment switch ``name`` set to "1" or "0" inside the
    block."""
    old = os.environ.get(name)
    os.environ[name] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def fused_norm(on: bool):
    """GLASS_TPU_FUSED_NORM set to "1" or "0" inside the block."""
    return env_switch("GLASS_TPU_FUSED_NORM", on)


def remat(on: bool):
    """GLASS_TPU_REMAT set to "1" or "0" inside the block."""
    return env_switch("GLASS_TPU_REMAT", on)


@contextlib.contextmanager
def deterministic(on: bool = True):
    """torch.use_deterministic_algorithms(True, warn_only=True) inside the
    block: PyTorch's ops take their deterministic algorithms where they
    have one. nn.Embedding's backward over more than 3,072 ids with
    repeats (the em_user trunk's degree features) otherwise accumulates
    in an order that changes from run to run (PERF.md §7)."""
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def norm_case(gen, n: int, f: int, dtype, device):
    """(x, dy, the per-feature vectors the passes take) with x ~ 3 N(0, 1)
    + 1.5 and one constant column (ZERO_VAR_COL) where F has it; w, b ~
    N(0, 1) and mean_scale ~ 0.3 N(0, 1) + 1, 1 at the constant column so
    that its variance is 0; mu, am, var, g, h, a, c2 and c1 from the plain
    passes on x and dy, as the Function would hand them on."""
    x = torch.randn(n, f, generator=gen) * 3 + 1.5
    if f > ZERO_VAR_COL:
        x[:, ZERO_VAR_COL] = 2.7
    dy = torch.randn(n, f, generator=gen)
    w, b = (torch.randn(f, generator=gen) for _ in range(2))
    ms = torch.randn(f, generator=gen) * 0.3 + 1
    if f > ZERO_VAR_COL:
        ms[ZERO_VAR_COL] = 1.0
    x, dy = x.to(device, dtype), dy.to(device, dtype)
    v = dict(w=w.to(device), b=b.to(device), ms=ms.to(device))
    _, v["mu"], v["am"] = fn.colsum_reference(x, v["ms"])
    _, v["var"], v["g"], v["h"] = fn.varsum_reference(
        x, v["am"], v["mu"], v["ms"], v["w"], v["b"], NORM_EPS)
    v["a"], v["c2"], v["c1"] = fn.bwd_reduce_reference(
        dy, x, v["am"], v["mu"], v["var"], v["w"], v["ms"], NORM_EPS)[2:5]
    return x, dy, v


def pass_args(kernel: str, x, dy, v) -> tuple:
    return {"colsum": (x, v["ms"]),
            "varsum": (x, v["am"], v["mu"], v["ms"], v["w"], v["b"],
                       NORM_EPS),
            "affine": (x, v["g"], v["h"]),
            "bwd_reduce": (dy, x, v["am"], v["mu"], v["var"], v["w"],
                           v["ms"], NORM_EPS),
            "bwd_dx": (dy, x, v["a"], v["c2"], v["c1"])}[kernel]


def pass_outputs(kernel: str) -> tuple:
    """The names of a pass's outputs: a reduction's sums and derived
    vectors (fused_norm.OUTPUTS), an elementwise pass's one tensor."""
    return fn.OUTPUTS.get(kernel, ("y" if kernel == "affine" else "dx",))


def check_pass(what: str, kernel: str, args) -> tuple:
    """({output: [max |kernel - plain|, max |plain|]}, the kernel's outputs)
    of one pass; fails where an output (a sum, a derived vector) is past
    KERNEL_TOL * its max|plain|, where an elementwise result (K3, K5: the
    same f32 operations in the same order, one rounding to x's type)
    differs from the plain version's in any bit, on a non-finite value, a
    dtype or shape mismatch, or if a repeated call differs in any bit."""
    run, plain = getattr(fn, kernel), getattr(fn, f"{kernel}_reference")
    out, again, ref = run(*args), run(*args), plain(*args)
    out, again, ref = ((t if isinstance(t, tuple) else (t,))
                       for t in (out, again, ref))
    torch.cuda.synchronize()
    check(len(out) == len(ref), f"{what}: {len(out)} outputs, {len(ref)} plain")
    errs = {}
    for name, o, a, r in zip(pass_outputs(kernel), out, again, ref):
        check(o.dtype == r.dtype and o.shape == r.shape,
              f"{what} {name}: output {o.dtype} {tuple(o.shape)}")
        check(torch.isfinite(o.float()).all().item(),
              f"{what} {name}: non-finite")
        check(torch.equal(o, a), f"{what} {name}: repeated call differs")
        err = float((o.float() - r.float()).abs().max())
        scale = float(r.float().abs().max())
        check(err <= KERNEL_TOL * scale,
              f"{what} {name}: max|diff| {err} > {KERNEL_TOL} * {scale}")
        check(kernel in fn.SUMS or torch.equal(o, r),
              f"{what} {name}: not bit-equal to the plain version "
              f"(max|diff| {err})")
        errs[name] = [err, scale]
    return errs, out


def norm_run(norm, x, w, b, a, g) -> list:
    """[y, dx, dw, db, dalpha] as f32 of norm(x, w, b, a) under the loss
    sum(y * g): the cotangent is g in y's dtype whatever y's rounding."""
    xk = x.clone().requires_grad_()
    params = [p.clone().requires_grad_() for p in (w, b, a)]
    y = norm(xk, *params)
    grads = torch.autograd.grad((y.float() * g).sum(), [xk, *params])
    check(y.dtype == x.dtype and grads[0].dtype == x.dtype,
          f"fused norm: y {y.dtype}, dx {grads[0].dtype} for x {x.dtype}")
    return [y.detach().float()] + [g.float() for g in grads]


def exact_norm_dx(x, w, b, a, dy) -> torch.Tensor:
    """dx of GraphNorm (ops/norm.py's formula) in f64 on x, the parameters
    and the cotangent dy as given (each exact in f64)."""
    xd = x.double().requires_grad_()
    d = xd - xd.mean(0) * a.double()
    y = w.double() * d / torch.sqrt((d * d).mean(0) + NORM_EPS) + b.double()
    return torch.autograd.grad((y * dy.double()).sum(), [xd])[0]


def dx_error_bound(x, w, b, a, dy) -> torch.Tensor:
    """Per element, how far ``_bwd``'s dx = a*dy + c2*x + c1 (K4 + K5,
    computed in f32, rounded once to x's dtype) may lie from the exact
    gradient: NORM_DX_ROUNDINGS f32 roundings of the formula's own terms
    (|a*dy| + |c2*x| + |c1|; a, c2, c1 from the plain K1, K2, K4) times 1 +
    kappa, plus one rounding to x's dtype of the terms where that is bf16.
    kappa = sum |d|(|x| + |am|) / (sum d^2 + N eps_norm) per feature (d = x
    - am): var is computed from d, whose rounding is relative to |x| +
    |am|, so where alpha*mu cancels x (N = 1, alpha near 1) every term
    carries var's relative error times kappa."""
    xf = x.float()
    _, mu, am = fn.colsum_reference(xf, a)
    _, var, _, _ = fn.varsum_reference(xf, am, mu, a, w, b, NORM_EPS)
    sa, c2, c1 = fn.bwd_reduce_reference(dy, x, am, mu, var, w, a,
                                         NORM_EPS)[2:5]
    terms = ((sa * dy.float()).abs() + (c2 * xf).abs() + c1.abs()).double()
    xd, amd = xf.double(), am.double()
    d = xd - amd
    kappa = (d.abs() * (xd.abs() + amd.abs())).sum(0) / (
        (d * d).sum(0) + x.shape[0] * NORM_EPS)
    f32_eps = torch.finfo(torch.float32).eps
    last = 0.0 if x.dtype == torch.float32 else torch.finfo(x.dtype).eps
    return terms * (NORM_DX_ROUNDINGS * f32_eps * (1 + kappa) + last)


def check_norm_dx_exact(what: str, x, w, b, a, g) -> dict:
    """The fused Function's dx (K4 + K5) and its plain Function's against
    the exact f64 gradient, per element within dx_error_bound. Returns
    each one's worst |dx - exact| / bound."""
    dy = g.to(x.dtype)  # the cotangent norm_run hands back, in y's dtype
    exact = exact_norm_dx(x, w, b, a, dy)
    bound = dx_error_bound(x, w, b, a, dy)
    out = {}
    for name, norm in (("fused", fn.fused_graph_norm),
                       ("plain", fn.fused_graph_norm_reference)):
        dx = norm_run(norm, x, w, b, a, g)[1].double()
        ratio = float(((dx - exact).abs() / bound).max())
        check(ratio <= 1.0, f"{what} {name} dx vs the exact gradient: "
              f"{ratio} x dx_error_bound")
        out[f"dx_{name}_vs_exact"] = ratio
    return out


def check_norm_function(what: str, x, gen) -> dict:
    """The autograd Function on the kernels against the plain Function and
    the unfused graph_norm's autograd, under a random cotangent: y and dx
    within KERNEL_TOL (f32; against graph_norm NORM_GRAD_TOL, another
    formula's rounding) or, for bf16, one bf16 ulp of the larger value plus
    NORM_GRAD_TOL * max (f32 values that differ in their last bits round to
    neighbouring bf16 values); dw, db and dalpha within NORM_GRAD_TOL *
    max; the zero-variance column within ZERO_VAR_TOL * max. At N = 1
    every column holds only the variance that the mean scale leaves,
    x - alpha*x, and the two formulas cancel apart: there dx, the fused
    Function's and the plain one's, is held against the exact f64
    gradient instead (check_norm_dx_exact), and the other outputs against
    graph_norm within ZERO_VAR_TOL * max in every column (measured on the
    CPU at most 7.8e-4), each plus one bf16 ulp for bf16 x. Returns the
    worst relative differences."""
    f = x.shape[1]
    w, b = (torch.randn(f, generator=gen).to(x.device) for _ in range(2))
    a = (torch.randn(f, generator=gen) * 0.3 + 1).to(x.device)
    if f > ZERO_VAR_COL:
        a[ZERO_VAR_COL] = 1.0
    g = torch.randn(x.shape, generator=gen).to(x.device)
    got = norm_run(fn.fused_graph_norm, x, w, b, a, g)
    keep = torch.arange(f, device=x.device) != ZERO_VAR_COL
    worst = {}
    for ref_name, ref_fn in (("plain", fn.fused_graph_norm_reference),
                             ("unfused", graph_norm)):
        ref = norm_run(ref_fn, x, w, b, a, g)
        for i, (name, o, r) in enumerate(zip(("y", "dx", "dw", "db", "dalpha"),
                                             got, ref)):
            check(bool(torch.isfinite(o).all()), f"{what}: non-finite {name}")
            n1_unfused = ref_name == "unfused" and x.shape[0] == 1
            if n1_unfused and name == "dx":
                continue  # held against the exact gradient below
            diff = (o - r).abs()
            big = float(r[..., keep].abs().max()) if keep.any() else 0.0
            if n1_unfused:
                ulp = BF16_ULP * r.abs() if x.dtype == torch.bfloat16 else 0
                ok = diff <= ZERO_VAR_TOL * float(r.abs().max()) + ulp
            elif i < 2 and x.dtype == torch.bfloat16:
                ok = diff[..., keep] <= BF16_ULP * torch.maximum(
                    r[..., keep].abs(), o[..., keep].abs()) \
                    + NORM_GRAD_TOL * big
            else:
                tol = KERNEL_TOL if i < 2 and ref_name == "plain" \
                    else NORM_GRAD_TOL
                ok = diff[..., keep] <= tol * big + 1e-30
            check(bool(ok.all()), f"{what} {name} vs {ref_name}: max|diff| "
                  f"{float(diff[..., keep].max())} (max|ref| {big})")
            if f > ZERO_VAR_COL:
                zv = float(diff[..., ZERO_VAR_COL].max())
                check(zv <= ZERO_VAR_TOL * float(r.abs().max()),
                      f"{what} {name} vs {ref_name}: zero-variance column "
                      f"max|diff| {zv}")
                worst[f"{name}_vs_{ref_name}_zero_var_col"] = zv / max(
                    float(r.abs().max()), 1e-30)
            worst[f"{name}_vs_{ref_name}"] = float(diff[..., keep].max()) / \
                max(big, 1e-30)
    if x.shape[0] == 1:
        worst.update(check_norm_dx_exact(what, x, w, b, a, g))
    return worst


def phase_norm_dx_draws(device) -> None:
    """[norm_dx_draws]: at N = 1, NORM_DX_DRAWS draws of x, the parameters
    and the cotangent for each F of NORM_SMALL_F and each x dtype (bf16 1 x
    17 among them), norm_case's distributions: the fused Function's dx and
    the plain one's against the exact f64 gradient (check_norm_dx_exact)."""
    gen = torch.Generator().manual_seed(37)
    worst = {}
    for dtype in X_DTYPES:
        for f in NORM_SMALL_F:
            for _ in range(NORM_DX_DRAWS):
                x = (torch.randn(1, f, generator=gen) * 3 + 1.5).to(device,
                                                                     dtype)
                w, b = (torch.randn(f, generator=gen).to(device)
                        for _ in range(2))
                a = (torch.randn(f, generator=gen) * 0.3 + 1).to(device)
                g = torch.randn(1, f, generator=gen).to(device)
                got = check_norm_dx_exact(f"norm dx {dtype} 1x{f}", x, w, b,
                                          a, g)
                key = f"{str(dtype).removeprefix('torch.')}_1x{f}"
                worst[key] = max(worst.get(key, 0.0), *got.values())
    emit("norm_dx_draws", draws_per_shape=NORM_DX_DRAWS,
         f32_roundings_allowed=NORM_DX_ROUNDINGS,
         worst_dx_error_over_bound=worst)


def reduction_p(x, kernel: str) -> int:
    """P, the CTAs of a reduction's launch at x's shape, as the wrapper
    takes it (x and dy 16-byte aligned, as fresh allocations are)."""
    n, f = x.shape
    vmax = 16 // x.element_size()
    return fn.reduce_grid(
        n, f, vmax if f % vmax == 0 else 1, fn.SUMS[kernel],
        torch.cuda.get_device_properties(x.device).multi_processor_count).p


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts one element into its buffer: 4
    (f32) or 2 (bf16) bytes past a 16-byte boundary."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return view.view(t.shape).copy_(t)


def phase_kernel_norm_small(device) -> None:
    """K1-K5 against their plain versions (every sum and derived vector of
    the reductions; K3 and K5 bit-equal), and the autograd Function against
    the plain Function and graph_norm, at N in NORM_SMALL_N, F in
    NORM_SMALL_F, f32 and bf16 x with a zero-variance column, and at
    component's COMPONENT_N x 17 in f32. The second N = 3001 reuses the
    first's inputs after the calls at N = 1000: every output bit-equal to
    the first call's. Then x and dy as views one element into their
    buffers (the one-value path): every pass against its plain version, K3
    and K5 also bit-equal to their results on the aligned operands; and
    every pass at NORM_LONG_PERIOD_SHAPES."""
    gen = torch.Generator().manual_seed(31)
    for dtype in X_DTYPES:
        cases, first = {}, {}
        for n in NORM_SMALL_N:
            for f in NORM_SMALL_F:
                repeat = (n, f) in cases
                if not repeat:
                    cases[n, f] = norm_case(gen, n, f, dtype, device)
                x, dy, v = cases[n, f]
                errs = {}
                for k in fn.KERNELS:
                    what = f"{k} {dtype} {n}x{f}"
                    errs[k], out = check_pass(what, k, pass_args(k, x, dy, v))
                    if repeat:
                        check(all(torch.equal(o, p)
                                  for o, p in zip(out, first[n, f, k])),
                              f"{what}: differs from the first call at this "
                              "N after calls at another N")
                    first[n, f, k] = out
                worst = None if repeat else check_norm_function(
                    f"fused norm {dtype} {n}x{f}", x, gen)
                emit("kernel_norm_small", x=str(dtype), N=n, F=f,
                     p=reduction_p(x, "varsum"),
                     repeat_bit_equal_to_first=repeat,
                     max_abs_err_and_ref=errs, function_rel_diff=worst)
        n, f = NORM_UNALIGNED_SHAPE
        x, dy, v = norm_case(gen, n, f, dtype, device)
        xu, dyu = unaligned(x), unaligned(dy)
        errs = {}
        for k in fn.KERNELS:
            what = f"{k} {dtype} {n}x{f} unaligned"
            errs[k], out = check_pass(what, k, pass_args(k, xu, dyu, v))
            if k not in fn.SUMS:
                aligned = getattr(fn, k)(*pass_args(k, x, dy, v))
                check(torch.equal(out[0], aligned),
                      f"{what}: differs from the aligned operands' result")
        emit("kernel_norm_small", x=str(dtype), N=n, F=f, unaligned=True,
             x_offset_bytes=xu.data_ptr() % 16, max_abs_err_and_ref=errs)
    x, dy, v = norm_case(gen, COMPONENT_N, NARROW_H, torch.float32, device)
    errs = {k: check_pass(f"{k} component", k, pass_args(k, x, dy, v))[0]
            for k in fn.KERNELS}
    worst = check_norm_function("fused norm component", x, gen)
    emit("kernel_norm_small", x=str(torch.float32), N=COMPONENT_N,
         F=NARROW_H, p=reduction_p(x, "varsum"), max_abs_err_and_ref=errs,
         function_rel_diff=worst)
    for dtype in X_DTYPES:
        for n, f in NORM_LONG_PERIOD_SHAPES:
            x, dy, v = norm_case(gen, n, f, dtype, device)
            errs = {k: check_pass(f"{k} {dtype} {n}x{f}", k,
                                  pass_args(k, x, dy, v))[0]
                    for k in fn.KERNELS}
            emit("kernel_norm_small", x=str(dtype), N=n, F=f,
                 p=reduction_p(x, "varsum"), max_abs_err_and_ref=errs)


# (F,) f32 vectors each pass reads and writes beside its (N, F) operands
NORM_VECTORS = {"colsum": (1, 3), "varsum": (5, 4), "affine": (2, 0),
                "bwd_reduce": (5, 8), "bwd_dx": (3, 0)}


def norm_bound_ms(kernel: str, x) -> tuple:
    """(least ms, "bytes" | "operations") of one pass at x's shape: each
    (N, F) input read once and each output written once at x's itemsize,
    the (F,) f32 vectors read and written once (NORM_VECTORS); the f32
    operations per element (K1 1, K2 3, K3 2, K4 4, K5 5) at the f32 rate
    (the finishes' per-feature algebra, under 30 operations a feature,
    left out)."""
    n, f = x.shape
    big = n * f * x.element_size()
    vec = f * 4 * sum(NORM_VECTORS[kernel])
    nbytes, ops = {
        "colsum": (big + vec, 1), "varsum": (big + vec, 3),
        "affine": (2 * big + vec, 2), "bwd_reduce": (2 * big + vec, 4),
        "bwd_dx": (3 * big + vec, 5)}[kernel]
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    t_ops = ops * n * f / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def norm_library(kernel: str, dtype):
    """(one PyTorch call computing the pass's sums or result, or None, and
    why)."""
    if kernel == "colsum":
        return ((lambda x, _: x.sum(0)) if dtype == torch.float32 else
                (lambda x, _: x.sum(0, dtype=torch.float32))), "torch.sum"
    if kernel == "affine" and dtype == torch.float32:
        return (lambda x, g, h: torch.addcmul(h, x, g)), "torch.addcmul"
    if kernel == "affine":
        return None, "no single call: addcmul promotes bf16 x to f32"
    return None, "no single call"


L2_FLUSH_BYTES = 128 << 20  # past the H100's 50 MB L2
HEAD_START_CYCLES = 4_000_000  # about 2 ms of the card's clock


def host_us(fn) -> float:
    """Microseconds of host time per eager ``fn()`` over HOST_CALLS calls
    without a synchronization, the median of HOST_GROUPS runs (the card
    synchronized between them): the wrapper's work where the card keeps
    up (tools/torch_kernel_ab.py's ``_host_us``)."""
    spans = []
    for _ in range(HOST_GROUPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        spans.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
    return statistics.median(spans)


def cold_ms(fn, reps: int = 20, clean: bool = False) -> float:
    """Device ms of one ``fn()`` with the L2 cache cold, the median over
    ``reps`` calls. Before each call a 128 MB fill evicts the L2 (as a
    training step's pass finds it after the other passes; it leaves the L2
    full of dirty lines, which the call's own lines then evict, or, with
    ``clean``, clean ones: one read pass over another 128 MB after it) and a
    spin kernel of about 2 ms (torch.cuda._sleep) holds the stream while the
    host enqueues the call between two CUDA events, so that the events time
    the call's kernels back to back: without the host's work, which time_ms
    includes where the card outruns it, and without operands left in L2 by
    the call before."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    other = torch.ones(L2_FLUSH_BYTES // 4, device="cuda") if clean else None
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        if clean:
            other.sum()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in spans)


def profile_norm(norm, x, w, b, a, g, reps: int = 3) -> dict:
    """Device kernels and their time per forward + backward of one norm,
    from torch.profiler over ``reps`` runs (possibly low: the card's
    profiler has dropped kernel events, PERF.md section 7)."""
    norm_run(norm, x, w, b, a, g)  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            norm_run(norm, x, w, b, a, g)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    return {"device_kernels": sum(e.count for e in kernels) / reps,
            "device_us": sum(e.self_device_time_total for e in kernels) / reps}


def fwd_bwd(norm, x, w, b, a, g):
    """One eager forward + backward of ``norm`` (x and the three parameters
    differentiable, cotangent g in x's dtype), as a closure to time."""
    xk = x.clone().requires_grad_()
    params = [p.clone().requires_grad_() for p in (w, b, a)]
    gy = g.to(x.dtype)

    def run():
        return torch.autograd.grad(norm(xk, *params), [xk, *params], gy)
    return run


def phase_kernel_norm_main(device) -> dict:
    """K1-K5 at the em_user shape (57,344 x 64), f32 and bf16 x: each
    against its plain version and timed beside its bound, the plain
    version and the library call, each by time_ms ("ms": eager calls) and
    cold_ms ("device_ms": the call's kernels alone, the L2 flushed), as the
    SpMM records are, and its host work per call ("host_us"); K3 and K5
    also at component's COMPONENT_N x 17 in f32; then one norm's forward +
    backward, fused and unfused: its device kernels from the profiler and
    its eager time from CUDA events. Returns kernel -> record (f32 numbers
    under the line's keys, bf16 under keys ending in _bf16, component's in
    keys ending in _component)."""
    gen = torch.Generator().manual_seed(32)
    n, f = N_COMM * COMM_SIZE, EM_USER["hidden_dim"]
    records = {k: dict(name=f"graph_norm_{k}", route="cuda",
                       source="glass_tpu_torch/csrc/graph_norm.cu",
                       replaces=NORM_TPU[k].split()[0], tpu=[NORM_TPU[k]])
               for k in fn.KERNELS}
    per_norm = {}
    for dtype in X_DTYPES:
        sfx = "" if dtype == torch.float32 else "_bf16"
        x, dy, v = norm_case(gen, n, f, dtype, device)
        for k in fn.KERNELS:
            args = pass_args(k, x, dy, v)
            errs, _ = check_pass(f"em_user {k} {dtype}", k, args)
            lib, lib_name = norm_library(k, dtype)
            lib_diff = None
            if lib is not None:
                ref = getattr(fn, f"{k}_reference")(*args)
                ref = ref[0] if isinstance(ref, tuple) else ref
                lib_diff = float((lib(*args).float() - ref.float()).abs().max())
            rec = records[k]
            run = getattr(fn, k)
            plain = getattr(fn, f"{k}_reference")
            times = timed(lambda: run(*args), lambda: plain(*args),
                          None if lib is None else (lambda: lib(*args)))
            rec.update({key + sfx: t for key, t in times.items()})
            rec[f"host_us{sfx}"] = host_us(lambda: run(*args))
            rec[f"max_abs_err{sfx}"] = max(e for e, _ in errs.values())
            rec[f"library{sfx}"] = lib_name
            rec[f"bound_ms{sfx}"], rec[f"bound_by{sfx}"] = norm_bound_ms(k, x)
            emit("kernel_norm_main", kernel=k, x=str(dtype), N=n, F=f,
                 p=reduction_p(x, k) if k in fn.SUMS else None,
                 max_abs_err_and_ref=errs, library_max_abs_diff=lib_diff,
                 host_us=rec[f"host_us{sfx}"],
                 **{key: rec[key + sfx] for key in TIME_KEYS})
        w, b = (torch.randn(f, generator=gen).to(device) for _ in range(2))
        a = (torch.randn(f, generator=gen) * 0.3 + 1).to(device)
        g = torch.randn(n, f, generator=gen).to(device)
        per_norm[str(dtype)] = {
            name: dict(profile_norm(norm, x, w, b, a, g),
                       eager_fwd_bwd_ms=time_ms(fwd_bwd(norm, x, w, b, a, g)))
            for name, norm in (("fused", fn.fused_graph_norm),
                               ("unfused", graph_norm))}
        del x, dy
    x, dy, v = norm_case(gen, COMPONENT_N, NARROW_H, torch.float32, device)
    for k in ("affine", "bwd_dx"):
        args = pass_args(k, x, dy, v)
        errs, _ = check_pass(f"component {k}", k, args)
        lib, _ = norm_library(k, torch.float32)
        run, plain = getattr(fn, k), getattr(fn, f"{k}_reference")
        rec = records[k]
        times = timed(lambda: run(*args), lambda: plain(*args),
                      None if lib is None else (lambda: lib(*args)))
        rec.update({key + "_component": t for key, t in times.items()})
        rec["host_us_component"] = host_us(lambda: run(*args))
        rec["bound_ms_component"], rec["bound_by_component"] = \
            norm_bound_ms(k, x)
        emit("kernel_norm_main", kernel=k, x=str(torch.float32),
             N=COMPONENT_N, F=NARROW_H, max_abs_err_and_ref=errs,
             host_us=rec["host_us_component"],
             **{key: rec[key + "_component"] for key in TIME_KEYS})
    emit("norm_fwd_bwd_profile", N=n, F=f, per_norm=per_norm,
         device_kernels_note="torch.profiler's count; low where the "
         "profiler drops kernel events")
    return records


# ------------------------------------------------ the experiment CLI path

CLI_SUBGRAPHS = {"train": 240, "val": 60, "test": 60}
CLI_EPOCHS, CLI_AB_EPOCHS, CLI_Q_EPOCHS, CLI_AUTO_EPOCHS = 15, 15, 12, 12
# fused vs unfused epoch losses, same dropout stream: float order only
# (tests/test_torch_protocol.py's protocol-loss tolerance)
CLI_LOSS_RTOL = 1e-4
CLI_AB_COMPARED_EPOCHS = 3
ITER_LINE = re.compile(r"iter (\d+) loss (\S+) val (\S+) tst (\S+)$")


def write_edge_list(path: Path, ei: np.ndarray) -> None:
    """``ei`` as SubGNN ``edge_list.txt`` lines ("row col", right-aligned
    in fixed-width columns), written from one byte array."""
    width = len(str(int(ei.max())))

    def digits(v):
        out = np.full((v.size, width), ord(" "), np.uint8)
        rest = v.astype(np.int64)
        for j in range(width - 1, -1, -1):
            out[:, j] = np.where((rest > 0) | (j == width - 1),
                                 ord("0") + rest % 10, ord(" "))
            rest = rest // 10
        return out

    e = ei.shape[1]
    lines = np.concatenate([digits(ei[0]), np.full((e, 1), ord(" "), np.uint8),
                            digits(ei[1]), np.full((e, 1), ord("\n"), np.uint8)],
                           axis=1)
    path.write_bytes(lines.tobytes())


def write_em_user_standin(root: Path) -> dict:
    """A SubGNN-format em_user at em_user's scale under ``root``: the
    clustered_graph edges (both directions, 9M lines) and size-labelled
    subgraphs split 240/60/60."""
    t0 = time.perf_counter()
    ei, n = clustered_graph()
    count = sum(CLI_SUBGRAPHS.values())
    pos, y = size_labelled_subgraphs(np.random.default_rng(41), count,
                                     N_COMM, COMM_SIZE)
    tags = [t for t, k in CLI_SUBGRAPHS.items() for _ in range(k)]
    d = root / "dataset" / "em_user"
    d.mkdir(parents=True)
    (d / "subgraphs.pth").write_text("".join(
        f"{'-'.join(map(str, row[row >= 0]))}\t{int(label)}\t{tag}\n"
        for row, label, tag in zip(pos, y, tags)))
    write_edge_list(d / "edge_list.txt", ei)
    return dict(n_node=n, directed_edges=ei.shape[1], subgraphs=count,
                edge_list_bytes=(d / "edge_list.txt").stat().st_size,
                write_s=time.perf_counter() - t0)


def counts_delta(before: dict, after: dict) -> dict:
    """after - before of launch_counts()-style dicts, zeros dropped."""
    out = {}
    for key, a in after.items():
        b = before[key]
        if isinstance(a, dict):
            out[key] = {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}
        else:
            out[key] = a - b
    return out


class EpochProbe:
    """Wraps the Trainer's epoch (``train_epoch`` and each epoch of
    ``train_epochs``), its step capture and its evaluations while a run
    lasts: per epoch its steps, mean loss, host ms and the CUDA-event span
    of its stream work; each capture's launches as the wrappers counted
    them while the step was captured (one step's: the launches per step
    at capture); the eval batches run forward (an eval program's first,
    eager, call or a replay runs its nb batches); each evaluation's host
    ms (``evals``: epoch index, ms, ending in its readback, and whether
    it ran eagerly and captured its program); the eval
    programs captured (``programs``, a ProgramProbe); and the trainer the
    run built."""

    def __init__(self):
        self.epochs, self.trainer = [], None
        self.eval_forwards = 0
        self.evals = []
        self.programs = ProgramProbe()
        self.steps = StepProbe()
        self.t0 = time.perf_counter()

    @property
    def captures(self) -> list:
        """Each step capture's counts (one step's launches)."""
        return [g.counts for g in self.steps.programs]

    def __enter__(self):
        self._real = (Trainer._epoch, Trainer._eval_program,
                      Trainer.evaluate, Trainer.evaluate_score)
        real_epoch, real_eval, real_logits, real_score = self._real
        self.programs.__enter__()
        self.steps.__enter__()

        def eval_program(trainer, fn, *inputs):
            self.eval_forwards += len(inputs[0])
            return real_eval(trainer, fn, *inputs)

        def timed_eval(real):
            def run(trainer, *args):
                n_prog = len(self.programs.programs)
                t0 = time.perf_counter()
                out = real(trainer, *args)
                self.evals.append(dict(
                    epoch=len(self.epochs) - 1,
                    ms=(time.perf_counter() - t0) * 1e3,
                    captured=len(self.programs.programs) > n_prog))
                return out
            return run

        def epoch(trainer, pos_b, y_b):
            self.trainer = trainer
            n_cap = len(self.captures)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            res = real_epoch(trainer, pos_b, y_b)
            end.record()
            torch.cuda.synchronize()
            self.epochs.append(dict(
                started_s=t0 - self.t0, steps=len(res.step_losses),
                loss=res.loss, host_ms=(time.perf_counter() - t0) * 1e3,
                event_ms=start.elapsed_time(end),
                captured=len(self.captures) > n_cap))
            return res

        Trainer._epoch = epoch
        Trainer._eval_program = eval_program
        Trainer.evaluate = timed_eval(real_logits)
        Trainer.evaluate_score = timed_eval(real_score)
        return self

    def __exit__(self, *exc):
        (Trainer._epoch, Trainer._eval_program, Trainer.evaluate,
         Trainer.evaluate_score) = self._real
        self.steps.__exit__(*exc)
        self.programs.__exit__(*exc)


def run_cli(argv: list) -> tuple:
    """glass_tpu_torch.cli.glass_test.main(argv) in this process: (log
    lines, EpochProbe, mean, err, seconds, the run's Launches). The run
    trains on captured steps, so its launches are the card's
    (card_launches)."""
    from glass_tpu_torch.cli import glass_test

    out = io.StringIO()
    t0 = time.perf_counter()
    with card_launches() as ran, EpochProbe() as probe, \
            contextlib.redirect_stdout(out):
        mean, err = glass_test.main(argv)
    seconds = time.perf_counter() - t0
    return (out.getvalue().splitlines(), probe, mean, err, seconds, ran)


def check_cli_log(lines: list, repeats: int, what: str) -> list:
    """Each repeat logged iter/val/tst lines; the average is finite.
    Returns the throughput lines."""
    sections, current = [], None
    for line in lines:
        if line.startswith("repeat "):
            current = []
            sections.append(current)
        elif current is not None:
            current.append(line)
    check(len(sections) == repeats, f"{what}: {len(sections)} repeats logged")
    for i, sec in enumerate(sections):
        check(any(ITER_LINE.match(l) for l in sec),
              f"{what}: repeat {i} logged no iter/val/tst line")
    avg = [l for l in lines if l.startswith("average ")]
    check(len(avg) == 1 and all(math.isfinite(float(t)) for t in
                                avg[0].split()[1::2]),
          f"{what}: average line {avg}")
    return [l for l in lines if l.startswith("throughput:")]


def model_counts(model) -> tuple:
    """(GraphNorm modules, conv layers) of a GLASS model."""
    from glass_tpu_torch.nn.modules import GLASSConv, GraphNorm

    mods = list(model.modules())
    return (sum(isinstance(m, GraphNorm) for m in mods),
            sum(isinstance(m, GLASSConv) for m in mods))


def check_run_launches(probe: EpochProbe, ran: Launches, per_step: dict,
                       per_forward: dict, what: str) -> int:
    """A run on captured steps and captured eval programs: every step
    capture counted ``per_step`` (one step's launches, at capture), every
    eval program's capture ``per_forward`` for each of its nb batches, and
    the card ran ``per_step`` for each training step and ``per_forward``
    for each eval forward, and nothing else (the card's counters over the
    whole run: each replay's kernels count themselves); with the fused
    norm, the reductions' tickets are 0 after the run. Returns the
    training steps."""
    steps = sum(e["steps"] for e in probe.epochs)
    check(len(probe.captures) >= 1 and probe.epochs[0]["captured"],
          f"{what}: the first epoch captured no step")
    for i, c in enumerate(probe.captures):
        check(c == per_step, f"{what}: capture {i} counted {c}, a step is "
              f"{per_step}")
    check(probe.programs.programs, f"{what}: no eval program was captured")
    for i, p in enumerate(probe.programs.programs):
        nb = len(p.inputs[0])
        check(p.counts == scaled_sum((nb, per_forward)),
              f"{what}: eval program {i} ({nb} batches) counted {p.counts}, "
              f"a forward is {per_forward}")
    want = scaled_sum((steps, per_step), (probe.eval_forwards, per_forward))
    check(ran.card == want, f"{what}: the card ran {ran.card} "
          f"in {steps} steps and {probe.eval_forwards} eval forwards, "
          f"expected {want}")
    check_tickets(probe.trainer, per_step, what)
    return steps


def band_norm_launches(model, band_dtype: str, norm_dtype) -> tuple:
    """(per step, per eval forward) launches of a GLASS on a symmetric
    band: 2 band kernels per conv layer and step (forward and backward),
    1 per forward; with the fused norm (``norm_dtype`` not None) K1-K3
    once per GraphNorm and forward, K4-K5 once per GraphNorm and step."""
    norms, convs = model_counts(model)
    fwd = {} if norm_dtype is None else {k: norms for k in
                                         ("colsum", "varsum", "affine")}
    bwd = {} if norm_dtype is None else {k: norms for k in
                                         ("bwd_reduce", "bwd_dx")}
    return (counts_form(band={band_dtype: 2 * convs}, norm={**fwd, **bwd},
                        norm_dtype=norm_dtype),
            counts_form(band={band_dtype: convs}, norm=fwd,
                        norm_dtype=norm_dtype))


def epoch_stats(probe: EpochProbe) -> dict:
    """Median host and CUDA-event ms per step over the epochs after the
    first (which carries the first launches' costs); the seconds before
    the first epoch (loading, layout build, model) and in the epochs; the
    host ms of the evaluations of an epoch after the gate (median over the
    epochs that evaluate, leaving out those with an evaluation that ran
    eagerly and captured its program) and of one replayed evaluation
    (median)."""
    eps = probe.epochs[1:] or probe.epochs
    per_epoch, capturing = {}, {e["epoch"] for e in probe.evals
                                if e["captured"]}
    replayed = [e["ms"] for e in probe.evals if not e["captured"]]
    for e in probe.evals:
        if e["epoch"] not in capturing:
            per_epoch[e["epoch"]] = per_epoch.get(e["epoch"], 0) + e["ms"]
    return {"host_ms_per_step": statistics.median(
                e["host_ms"] / e["steps"] for e in eps),
            "event_ms_per_step": statistics.median(
                e["event_ms"] / e["steps"] for e in eps),
            "epochs": len(probe.epochs),
            "setup_s": probe.epochs[0]["started_s"],
            "epochs_s": sum(e["host_ms"] for e in probe.epochs) / 1e3,
            "evals": len(probe.evals),
            "eval_ms_per_epoch": (statistics.median(per_epoch.values())
                                  if per_epoch else None),
            "eval_ms": statistics.median(replayed) if replayed else None}


@contextlib.contextmanager
def em_user_standin_dir():
    """A temporary directory holding the SubGNN-format em_user stand-in
    under data/ (write_em_user_standin), with GLASS_CACHE_DIR pointed at
    its cache/ inside the block (the parsed graph is cached there)."""
    with tempfile.TemporaryDirectory(prefix="glass_cli_") as tmp:
        tmp = Path(tmp)
        emit("cli_data", **write_em_user_standin(tmp / "data"))
        old_cache = os.environ.get("GLASS_CACHE_DIR")
        os.environ["GLASS_CACHE_DIR"] = str(tmp / "cache")
        try:
            yield tmp
        finally:
            if old_cache is None:
                os.environ.pop("GLASS_CACHE_DIR", None)
            else:
                os.environ["GLASS_CACHE_DIR"] = old_cache


def phase_cli_em_user(device, norm_records: dict, tmp: Path) -> None:
    """The experiment CLI end to end at em_user on the SubGNN stand-in in
    ``tmp`` (em_user_standin_dir): two repeats with the fused norm, its
    launches per step, its best-val checkpoint served; the same command
    with the norm unfused, its losses and times beside the fused run's;
    and one repeat in int8 + bf16."""
    from glass_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  params_to_flax)

    base_argv = ["--dataset", "em_user", "--use_deg", "--use_maxzeroone",
                 "--spmm", "pallas", "--sparse_layout", "band",
                 "--data_root", str(tmp / "data")]
    with fused_norm(True):
        lines, probe, mean, err, secs, ran = run_cli(
            base_argv + ["--repeat", "2", "--max_epochs",
                         str(CLI_EPOCHS), "--ckpt_dir",
                         str(tmp / "ckpt")])
    throughput = check_cli_log(lines, 2, "cli_em_user")
    norms, convs = model_counts(probe.trainer.model)
    per_step, per_fwd = band_norm_launches(probe.trainer.model,
                                           "float32", "float32")
    steps = check_run_launches(probe, ran, per_step, per_fwd,
                               "cli_em_user")
    for k in fn.KERNELS:  # rows 11-15: what the card ran
        norm_records[k]["launches"] = ran.card["norm"][k]
        norm_records[k]["launches_per_step"] = per_step["norm"][k]
    fused = epoch_stats(probe)
    on_losses = [e["loss"] for e in probe.epochs[:CLI_EPOCHS]]
    emit("cli_em_user", repeats=2, epochs_per_repeat=CLI_EPOCHS,
         training_steps=steps, graph_norms=norms, conv_layers=convs,
         launches_per_step=per_step, run_launches=ran.card,
         wrapper_counts=ran.counted,
         eval_forwards=probe.eval_forwards,
         mean=mean, err=err, seconds=secs,
         epoch_losses=[e["loss"] for e in probe.epochs],
         iter_lines=[l for l in lines if ITER_LINE.match(l)],
         end_lines=[l for l in lines if l.startswith("end:")],
         throughput=throughput, **fused)

    ckpt = tmp / "ckpt" / "em_user_seed0_best.npz"
    check(ckpt.exists(), f"no best-val checkpoint at {ckpt}")
    trainer = probe.trainer
    served = em_user_model(int(trainer.x.max()), "pallas", device)
    pred = Predictor.from_checkpoint(served, trainer.graph, trainer.x,
                                     ckpt, device=device)
    saved = load_checkpoint(ckpt)
    check(all(np.array_equal(v, saved[k])
              for k, v in params_to_flax(served).items()),
          "the served model's parameters differ from the checkpoint")
    subs = make_request(np.random.default_rng(42),
                        EM_USER["batch_size"], N_COMM, COMM_SIZE)
    with fused_norm(True):
        logits = pred(subs)
    check(logits.shape == (len(subs), 1)
          and np.isfinite(logits).all(),
          f"checkpoint request logits {logits.shape}")
    emit("cli_checkpoint", path=ckpt.name, arrays=len(saved),
         request_batch=len(subs),
         max_abs_logit=float(np.abs(logits).max()))
    del pred, served, trainer, probe

    with fused_norm(False):
        lines_off, probe_off, mean_off, _, secs_off, ran_off = \
            run_cli(base_argv + ["--repeat", "1", "--max_epochs",
                                 str(CLI_AB_EPOCHS)])
    check_cli_log(lines_off, 1, "cli_em_user unfused")
    check_run_launches(probe_off, ran_off, *band_norm_launches(
        probe_off.trainer.model, "float32", None),
        "cli_em_user unfused")
    off_losses = [e["loss"] for e in probe_off.epochs]
    k = CLI_AB_COMPARED_EPOCHS
    check(np.allclose(off_losses[:k], on_losses[:k],
                      rtol=CLI_LOSS_RTOL, atol=0),
          f"fused vs unfused epoch losses {on_losses[:k]} vs "
          f"{off_losses[:k]}")
    unfused = epoch_stats(probe_off)
    emit("cli_em_user_unfused", repeats=1,
         epochs_per_repeat=CLI_AB_EPOCHS, mean=mean_off,
         seconds=secs_off,
         epoch_losses=off_losses,
         max_rel_loss_diff_first_epochs=float(np.max(
             np.abs(np.subtract(off_losses[:k], on_losses[:k]))
             / np.abs(on_losses[:k]))),
         throughput=[l for l in lines_off
                     if l.startswith("throughput:")], **unfused)
    emit("cli_fused_norm_ab", fused=fused, unfused=unfused,
         host_speedup=unfused["host_ms_per_step"]
         / fused["host_ms_per_step"],
         event_speedup=unfused["event_ms_per_step"]
         / fused["event_ms_per_step"])
    del probe_off

    with fused_norm(True):
        lines_q, probe_q, mean_q, _, secs_q, ran_q = run_cli(
            base_argv + ["--repeat", "1", "--max_epochs",
                         str(CLI_Q_EPOCHS), "--dense_dtype", "int8",
                         "--compute_dtype", "bf16"])
    check_cli_log(lines_q, 1, "cli_em_user_q")
    per_step_q, per_fwd_q = band_norm_launches(
        probe_q.trainer.model, "int8", "bfloat16")
    steps_q = check_run_launches(probe_q, ran_q, per_step_q,
                                 per_fwd_q, "cli_em_user_q")
    emit("cli_em_user_q", adjacency="int8", compute="bfloat16",
         training_steps=steps_q, launches_per_step=per_step_q,
         run_launches=ran_q.card, mean=mean_q, seconds=secs_q,
         epoch_losses=[e["loss"] for e in probe_q.epochs],
         iter_lines=[l for l in lines_q if ITER_LINE.match(l)],
         **epoch_stats(probe_q))
    del probe_q
    trainer = cli_em_user_auto(tmp / "data")
    predict_cli(tmp / "data", ckpt, trainer)


def cli_em_user_auto(data_root: Path):
    """The experiment CLI at em_user with no --spmm and no --sparse_layout
    flag: the protocol routes the graph to "pallas" with RCM, the planner
    picks the layout; every epoch's launches per step are those of the
    planned layout (the norm unfused, the default)."""
    with fused_norm(False):
        lines, probe, mean, _, secs, ran = run_cli(
            ["--dataset", "em_user", "--use_deg", "--use_maxzeroone",
             "--data_root", str(data_root), "--repeat", "1", "--max_epochs",
             str(CLI_AUTO_EPOCHS)])
    check_cli_log(lines, 1, "cli_em_user_auto")
    graph = probe.trainer.graph
    _, convs = model_counts(probe.trainer.model)
    check(graph.plan is not None and graph.plan == held_kind(graph),
          f"cli_em_user_auto: plan {graph.plan}, layout {held_kind(graph)}")
    modes = {m.spmm_mode for m in probe.trainer.model.modules()
             if hasattr(m, "spmm_mode")}
    check(modes == {"pallas"}, f"the protocol routed em_user to {modes}")
    x = torch.randn(graph.n_node, EM_USER["hidden_dim"],
                    generator=torch.Generator().manual_seed(43)).to(graph.device)
    errs = check_planned("cli_em_user_auto", graph, x)
    del x
    steps = check_run_launches(probe, ran, plan_launches(graph, 2 * convs),
                               plan_launches(graph, convs), "cli_em_user_auto")
    emit("cli_em_user_auto", repeats=1, training_steps=steps,
         **plan_summary(graph), max_abs_err=errs,
         launches_per_step=plan_launches(graph, 2 * convs),
         run_launches=ran.card, eval_forwards=probe.eval_forwards,
         mean=mean, seconds=secs,
         epoch_losses=[e["loss"] for e in probe.epochs],
         iter_lines=[l for l in lines if ITER_LINE.match(l)],
         average_line=[l for l in lines if l.startswith("average ")],
         **epoch_stats(probe))
    return probe.trainer


def phase_train_norm_small(device) -> None:
    """3 steps with the fused norm on, card vs CPU, band and BCSR, at
    train_small's tolerances; the card's norm passes counted."""
    norms, _ = model_counts(GLASS(5, 16, 2, (1,), ("size",), device="cpu"))
    with fused_norm(True):
        for layout in ("band", "bcsr"):
            with card_launches() as ran:
                losses, params = small_training(device, layout)
            got = ran.card["norm"]
            losses_cpu, params_cpu = small_training(torch.device("cpu"), layout)
            want = {k: norms * len(losses) for k in fn.KERNELS}
            check(got == want, f"{layout}: norm passes {got}, expected {want}")
            loss_err = float(np.abs(losses - losses_cpu).max())
            param_err = max(float((params[k] - params_cpu[k]).abs().max())
                            for k in params)
            check(np.isfinite(losses).all(), f"{layout}: non-finite losses")
            check(np.allclose(losses, losses_cpu, rtol=TRAIN_LOSS_RTOL, atol=0),
                  f"{layout}: card losses {losses} vs CPU {losses_cpu}")
            check(param_err <= TRAIN_PARAM_ATOL_LRS * EM_USER["lr"],
                  f"{layout}: parameters differ by {param_err} after 3 steps")
            emit("train_norm_small", layout=layout, steps=len(losses),
                 graph_norms=norms, norm_passes=got, losses=losses.tolist(),
                 max_abs_loss_diff=loss_err, max_abs_param_diff=param_err)


# ------------------------------------------------------- HBM read probes

PROBE_TPU = {"read": "tools/hbm_probe.py:89 _read_kernel",
             "read2": "tools/hbm_probe.py:164 _read2_kernel"}
PROBE_SMALL_CHUNKS = (64, 1800, 2048)
PROBE_SMALL_STEPS = 4


@functools.lru_cache(maxsize=None)
def load_tool(name: str):
    """tools/<name>.py as a module, loaded once."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_probe(what: str, run, plain) -> None:
    """run(iters) at iters 3, 3 again and 1 against plain(): bit-equal,
    the repeat bit-identical."""
    out, again, one, ref = run(3), run(3), run(1), plain()
    torch.cuda.synchronize()
    check(torch.equal(out, ref) and torch.equal(one, ref),
          f"{what}: differs from the plain slice")
    check(torch.equal(out, again), f"{what}: repeat differs")


def phase_probe_small(device) -> None:
    """Both probe bodies against their plain versions, bit-equal, repeats
    bit-identical, at S 1-8 (read2: 2 and 4), chunk_rows 64, 1800 and 2048
    and iters 1 and 3, on data that differs in every row. The tilings
    cover a CTA that holds all 8 output rows, output rows spread over
    several CTAs, and a last CTA with fewer rows than the others."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator().manual_seed(51)
    tilings = set()
    for chunk in PROBE_SMALL_CHUNKS:
        rows = PROBE_SMALL_STEPS * chunk
        x = torch.randn(rows, hp.LANES, generator=gen).to(device)
        for s in (1, 2, 4, 8):
            if chunk % s or chunk // s < hp.OUT_ROWS:
                continue
            ctas, q, smem = hp.tiling(chunk // s, s, sms)
            tilings.add((q >= hp.OUT_ROWS, (chunk // s) % q != 0))
            check_probe(f"read S={s} chunk {chunk}",
                        lambda it: hp.hbm_read(x, chunk, s, it),
                        lambda: hp.hbm_read_reference(x, chunk, s, 1))
            emit("probe_small", probe="read", stripes=s, chunk_rows=chunk,
                 rows=rows, ctas=ctas, q=q, smem_bytes=smem, bit_equal=True)
            if s in (2, 4):
                xs = [torch.randn(rows // s, hp.LANES, generator=gen)
                      .to(device) for _ in range(s)]
                check_probe(f"read2 S={s} chunk {chunk}",
                            lambda it: hp.hbm_read2(xs, chunk, it),
                            lambda: hp.hbm_read2_reference(xs, chunk, 1))
                emit("probe_small", probe="read2", stripes=s,
                     chunk_rows=chunk, rows=rows, ctas=ctas, q=q,
                     bit_equal=True)
    check(any(t[0] for t in tilings) and any(not t[0] for t in tilings)
          and any(t[1] for t in tilings),
          f"the small probes lack a tiling case: {sorted(tilings)}")


PROBE_MB, PROBE_ITERS, PROBE_CHUNK_ROWS = 512, 40, 2048


def phase_probe_main(device) -> list:
    """tools/torch_hbm_probe.py's probes at 512 MiB: the copy probe, read at
    S 1-8 and read2 at S 2 and 4, each kernel first held bit-equal to its
    plain version at that shape. Returns the two kernels' records (ms and
    the bound per pass of 512 MiB, at S = 1 for read and S = 2 for read2;
    every S under by_stripes)."""
    tool = load_tool("torch_hbm_probe")
    rows = tool.probe_rows(PROBE_MB, PROBE_CHUNK_ROWS)
    gen = torch.Generator(device=device).manual_seed(52)
    x = torch.rand(rows, hp.LANES, generator=gen, device=device)
    n_steps = rows // PROBE_CHUNK_ROWS
    xs = list(x.view(2, rows // 2, hp.LANES))  # read2 at S = 2: two halves
    cases = {"read": (lambda v: hp.hbm_read(v, PROBE_CHUNK_ROWS, 1, 1),
                      lambda v: hp.hbm_read_reference(v, PROBE_CHUNK_ROWS, 1,
                                                      1), x),
             "read2": (lambda v: hp.hbm_read2(v, PROBE_CHUNK_ROWS, 1),
                       lambda v: hp.hbm_read2_reference(v, PROBE_CHUNK_ROWS,
                                                        1),
                       [t.contiguous() for t in xs])}
    records = {}
    for name, (run, plain, arg) in cases.items():
        out, ref = run(arg), plain(arg)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{name} at {PROBE_MB} MiB differs from "
              "its plain version")
        records[name] = dict(
            name=f"hbm_{name}", route="cuda",
            source="glass_tpu_torch/csrc/hbm_probe.cu",
            replaces=PROBE_TPU[name].split()[0], tpu=[PROBE_TPU[name]],
            max_abs_err=0.0, plain_ms=time_ms(lambda: plain(arg)),
            library_ms=None,
            bound_ms=rows * hp.ROW_BYTES / PEAK_HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", chunk_rows=PROBE_CHUNK_ROWS, chunks=n_steps,
            mib=rows * hp.ROW_BYTES / 2**20)
    del xs, cases, x
    torch.cuda.empty_cache()
    hp.hbm_read.launches = hp.hbm_read2.launches = 0  # the path starts here
    results = tool.run(PROBE_MB, PROBE_ITERS, PROBE_CHUNK_ROWS,
                       ("copy", "read", "read2"))
    launches = {"read": hp.hbm_read.launches,
                "read2": hp.hbm_read2.launches}  # ... and ends here
    copy = next(r for r in results if r["probe"] == "copy")
    for name, rec in records.items():
        by_s = {r["stripes"]: r for r in results if r["probe"] == name}
        check(set(by_s) == set(tool.READ_STRIPES if name == "read"
                               else tool.READ2_STRIPES),
              f"{name}: stripes {sorted(by_s)}")
        check(launches[name] > 0, f"{name}: the probe path launched no kernel")
        main_s = min(by_s)
        rec.update(ms=by_s[main_s]["us_per_pass"] / 1e3, stripes=main_s,
                   launches=launches[name],
                   copy_probe_gb_per_s=copy["gb_per_s"],
                   by_stripes={s: dict(ms=r["us_per_pass"] / 1e3,
                                       gb_per_s=r["gb_per_s"],
                                       share_of_peak=r["share_of_peak"])
                               for s, r in by_s.items()})
        emit("probe_main", kernel=name, **{k: rec[k] for k in (
            "ms", "bound_ms", "plain_ms", "launches", "copy_probe_gb_per_s",
            "by_stripes")})
    return list(records.values())


# ------------------------------------------------- the layout planner

HYBRID_FAR_EDGES = 4000  # symmetric far edges, first to last community
HYBRID_STEPS = 20
HYBRID_MIN_BAND_SHARE = 0.5


def plan_launches(graph, n: int) -> dict:
    """The launch counts (full_counts()' form) of ``n`` SpMMs on the layout
    the graph holds: band and BCSR by their dtype (both for a hybrid), the
    int8 dense kernel, and no kernel for a dense f32/bf16 matrix
    (torch.matmul) or the segment path."""
    want = counts_form()
    if graph.band is not None:
        want["band"] = {str(graph.band.slabs.dtype).removeprefix("torch."): n}
    if graph.bcsr is not None:
        want["bcsr"] = {str(graph.bcsr.blocks.dtype).removeprefix("torch."):
                        n}
    if graph.band is None and graph.bcsr is None and graph.dense_q is not None:
        want["dense_q"] = n
    return want


def held_kind(graph) -> str:
    """The layout the graph holds, in the planner's words."""
    if graph.band is not None:
        return "hybrid" if graph.bcsr is not None else "band"
    if graph.bcsr is not None:
        return "bcsr"
    return ("dense" if graph.dense is not None or graph.dense_q is not None
            else "segment")


def check_planned(what: str, graph, x) -> dict:
    """Holds each kernel of the layout a graph holds against its plain
    version on x (KERNEL_TOL): band, band_t, BCSR, BCSR_t, int8 dense;
    where the layout launches no kernel (a dense f32/bf16 matrix or the
    segment path), the "pallas" SpMM against the "segment" mode within rtol
    1e-4. Returns the max |kernel - plain| of each part."""
    errs = {}
    parts = [("band", graph.band, bd.band_spmm, bd.band_spmm_reference),
             ("bcsr", graph.bcsr, bs.bcsr_spmm, bs.bcsr_spmm_reference)]
    if graph.band_t is not graph.band:
        parts.append(("band_t", graph.band_t, bd.band_spmm,
                      bd.band_spmm_reference))
    if graph.bcsr_t is not graph.bcsr:
        parts.append(("bcsr_t", graph.bcsr_t, bs.bcsr_spmm,
                      bs.bcsr_spmm_reference))
    for part, layout, fn, plain in parts:
        if layout is not None:
            errs[part], _ = check_vs_plain(
                f"{what} {part}", lambda v, a=layout, f=fn: f(a, v),
                lambda v, a=layout, p=plain: p(a, v), x)
    if graph.band is None and graph.bcsr is None and graph.dense_q is not None:
        errs["dense_q"], _ = check_vs_plain(
            f"{what} dense_q", lambda v: dq.dense_q_spmm(graph.dense_q, None, v),
            lambda v: dq.dense_q_spmm_reference(graph.dense_q, v), x)
    if not errs:
        out, ref = spmm(graph, x, "pallas"), spmm(graph, x, "segment")
        scale = float(ref.abs().max())
        errs["vs_segment"] = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=1e-4, atol=1e-5 * scale),
              f"{what}: {graph.plan} vs segment max|diff| "
              f"{errs['vs_segment']}")
    return errs


def plan_summary(graph) -> dict:
    """The planner's choice as the graph holds it."""
    out = dict(plan=graph.plan, kind=held_kind(graph))
    if graph.band is not None:
        out.update(rps=graph.band.rps, w_blocks=graph.band.w_blocks,
                   affine_stride=graph.band.affine_stride,
                   affine_off=graph.band.affine_off,
                   slab_dtype=str(graph.band.slabs.dtype),
                   slab_bytes=graph.band.slabs.numel()
                   * graph.band.slabs.element_size())
    if graph.bcsr is not None:
        out.update(bcsr_stored_blocks=graph.bcsr.blocks.shape[0] * bs.CHUNK,
                   bcsr_dtype=str(graph.bcsr.blocks.dtype))
    return out


def planner_costs(ei, n, aggr, dense_dtype) -> dict:
    """The planner's modeled seconds per family on this graph (the same
    call build_graph makes)."""
    from glass_tpu_torch.ops import graph as tg
    from glass_tpu_torch.ops.bcsr_spmm import coo_is_symmetric

    w = tg.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, aggr)
    row, col = ei[0].astype(np.int64), ei[1].astype(np.int64)
    order = np.lexsort((col, row))
    row, col, w = row[order], col[order], w[order]
    sym = coo_is_symmetric(row, col, (w != 0).astype(np.float32))
    kind, rps, wb, costs = tg._plan_block_sparse(
        row, col, w, n, dense_dtype, None, "auto", sym, with_costs=True)
    other = tg._dense_segment_costs(n, ei.shape[1], dense_dtype)
    costs.update(dense=other["dense"], segment=other["segment"])
    return dict(block_sparse=[kind, rps, wb], **{f"{k}_ms": v * 1e3
                                                for k, v in costs.items()})


def phase_autotune(device) -> dict:
    """ensure_autotune on the card into a temporary file (the CLI's
    --autotune), its three constants printed; then the em_user stand-in
    planned under that file. Returns the fitted constants."""
    from glass_tpu_torch.ops.autotune import ensure_autotune

    old = os.environ.get("GLASS_TPU_AUTOTUNE")
    with tempfile.TemporaryDirectory(prefix="glass_autotune_") as tmp:
        path = Path(tmp) / "autotune_cuda.json"
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                ensure_autotune(str(path), device=device)
            fitted = json.loads(path.read_text())
            check(os.environ["GLASS_TPU_AUTOTUNE"] == str(path),
                  "ensure_autotune did not export its file")
            check(all(fitted[k] > 0 for k in (
                "band_step_cost_s", "bcsr_step_cost_s", "stream_bps")),
                f"fitted constants {fitted}")
            ei, n = clustered_graph()
            costs = planner_costs(ei, n, EM_USER["aggr"], "f32")
        finally:
            if old is None:
                os.environ.pop("GLASS_TPU_AUTOTUNE", None)
            else:
                os.environ["GLASS_TPU_AUTOTUNE"] = old
    emit("autotune", seconds=time.perf_counter() - t0, fitted=fitted,
         em_user_plan_under_fit=costs)
    return fitted


FILL_ROW_BLOCKS = (32, 64, 96)  # fewer row blocks than fill the card
FILL_FULL_ROW_BLOCKS = 448      # em_user's: a full card
FILL_WIDTH = 8                  # window blocks of the fill layouts


def phase_planner_rates(device) -> dict:
    """The planner's rates that the calibration does not fit, on this card
    (ops/graph.py's _MXU_FLOPS, _DENSE_Q_FLOPS, _GATHER_BPS and
    _CARD_ROW_BLOCKS):
    - the dense candidate: torch.matmul of an (n, n) matrix with (n, 128)
      x at the hpo shape, f32 (TF32 off) and bf16, and the int8 dense
      kernel on an (n, n) int8 layout, as 2 n^2 128 / time;
    - the segment candidate: the "segment" SpMM at the em_user shape, H =
      128, as the model counts its bytes, 2 (16 + 128 * 4) per edge;
    - the card's fill: the f32 band kernel (H = 64) on banded layouts of R
      row blocks, one launch at a time (time_ms, as the model's paths
      launch it) against a busy card (ops/autotune.py's CUDA graph over 8
      streams). Below the card's fill, busy / alone = R / row blocks of a
      full card, so each R gives R * alone / busy; the median is the
      estimate. At em_user's 448 row blocks alone / busy should be ~1."""
    from glass_tpu_torch.ops import autotune as at
    from glass_tpu_torch.ops.spmm import spmm_segment

    gen = torch.Generator().manual_seed(60)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    rates = {}
    n = HPO_NODES
    a = torch.randn(n, n, generator=gen).to(device)
    x = torch.randn(n, 128, generator=gen).to(device)
    for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        aa, xx = a.to(dt), x.to(dt)
        ms = time_ms(lambda: torch.matmul(aa, xx))
        rates[f"mxu_flops_{key}"] = 2.0 * n * n * 128 / (ms / 1e3)
        rates[f"matmul_ms_{key}"] = ms
    del a, aa, xx
    pad = -(-n // BLOCK) * BLOCK  # the kernel's time does not hang on values
    q = torch.zeros(pad, pad, dtype=torch.int8, device=device)
    q[:n, :n] = torch.randint(-127, 128, (n, n), generator=gen,
                              dtype=torch.int8).to(device)
    layout = dq.DenseQ(q=q, scale=torch.rand(pad, generator=gen).to(device),
                       n_row=n, n_col=n)
    ms = time_ms(lambda: dq.dense_q_spmm(layout, None, x))
    rates["dense_q_flops"] = 2.0 * n * n * 128 / (ms / 1e3)
    rates["dense_q_ms"] = ms
    del q, layout, x
    ei, n = clustered_graph()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_dense=False,
                        device=device)
    x = torch.randn(n, 128, generator=gen).to(device)
    ms = time_ms(lambda: spmm_segment(graph, x))
    rates["gather_bps"] = graph.n_edge * 2 * (16 + 128 * 4) / (ms / 1e3)
    rates["segment_ms"] = ms
    del graph, x

    rng = np.random.default_rng(61)
    fill = {}
    for r_blocks in FILL_ROW_BLOCKS + (FILL_FULL_ROW_BLOCKS,):
        r, c, n = at._banded_graph(r_blocks, FILL_WIDTH, 4000, rng)
        band = bd.build_band(r, c, np.ones(r.size, np.float32), n, 1,
                             device=device)
        x = torch.randn(n, EM_USER["hidden_dim"], generator=gen).to(device)
        alone = time_ms(lambda: bd.band_spmm(band, x))
        busy = at.cuda_graph_seconds(lambda v: bd.band_spmm(band, v), x,
                                     100) * 1e3
        fill[r_blocks] = dict(alone_ms=alone, busy_ms=busy,
                              alone_over_busy=alone / busy,
                              full_row_blocks=r_blocks * alone / busy,
                              slab_bytes=band.slabs.numel() * 4)
        del band, x
    rates["card_row_blocks"] = statistics.median(
        fill[r]["full_row_blocks"] for r in FILL_ROW_BLOCKS)
    emit("planner_rates", hpo_n=HPO_NODES, **rates, fill_by_row_blocks=fill,
         sms=torch.cuda.get_device_properties(device).multi_processor_count)
    return rates


def train_one_epoch(graph, feats, model, cfg, pos, y, rng, steps=None):
    """One Trainer epoch (at most ``steps`` steps), the kernels the card
    ran in it counted (card_launches). Returns (losses, steps, the card's
    counts, ms per step)."""
    trainer = Trainer(model, graph, feats, cfg)
    trainer.init(0)
    pos_b, y_b = make_train_batches(rng, pos, y, cfg.batch_size)
    if steps is not None:
        pos_b, y_b = pos_b[:steps], y_b[:steps]
    with card_launches() as ran:
        t0 = time.perf_counter()
        res = trainer.train_epoch(pos_b, y_b)
        ms = (time.perf_counter() - t0) * 1e3 / len(res.step_losses)
    return res.step_losses, len(res.step_losses), ran.card, ms


def alternative_ms(ei, n, aggr, dense_dtype, graph, costs, x, device,
                   kind=None) -> dict:
    """The card's time of the layout the planner ranked next on this graph:
    the best block-sparse layout when it chose the dense path, else the
    dense path; or the block-sparse layout ``kind`` (its kernels held
    against their plain versions too)."""
    if kind is None and graph.plan == "dense":
        kind = costs["block_sparse"][0]
    if kind is not None:
        alt = build_graph(ei, None, n, aggr, materialize_dense=False,
                          materialize_bcsr=True, sparse_layout=kind,
                          dense_dtype=dense_dtype, device=device)
        errs = check_planned(f"{kind} beside the {graph.plan} plan", alt, x)
        mode = "pallas"
    else:
        kind, errs, mode = "dense", {}, "dense"
        alt = build_graph(ei, None, n, aggr, materialize_dense=True,
                          dense_dtype=dense_dtype, device=device)

    def run():
        return spmm(alt, x, mode)

    out = dict(plan_summary(alt) if kind != "dense" else {"kind": kind},
               spmm_ms=time_ms(run), spmm_device_ms=cold_ms(run),
               max_abs_err=errs)
    del alt
    return out


def phase_planner_main(device) -> None:
    """The planner on the em_user and hpo stand-ins, f32 and int8, as the
    protocol's "pallas" route builds them (materialize_dense=False,
    sparse_layout="auto"): the choice (kind, rps, window, modeled costs),
    each kernel of the chosen layout against its plain version, and the
    card's time of one "pallas" SpMM on it at H = 64; on hpo one training
    epoch, its launches those of the chosen layout, and the time of the
    layout ranked next."""
    for dd in ("f32", "int8"):
        ei, n = clustered_graph()
        t0 = time.perf_counter()
        graph = build_graph(ei, None, n, EM_USER["aggr"],
                            materialize_dense=False, materialize_bcsr=True,
                            sparse_layout="auto", dense_dtype=dd,
                            device=device)
        sync(device)
        build_s = time.perf_counter() - t0
        check(graph.plan == held_kind(graph),
              f"em_user {dd}: plan {graph.plan}, layout {held_kind(graph)}")
        x = torch.randn(n, EM_USER["hidden_dim"],
                        generator=torch.Generator().manual_seed(28)).to(device)
        errs = check_planned(f"em_user {dd} planned", graph, x)
        spmm_ms = time_ms(lambda: spmm(graph, x, "pallas"))
        costs = planner_costs(ei, n, EM_USER["aggr"], dd)
        # the other block-sparse family, timed the same way
        other = "band" if graph.plan == "bcsr" else "bcsr"
        emit("planner_main", graph="em_user", dense_dtype=dd, n_node=n,
             build_s=build_s, **plan_summary(graph), max_abs_err=errs,
             spmm_ms=spmm_ms, spmm_device_ms=cold_ms(
                 lambda: spmm(graph, x, "pallas")), costs=costs,
             next_ranked=alternative_ms(ei, n, EM_USER["aggr"], dd, graph,
                                        costs, x, device, kind=other))
        del graph

        ei, n = hpo_graph()
        t0 = time.perf_counter()
        graph = build_graph(ei, None, n, HPO_METAB["aggr"],
                            materialize_dense=False, materialize_bcsr=True,
                            sparse_layout="auto", dense_dtype=dd,
                            device=device)
        sync(device)
        build_s = time.perf_counter() - t0
        check(graph.plan == held_kind(graph),
              f"hpo {dd}: plan {graph.plan}, layout {held_kind(graph)}")
        feats_np = degree_features(ei, n)
        model = GLASS(int(feats_np.max()), HPO_METAB["hidden_dim"],
                      HPO_METAB["conv_layer"], (HPO_CLASSES,),
                      (HPO_METAB["pool"],), activation=HPO_METAB["activation"],
                      z_ratio=HPO_METAB["z_ratio"], jk=HPO_METAB["jk"],
                      dropout=HPO_METAB["dropout"], spmm_mode="pallas",
                      seed=0, device=device)
        rng = np.random.default_rng(27)
        pos, y = class_labelled_subgraphs(rng, HPO_SUBGRAPHS, n, HPO_CLASSES)
        losses, steps, counts, ms = train_one_epoch(
            graph, torch.from_numpy(feats_np).to(device), model,
            TrainConfig(lr=HPO_METAB["lr"], resi=HPO_METAB["resi"],
                        batch_size=HPO_METAB["batch_size"], loss="ce"),
            pos, y, rng)
        want = plan_launches(graph, 2 * HPO_METAB["conv_layer"] * steps)
        check(counts == want, f"hpo {dd} ({graph.plan}): launches {counts}, "
              f"expected {want}")
        check(np.isfinite(losses).all(), f"hpo {dd}: non-finite losses")
        x = torch.randn(n, HPO_METAB["hidden_dim"],
                        generator=torch.Generator().manual_seed(28)).to(device)
        errs = check_planned(f"hpo {dd} planned", graph, x)
        spmm_ms = time_ms(lambda: spmm(graph, x, "pallas"))
        spmm_device_ms = cold_ms(lambda: spmm(graph, x, "pallas"))
        costs = planner_costs(ei, n, HPO_METAB["aggr"], dd)
        del model
        emit("planner_main", graph="hpo", dense_dtype=dd, n_node=n,
             build_s=build_s, **plan_summary(graph), max_abs_err=errs,
             spmm_ms=spmm_ms, spmm_device_ms=spmm_device_ms, costs=costs,
             train_steps=steps,
             launches=counts, ms_per_step=ms,
             losses=list(map(float, losses)),
             next_ranked=alternative_ms(ei, n, HPO_METAB["aggr"], dd, graph,
                                        costs, x, device))
        del graph


def hybrid_edges():
    """The em_user stand-in plus HYBRID_FAR_EDGES symmetric edges between
    the first and the last community (tests/test_pallas_band.py:179-186 at
    full size): a narrow band with a far residue."""
    ei, n = clustered_graph()
    rng = np.random.default_rng(53)
    src = rng.integers(0, COMM_SIZE, HYBRID_FAR_EDGES)
    dst = (N_COMM - 1) * COMM_SIZE + rng.integers(0, COMM_SIZE,
                                                  HYBRID_FAR_EDGES)
    far = np.stack([np.r_[src, dst], np.r_[dst, src]])
    return np.concatenate([ei, far], axis=1), n


def band_csr(band) -> torch.Tensor:
    """A band layout as a torch CSR tensor (the library yardstick's input
    for the band part alone; timed only)."""
    g, r, k = torch.nonzero(band.slabs, as_tuple=True)
    rows = g * band.rps * BLOCK + r
    cols = band.clo.long()[g] * BLOCK + k
    n = band.n_node
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), band.slabs[g, r, k].float(), (n, n),
        ).coalesce().to_sparse_csr()


def phase_hybrid_main(device) -> dict:
    """The hybrid split at em_user width: the band (per-group windows) and
    the BCSR residue, each kernel against its plain version; a training
    epoch with 2 band and 2 BCSR launches per step; requests against the
    "segment" mode within rtol 1e-4. Returns the per-group band kernel's
    record (row 5 of the TPU kernel table at full width)."""
    gen = torch.Generator().manual_seed(54)
    ei, n = hybrid_edges()
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="hybrid", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    band, bcsr = graph.band, graph.bcsr
    check(band is not None and bcsr is not None and graph.band_t is band
          and graph.bcsr_t is bcsr and band.affine_stride is None,
          "the hybrid graph lacks its symmetric band and BCSR parts")
    band_nnz = int((band.slabs != 0).sum())
    bcsr_nnz = int((bcsr.blocks != 0).sum())
    share = band_nnz / (band_nnz + bcsr_nnz)
    check(share > HYBRID_MIN_BAND_SHARE,
          f"the band carries {share:.3f} of the nonzeros")
    emit("graph_hybrid", n_node=n, directed_edges=graph.n_edge,
         far_edges=2 * HYBRID_FAR_EDGES, build_s=build_s,
         band_nonzeros=band_nnz, bcsr_nonzeros=bcsr_nnz, band_share=share,
         **plan_summary(graph))

    h = EM_USER["hidden_dim"]
    x = torch.randn(n, h, generator=gen).to(device)
    err, scale = check_vs_plain("hybrid band", lambda v: bd.band_spmm(band, v),
                                lambda v: bd.band_spmm_reference(band, v), x)
    b_err, _ = check_vs_plain("hybrid bcsr", lambda v: bs.bcsr_spmm(bcsr, v),
                              lambda v: bs.bcsr_spmm_reference(bcsr, v), x)
    adj = band_csr(band)
    record = kernel_record(
        "band_spmm_per_group", "glass_tpu_torch/csrc/band_spmm.cu",
        "glass_tpu/ops/pallas_band.py:465", BAND_TPU[1:],
        lambda v: bd.band_spmm(band, v),
        lambda v: bd.band_spmm_reference(band, v),
        lambda v: torch.sparse.mm(adj, v), x, band_bound_ms(band, x), err)
    emit("kernel_band_per_group_main", H=h, max_abs_err=err,
         max_abs_ref=scale, bcsr_max_abs_err=b_err,
         **{k: record[k] for k in TIME_KEYS})
    del adj, x

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    model = em_user_model(int(feats_np.max()), "pallas", device,
                          dropout=EM_USER["dropout"])
    rng = np.random.default_rng(55)
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS, N_COMM, COMM_SIZE)
    losses, steps, counts, ms = train_one_epoch(
        graph, feats, model, TrainConfig(
            lr=EM_USER["lr"], resi=EM_USER["resi"],
            batch_size=EM_USER["batch_size"], loss="bce"),
        pos, y, rng, steps=HYBRID_STEPS)
    per = 2 * EM_USER["conv_layer"] * steps
    check(counts == counts_form(bcsr={"float32": per}, band={"float32": per}),
          f"hybrid training launches {counts}: expected {per} band and {per} "
          "BCSR launches")
    check(np.isfinite(losses).all(), "hybrid: non-finite losses")
    record["launches"] = counts["band"].get("float32", 0)
    record["launches_per_step"] = 2 * EM_USER["conv_layer"]
    emit("train_hybrid", steps=steps, launches=counts, ms_per_step=ms,
         losses=list(map(float, losses)))

    pred = Predictor(model, graph, feats, device=device)
    model_seg = em_user_model(int(feats_np.max()), "segment", device)
    model_seg.load_state_dict(model.state_dict())
    pred_seg = Predictor(model_seg, graph, feats, device=device)
    requests = [make_request(np.random.default_rng(56), b, N_COMM, COMM_SIZE)
                for b in REQUEST_BATCHES]
    served, _ = serve_requests(pred, requests,
                               {"band": "float32", "bcsr": "float32"},
                               EM_USER["conv_layer"])
    for subs, out, ms, _ in served:
        ref = pred_seg(subs)
        diff = float(np.abs(out - ref).max())
        ref_scale = float(np.abs(ref).max())
        check(np.allclose(out, ref, rtol=1e-4, atol=1e-5 * ref_scale),
              f"hybrid batch {len(subs)}: vs segment max|diff| {diff}")
        emit("request_hybrid", batch=len(subs), ms_first=ms,
             max_abs_diff_vs_segment=diff, max_abs_logit=ref_scale)
    return record


# ------------------------------------------------- the native host library


# sha256 of clustered_graph()'s edge_index (int64) and of the RCM order the
# JAX package's library (the tracked native/libglass_host.so) gives it;
# tests/test_torch_native.py::test_standin_rcm_order_digest holds both
STANDIN_EDGES_SHA256 = (
    "94a637d00472cc8c3c72be26d4aba6e5290befd2eb8a8d88ae638e55c7f9623d")
STANDIN_RCM_SHA256 = (
    "04a050a5491ad7756828d6d30ae086f754d153c703cfa355acbd65e01d9a4cec")


def sha256(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a, np.int64).tobytes()
                          ).hexdigest()


@contextlib.contextmanager
def numpy_branches():
    """The native library unloaded inside the block: every caller takes its
    numpy or scipy branch."""
    kept = native._LIB, native._SEARCHED
    native._LIB, native._SEARCHED = None, True
    try:
        yield
    finally:
        native._LIB, native._SEARCHED = kept


def timed_call(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def same_bytes(a, b) -> bool:
    a, b = (np.ascontiguousarray(v.numpy() if torch.is_tensor(v) else v)
            for v in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def phase_native(device) -> None:
    """[native]: the host library built from the port's own source
    (glass_tpu_torch/csrc/glass_host.cpp) and loaded (the run fails on the
    numpy branches); on the em_user stand-in
    its RCM order twice (equal, and equal to the JAX package's library's
    order by digest) beside scipy's (the fallback) and the CSR, band and
    BCSR builds (BCSR also from int32 rows and columns, the lean path)
    against the numpy branches, byte-equal, timed."""
    path, build_s = timed_call(native.build)
    check(native.is_available() and native._load()._name == str(path),
          f"the native library did not build and load from {native.SOURCE}")
    ei, n = clustered_graph()
    check(sha256(ei) == STANDIN_EDGES_SHA256,
          "this numpy draws another stand-in graph than the one whose RCM "
          "order STANDIN_RCM_SHA256 pins")
    perm, rcm_s = timed_call(lambda: native.rcm_ordering(ei, n))
    check(np.array_equal(perm, native.rcm_ordering(ei, n)),
          "two native RCM orders of one graph differ")
    check(sha256(perm) == STANDIN_RCM_SHA256,
          "the library built here orders the stand-in otherwise than the "
          "JAX package's library")
    check(np.array_equal(np.sort(perm), np.arange(n)),
          "the RCM order is not a permutation")
    with numpy_branches():
        scipy_perm, scipy_s = timed_call(lambda: native.rcm_ordering(ei, n))
    out = dict(library=path.name, build_s=build_s,
               openmp=path == native.library_path(), n_node=n,
               directed_edges=ei.shape[1], rcm_s=rcm_s, rcm_scipy_s=scipy_s,
               rcm_positions_equal_to_scipy=float(np.mean(perm == scipy_perm)))
    csr = lambda: build_graph(ei, None, n, EM_USER["aggr"],
                              materialize_dense=False, device="cpu")
    fast, out["csr_s"] = timed_call(csr)
    with numpy_branches():
        slow, out["csr_numpy_s"] = timed_call(csr)
    for name in ("row", "col", "weight"):
        check(same_bytes(getattr(fast, name), getattr(slow, name)),
              f"native and numpy CSR {name} differ")
    e = fast.n_edge
    coo = (fast.row.numpy()[:e], fast.col.numpy()[:e],
           fast.weight.numpy()[:e])
    # build_graph's host arrays: int32, row-sorted (the lean BCSR path)
    coo32 = (coo[0].astype(np.int32), coo[1].astype(np.int32), coo[2])
    builds = {"band": lambda: bd.build_band_arrays(*coo, n, rps=1),
              "bcsr": lambda: bs.build_bcsr_arrays(*coo, n),
              "bcsr_lean": lambda: bs.build_bcsr_arrays(*coo32, n)}
    for kind, build in builds.items():
        a, out[f"{kind}_s"] = timed_call(build)
        with numpy_branches():
            b, out[f"{kind}_numpy_s"] = timed_call(build)
        for key in a:
            if isinstance(a[key], (np.ndarray, torch.Tensor)):
                check(same_bytes(a[key], b[key]),
                      f"native and numpy {kind} {key} differ")
            else:
                check(a[key] == b[key], f"native and numpy {kind} {key}")
    emit("native", card=card_line(), **out)


# -------------------------------------------------------- captured steps

PROFILED_REPLAYS, PROFILER_SESSIONS = 3, 8
# after a profiler session starts and before it stops: records of the first
# and the last kernels were missing in sessions that did not wait
PROFILER_SETTLE_S = 0.1
# graphed against eager steps: the same kernels on the same inputs, the
# same dropout masks (the generator registered with the graph)
GRAPH_LOSS_RTOL = 1e-6
GRAPH_PARAM_TOL = 1e-5  # times max |parameter|
GRAPH_SMALL_EPOCHS, GRAPH_SMALL_SUBGRAPHS = 3, 60  # 10 steps of 6 an epoch
# a plateau that halves the rate after every epoch but the first (whose
# loss sets the best), so the third epoch's replays read a rate written in
# place after the second
GRAPH_PLATEAU = dict(plateau_patience=0, plateau_threshold=0.5, resi=0.5)


def within(a: dict, b: dict) -> bool:
    """Every count of full_counts()-form ``a`` at most ``b``'s."""
    for key, v in a.items():
        if isinstance(v, dict):
            if any(n > b[key].get(d, 0) for d, n in v.items()):
                return False
        elif v > b[key]:
            return False
    return True


def check_replays(trainer, what: str) -> dict:
    """PROFILED_REPLAYS replays of the trainer's captured step: the
    launches the card ran (card_counts) and the profiler's count of this
    repo's kernels by name, each against the launches its capture counted
    (one step's, times the replays), and the embedding backward's launch
    once a replay; with the fused norm, the reductions'
    tickets are 0 after the replays. Returns the step's counts. The
    replays are training steps: call it after comparing parameters.

    The profiler can lose kernel records on the card (PERF.md §7), and
    never adds any: a session that counts fewer is taken again, up to
    PROFILER_SESSIONS, and one that counts more, or a kernel the capture
    did not count, fails. The card's counters are exact in every
    session."""
    step = trainer._steps.graph
    check(step is not None, f"{what}: no captured step")
    want = step.counts
    need = scaled_sum((PROFILED_REPLAYS, want))
    for session in range(1, PROFILER_SESSIONS + 1):
        card_counts(reset=True)
        card_embedding(reset=True)
        with profiled_kernels() as seen, torch.cuda.stream(trainer._stream):
            for _ in range(PROFILED_REPLAYS):
                step.graph.replay()
        ran = card_counts()
        check(ran == need, f"{what}: the card ran {ran} in "
              f"{PROFILED_REPLAYS} replays, the capture counted {want} a step")
        emb = card_embedding()
        check(emb == PROFILED_REPLAYS, f"{what}: the card ran the embedding "
              f"backward {emb} times in {PROFILED_REPLAYS} replays, once a "
              f"step")
        check(within(seen["card"], need),
              f"{what}: the profiler saw {seen['card']} in {PROFILED_REPLAYS} "
              f"replays, the capture counted {want} a step ({seen['names']})")
        if seen["card"] == need:
            break
        emit("profiler_lost_records", what=what, session=session,
             seen=seen["card"], expected=need)
    check(seen["card"] == need,
          f"{what}: the profiler saw {seen['card']} in {PROFILED_REPLAYS} "
          f"replays in each of {PROFILER_SESSIONS} sessions, the capture "
          f"counted {want} a step ({seen['names']})")
    check_tickets(trainer, want, what)
    return want


def check_tickets(owner, per_step: dict, what: str) -> None:
    """With the fused norm in the step or forward (``per_step``'s counts),
    every reduction's ticket in the workspace of the stream of ``owner``
    (a Trainer or a Predictor) is 0."""
    if per_step["norm"]:
        index = owner.device.index
        ws = fn._WORKSPACE[(torch.cuda.current_device() if index is None
                            else index, owner._stream.cuda_stream)]
        check(not ws[:fn.PARTIALS_OFFSET].any(),
              f"{what}: a reduction's ticket is not 0 after the replays")


def graphed_and_eager(what, graph, spmm_mode, pos, y, max_deg, feats,
                      compute_dtype=None) -> dict:
    """The same small GLASS (dropout 0.5) trained from one seed eagerly
    and graphed over GRAPH_SMALL_EPOCHS epochs (the plateau stepping
    between them): losses and parameters compared, a step's launches by
    kernel at capture against the profiler's over replays, and the
    kernels the card ran both ways equal; and graphed with
    GLASS_TPU_REMAT=1 against graphed without (check_remat_run)."""
    runs = {}
    for graphed, on in ((False, False), (True, False), (True, True)):
        model = GLASS(max_deg, 16, 2, (1,), ("size",), dropout=0.5,
                      spmm_mode=spmm_mode, compute_dtype=compute_dtype,
                      seed=0, device=graph.device)
        trainer = Trainer(model, graph, feats, TrainConfig(
            lr=EM_USER["lr"], batch_size=6, loss="bce", **GRAPH_PLATEAU))
        trainer._graphed = graphed  # the eager loop: this comparison only
        trainer.init(1)
        rng = np.random.default_rng(62)
        with card_launches() as ran, EpochProbe() as probe, remat(on):
            losses = [trainer.train_epoch(
                *make_train_batches(rng, pos, y, 6)).step_losses
                for _ in range(GRAPH_SMALL_EPOCHS)]
        runs[graphed, on] = (np.concatenate(losses), trainer, probe, ran)
    (eager, trainer_e, _, ran_e), (graphed, trainer, probe, ran) = (
        runs[False, False], runs[True, False])
    remat_out = check_remat_run(what, runs[True, False], runs[True, True])
    check(trainer.plateau.lr < EM_USER["lr"] and
          trainer.plateau == trainer_e.plateau,
          f"{what}: the plateau did not step alike ({trainer.plateau})")
    params = trainer.model.state_dict()
    scale = max(float(v.abs().max()) for v in params.values())
    param_err = max(float((v - trainer_e.model.state_dict()[k])
                          .abs().max()) for k, v in params.items())
    check(np.isfinite(graphed).all() and np.allclose(
        graphed, eager, rtol=GRAPH_LOSS_RTOL, atol=0),
          f"{what}: graphed losses {graphed} vs eager {eager}")
    check(param_err <= GRAPH_PARAM_TOL * scale,
          f"{what}: parameters differ by {param_err} (max |param| {scale})")
    check(len(probe.captures) == 1 and probe.epochs[0]["captured"],
          f"{what}: {len(probe.captures)} captures")
    check(ran_e.card == ran_e.counted,
          f"{what}: eager, the card ran {ran_e.card}, the wrappers counted "
          f"{ran_e.counted}")
    check(ran.card == ran_e.card == scaled_sum((len(graphed),
                                                probe.captures[0])),
          f"{what}: the card ran {ran.card} graphed, {ran_e.card} eager, "
          f"the capture counted {probe.captures[0]} a step")
    per_step = check_replays(trainer, what)
    return dict(steps=len(graphed), per_step_launches=per_step,
                max_abs_loss_diff=float(np.abs(graphed - eager).max()),
                max_abs_param_diff=param_err, max_abs_param=scale,
                lr_after=float(trainer.plateau.lr), **remat_out)


def remat_extra(graph, per_step: dict, convs: int) -> dict:
    """The launches GLASS_TPU_REMAT adds to a step whose launches are
    ``per_step`` without it: each conv body's forward again in the
    backward pass, its SpMM and, with the fused norm (``per_step``'s norm
    passes), its GraphNorm's K1-K3 in the step's norm dtype."""
    norm = counts_form(
        norm={k: convs for k in ("colsum", "varsum", "affine")}
        if per_step["norm"] else None,
        norm_dtype=next(iter(per_step["norm_dtype"]), None))
    return scaled_sum((1, plan_launches(graph, convs)), (1, norm))


def check_remat_run(what: str, off: tuple, on: tuple) -> dict:
    """Two graphed runs of one model, seed and batches, GLASS_TPU_REMAT
    off and on ((losses, trainer, EpochProbe, Launches) each): losses and
    parameters bit-equal; the remat step's capture counts the step's
    launches without remat plus remat_extra; the card ran each run's
    capture once a step, and nothing else."""
    (l_off, t_off, p_off, _), (l_on, t_on, p_on, ran) = off, on
    check(np.array_equal(l_on, l_off),
          f"{what} remat: losses {l_on} against {l_off} without")
    state = t_off.model.state_dict()
    for k, v in t_on.model.state_dict().items():
        check(torch.equal(v, state[k]), f"{what} remat: parameter {k} "
              f"differs by {float((v - state[k]).abs().max())}")
    _, convs = model_counts(t_on.model)
    want = scaled_sum((1, p_off.captures[0]),
                      (1, remat_extra(t_on.graph, p_off.captures[0], convs)))
    check(p_on.captures == [want], f"{what} remat: captures counted "
          f"{p_on.captures}, a remat step is {want}")
    steps = sum(e["steps"] for e in p_on.epochs)
    check(ran.card == scaled_sum((steps, want)),
          f"{what} remat: the card ran {ran.card} in {steps} steps, "
          f"{want} a step")
    check_tickets(t_on, want, f"{what} remat")
    return dict(remat_per_step_launches=want, remat_bit_equal=True)


def phase_train_graph_small(device) -> None:
    """[train_graph_small]: on small layouts of every kernel family the
    training step reaches (BCSR f32, bf16, int8; band f32, int8 and
    per-group; the int8 dense layout; the fused norm on a band and, in
    bf16, on an int8 BCSR), eager against graphed steps."""
    ei, n = clustered_graph(8, BLOCK, 3000, seed=6)

    def asym(layout, dense_dtype):  # "mean": A^T a layout of its own
        return build_graph(ei, None, n, "mean", materialize_dense=False,
                           materialize_bcsr=True, sparse_layout=layout,
                           dense_dtype=dense_dtype, device=device)

    n_pg = 16 * BLOCK
    per_group = build_graph(
        piecewise_edges(np.random.default_rng(11), n_pg), None, n_pg, "sum",
        materialize_dense=False, materialize_bcsr=True, sparse_layout="band",
        device=device)
    check(per_group.band is not None and per_group.band.affine_stride is None,
          "the per-group case has no per-group band")
    cases = [("bcsr_f32", asym("bcsr", "f32"), "pallas", None, False),
             ("bcsr_bf16", asym("bcsr", "bf16"), "pallas", None, False),
             ("bcsr_int8", asym("bcsr", "int8"), "pallas", None, False),
             ("band_f32", asym("band", "f32"), "pallas", None, False),
             ("band_int8", asym("band", "int8"), "pallas", None, False),
             ("band_per_group", per_group, "pallas", None, False),
             ("dense_q_int8", dense_q_graph(device), "dense", None, False),
             ("band_f32_fused_norm", asym("band", "f32"), "pallas", None,
              True),
             ("bcsr_int8_bf16_fused_norm", asym("bcsr", "int8"), "pallas",
              "bfloat16", True)]
    for name, graph, mode, compute, fused in cases:
        rng = np.random.default_rng(63)
        pos, y = class_labelled_subgraphs(rng, GRAPH_SMALL_SUBGRAPHS,
                                          graph.n_node, 2)
        feats = torch.from_numpy(rng.integers(0, 6, (graph.n_node, 1))).to(
            device)
        with fused_norm(fused):
            out = graphed_and_eager(name, graph, mode, pos,
                                    y.astype(np.float32), 5, feats, compute)
        per_step = out["per_step_launches"]
        families = {k for k in ("bcsr", "band", "dense_q", "norm")
                    if per_step[k]}
        need = {"bcsr" if "bcsr" in name else "dense_q" if "dense" in name
                else "band"} | ({"norm"} if fused else set())
        check(families == need,
              f"{name}: the captured step launched {families}, not {need}")
        emit("train_graph_small", case=name, n_node=graph.n_node,
             compute_dtype=compute or "float32", fused_norm=fused, **out)


def replanned(graph) -> dict:
    """The planner's choices on the graph's own edges: "auto" (kind, rps,
    window blocks, and the modeled ms of each candidate) and a forced
    "band" (kind, rps, window blocks)."""
    from glass_tpu_torch.ops import graph as tg
    from glass_tpu_torch.ops.bcsr_spmm import coo_is_symmetric

    e = graph.n_edge
    row, col, w = (t[:e].cpu().numpy() for t in
                   (graph.row, graph.col, graph.weight))
    sym = coo_is_symmetric(row, col, (w != 0).astype(np.float32))
    kind, rps, wb, costs = tg._plan_block_sparse(
        row, col, w, graph.n_node, "f32", None, "auto", sym, with_costs=True)
    kind_b, rps_b, _ = tg._plan_block_sparse(row, col, w, graph.n_node,
                                             "f32", None, "band", sym)
    span = bd.rowblock_spans(row, col, graph.n_node)
    fit = tg.affine_gate(graph.n_node, rps_b, span)
    per_group = bd.band_stats(None, None, None, graph.n_node, rps_b,
                              rb_span=span)[0]
    return dict(auto=[kind, rps, wb],
                forced_band=dict(kind=kind_b, rps=rps_b,
                                 w_blocks=per_group if fit is None else fit[2],
                                 affine=fit),
                modeled_ms={k: v * 1e3 for k, v in costs.items()})


def em_user_training(graph, feats, max_deg, graphed: bool, perm=None) -> dict:
    """em_user (dropout 0.5, batch 6, lr 1e-3) trained TRAIN_EPOCHS epochs
    of 40 steps, eager or graphed, on size-labelled subgraphs of the
    stand-in (relabelled by ``perm``, RCM's, if given): each epoch's host
    ms (ending in its losses' readback), then one more epoch under the
    profiler for the device time of a step and the kernels the card ran
    in it; the card's launches of the embedding backward over the
    TRAIN_EPOCHS epochs."""
    model = em_user_model(max_deg, "pallas", graph.device,
                          dropout=EM_USER["dropout"])
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=EM_USER["lr"], resi=EM_USER["resi"],
        batch_size=EM_USER["batch_size"], loss="bce"))
    trainer._graphed = graphed  # the eager loop: the comparison only
    trainer.init(0)
    rng = np.random.default_rng(64)
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS, N_COMM, COMM_SIZE)
    if perm is not None:
        pos = relabel_pos(pos, perm, graph.n_node)
    losses, ms = [], []
    card_embedding(reset=True)
    with EpochProbe() as probe:
        for _ in range(TRAIN_EPOCHS):
            pos_b, y_b = make_train_batches(rng, pos, y, EM_USER["batch_size"])
            t0 = time.perf_counter()
            res = trainer.train_epoch(pos_b, y_b)  # ends in a readback
            ms.append((time.perf_counter() - t0) * 1e3 / len(res.step_losses))
            losses.append(res.step_losses)
        emb = card_embedding()
        pos_b, y_b = make_train_batches(rng, pos, y, EM_USER["batch_size"])
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        card_counts(reset=True)
        with torch.profiler.profile(activities=acts) as prof:
            res = trainer.train_epoch(pos_b, y_b)
        card = card_counts()
        losses.append(res.step_losses)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    steps = len(res.step_losses)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    host_ms = statistics.median(ms[1:])
    return dict(losses=np.stack(losses), trainer=trainer, probe=probe,
                host_ms_per_step=host_ms, host_ms_per_step_epochs=ms,
                device_ms_per_step=device_ms, profiled_steps=steps,
                profiled_launches=card, embedding_launches=emb,
                idle_share=1 - device_ms / host_ms)


def phase_train_graph(device, emb_record: dict) -> list:
    """[train_graph]: em_user at full width on the stand-in, eager against
    graphed steps, through the CLI's default route (native RCM, then the
    planner's layout) and then on the forced band with the fused norm:
    losses and parameters bit-equal (the embedding's backward sums in a
    fixed order), the embedding backward once a step on the card both
    ways (the default route's graphed count is ``emb_record``'s
    launches). Returns each route's (name, graph, feats, max degree, RCM
    order or None, fused norm) for phase_remat."""
    ei, n = clustered_graph()
    feats_np = degree_features(ei, n)
    perm, rcm_s = timed_call(lambda: native.rcm_ordering(ei, n))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    routes = [("default_route", inv[ei], feats_np[perm], "auto", perm),
              ("forced_band_fused_norm", ei, feats_np, "band", None)]
    built = []
    for route, edges, feats_r, layout, order in routes:
        fused = order is None
        graph, build_s = timed_call(lambda: build_graph(
            edges, None, n, EM_USER["aggr"], materialize_dense=False,
            materialize_bcsr=True, sparse_layout=layout, device=device))
        feats = torch.from_numpy(feats_r).to(device)
        max_deg = int(feats_np.max())
        with fused_norm(fused):
            eager = em_user_training(graph, feats, max_deg, False, order)
            graphed = em_user_training(graph, feats, max_deg, True, order)
        a, b = graphed["losses"], eager["losses"]
        check(np.isfinite(a).all() and np.array_equal(a, b),
              f"{route}: graphed losses vs eager, max |diff| "
              f"{float(np.abs(a - b).max())}")
        check(a[-1].mean() < a[0].mean(),
              f"{route}: losses did not fall ({a[0].mean()} -> "
              f"{a[-1].mean()})")
        pe = graphed["trainer"].model.state_dict()
        scale = max(float(v.abs().max()) for v in pe.values())
        param_err = max(float((v - eager["trainer"].model.state_dict()[k])
                              .abs().max()) for k, v in pe.items())
        check(param_err == 0.0, f"{route}: parameters differ by {param_err}")
        trained = TRAIN_EPOCHS * int(a.shape[1])
        for how, run in (("eager", eager), ("graphed", graphed)):
            check(run["embedding_launches"] == trained,
                  f"{route} {how}: the card ran the embedding backward "
                  f"{run['embedding_launches']} times in {trained} steps")
        if order is not None:
            emb_record["launches"] = graphed["embedding_launches"]
        with fused_norm(fused):  # replays step on: after the comparison
            per_step = check_replays(graphed["trainer"], route)
        norms, convs = model_counts(graphed["trainer"].model)
        norm = counts_form(norm={k: norms for k in fn.KERNELS} if fused
                           else None, norm_dtype="float32")
        want = scaled_sum((1, plan_launches(graph, 2 * convs)), (1, norm))
        for c in graphed["probe"].captures:
            check(c == want, f"{route}: a capture counted {c}, a step is "
                  f"{want}")
        for how, run in (("eager", eager), ("graphed", graphed)):
            check(run["profiled_launches"] == scaled_sum(
                (run["profiled_steps"], want)),
                f"{route} {how}: the card ran {run['profiled_launches']} "
                f"in {run['profiled_steps']} steps, {want} a step expected")
        trainer = graphed["trainer"]
        per_fwd = forward_launches(graph, trainer.model, fused)
        rng = np.random.default_rng(70)
        splits = {}
        for split in ("val", "test"):
            p, y_s = size_labelled_subgraphs(rng, EVAL_SPLIT, N_COMM,
                                             COMM_SIZE)
            splits[split] = (p if order is None
                             else relabel_pos(p, order, n), y_s)

        def request(r, b):  # the stand-in's ids, RCM-relabelled on its route
            subs = make_request(r, b, N_COMM, COMM_SIZE)
            return subs if order is None else [inv[s].tolist() for s in subs]

        with fused_norm(fused):
            phase_eval_graph(route, trainer, splits, per_fwd)
            phase_request_graph(route, Predictor(trainer.model, graph, feats,
                                                 device=device),
                                request, per_fwd)
        emit("train_graph", route=route, card=card_line(), **plan_summary(graph),
             planner=replanned(graph), build_s=build_s, rcm_s=rcm_s if layout == "auto" else None,
             fused_norm=fused, steps=int(a.size),
             eager_host_ms_per_step=eager["host_ms_per_step"],
             graphed_host_ms_per_step=graphed["host_ms_per_step"],
             eager_device_ms_per_step=eager["device_ms_per_step"],
             graphed_device_ms_per_step=graphed["device_ms_per_step"],
             eager_idle_share=eager["idle_share"],
             graphed_idle_share=graphed["idle_share"],
             host_speedup=eager["host_ms_per_step"]
             / graphed["host_ms_per_step"],
             eager_epochs_ms_per_step=eager["host_ms_per_step_epochs"],
             graphed_epochs_ms_per_step=graphed["host_ms_per_step_epochs"],
             per_step_launches=per_step,
             profiled_epoch_launches=graphed["profiled_launches"],
             first_epoch_loss=float(a[0].mean()),
             last_epoch_loss=float(a[-1].mean()),
             max_abs_loss_diff=float(np.abs(a - b).max()),
             max_abs_param_diff=param_err, bit_equal=True,
             embedding_launches=graphed["embedding_launches"])
        built.append((route, graph, feats, max_deg, order, fused))
        del eager, graphed, trainer
    return built


# ------------------------------------------ the fixed-order embedding

EMB_TOL = 1e-6  # max |kernel - plain| <= EMB_TOL * max |plain|
EMB_REPLACES = ("none: the JAX gradient of the table lookup "
                "(glass_tpu/nn/modules.py, nn.Embed) is XLA's scatter-add")
EMB_SOURCE = "glass_tpu_torch/csrc/embedding_bwd.cu"
LADDER_TOP = 40  # the ladder's largest rung: 2,293,760 ids over 16 values
# (width, dtype) of the cotangents the kernel takes on em_user's ids besides
# width 64: one value a lane (component's 17 in f32; coreness's 20 in
# bf16, not a multiple of 8) and two column tiles (160 f32, 40 vectors)
EMB_OTHER_WIDTHS = ((NARROW_H, torch.float32), (20, torch.bfloat16),
                    (160, torch.float32))


def embedding_bound_ms(order, g) -> tuple:
    """The least time of one embedding backward: g read once, the order
    (perm, sorted ids, the chunk and id tables) read once, the table's
    gradient written once, at 3.35 TB/s; or its adds at the f32 rate."""
    h = g.shape[1]
    moved = (g.numel() * g.element_size() + 8 * order.n_rows
             + 4 * (order.n_chunks + order.n_ids + 2) + 4 * order.n_ids * h)
    by_bytes = moved / PEAK_HBM_BYTES_PER_S * 1e3
    by_ops = order.n_rows * h / PEAK_F32_FLOPS * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def check_embedding(what: str, order, g) -> dict:
    """The kernel (ops/embedding.py::embedding_backward) against its plain
    version on one cotangent: within EMB_TOL, finite, (n_ids, H) f32, a
    repeat bit-identical."""
    out = eb.embedding_backward(order, g)
    again = eb.embedding_backward(order, g)
    ref = eb.embedding_backward_reference(order, g)
    sync(g.device)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(out.dtype == torch.float32
          and out.shape == (order.n_ids, g.shape[1]),
          f"{what}: output {out.dtype} {tuple(out.shape)}")
    check(torch.isfinite(out).all().item(), f"{what}: non-finite output")
    check(torch.equal(out, again), f"{what}: repeated call differs")
    check(err <= EMB_TOL * scale,
          f"{what}: max|diff| {err} > {EMB_TOL} * {scale}")
    check(torch.equal(out, ref), f"{what}: not bit-equal to the plain "
          f"version (max|diff| {err})")
    return dict(max_abs_err=err, max_abs_ref=scale, bit_equal_to_plain=True)


def embedding_record(order, ids, g, err: float, shape: str) -> dict:
    """The kernels-line record of the embedding backward on (ids, g):
    timed beside its plain version and index_add of g into a zero table
    (one PyTorch call of the same sum)."""
    zeros = torch.zeros(order.n_ids, g.shape[1], device=g.device)
    rec = kernel_record(
        "embedding_bwd", EMB_SOURCE, EMB_REPLACES, [],
        lambda v: eb.embedding_backward(order, v),
        lambda v: eb.embedding_backward_reference(order, v),
        lambda v: torch.index_add(zeros, 0, ids, v), g,
        embedding_bound_ms(order, g), err)
    rec.update(shape=shape, rows=order.n_rows, n_ids=order.n_ids,
               width=g.shape[1], partials=order.n_partials, launches=None)
    return rec


def phase_embedding_bwd(device) -> dict:
    """[embedding_bwd]: the fixed-order embedding backward
    (csrc/embedding_bwd.cu) against its plain version, bit-equal, f32 and
    bf16 cotangents of width 64, repeats bit-identical, at the em_user
    stand-in's 57,344 degree ids, the hpo stand-in's 14,587 (hpo_metab
    with --use_deg), 57,344 rows of one id (--use_one) and the ladder's
    largest rung's 2,293,760 ids over 16 values (tools/torch_max_scale.py's
    draw); each timed eager and cold beside its bound; then, untimed, at
    em_user's ids, the cotangents of EMB_OTHER_WIDTHS. Returns the em_user
    f32 kernels-line record (its launches: [train_graph]'s)."""
    ei, n = clustered_graph()
    em_ids = degree_features(ei, n)[:, 0]
    ei, hpo_n = hpo_graph()
    hpo_ids = degree_features(ei, hpo_n)[:, 0]
    del ei
    tool = load_tool("torch_max_scale")
    top_ids = tool.rung_inputs(N_COMM * LADDER_TOP * COMM_SIZE, 1)[0][:, 0]
    gen = torch.Generator(device=device).manual_seed(79)
    record = None
    for shape, ids_np, n_ids in (("em_user", em_ids, int(em_ids.max()) + 1),
                                 ("hpo", hpo_ids, int(hpo_ids.max()) + 1),
                                 ("one_id", np.zeros(n, np.int64), 1),
                                 (f"ladder_{LADDER_TOP}x", top_ids,
                                  tool.MAX_ID + 1)):
        ids = torch.from_numpy(ids_np).to(device)
        order = eb.embedding_order(ids, n_ids)
        for dtype in X_DTYPES:
            g = torch.randn(ids.shape[0], EM_USER["hidden_dim"], device=device,
                            generator=gen).to(dtype)
            what = f"embedding_bwd {shape} {dtype}"
            out = check_embedding(what, order, g)
            bound, by = embedding_bound_ms(order, g)
            emit("embedding_bwd", shape=shape, rows=order.n_rows,
                 n_ids=n_ids, slice_rows=order.slice_rows,
                 chunks=order.n_chunks, partials=order.n_partials,
                 g=str(dtype), **out,
                 ms=time_ms(lambda: eb.embedding_backward(order, g)),
                 device_ms=cold_ms(lambda: eb.embedding_backward(order, g)),
                 bound_ms=bound, bound_by=by)
            if shape == "em_user" and dtype == torch.float32:
                record = embedding_record(order, ids, g, out["max_abs_err"],
                                          shape)
        if shape == "em_user":
            for width, dtype in EMB_OTHER_WIDTHS:
                g = torch.randn(ids.shape[0], width, device=device,
                                generator=gen).to(dtype)
                out = check_embedding(f"embedding_bwd {shape} {dtype} "
                                      f"width {width}", order, g)
                emit("embedding_bwd", shape=shape, rows=order.n_rows,
                     n_ids=n_ids, width=width, g=str(dtype),
                     vector_columns=eb._vector_columns(g), **out)
        del order, ids
    return record


LADDER_RUNG = 4  # 229,376 nodes, 36M directed edges
LADDER_COMPARED_STEPS = 10
LADDER_DTYPES = ("int8", "f32")
# sha256 of rung 4's built graph (tools/torch_max_scale.py's layout_digests:
# the plan, the edge arrays, every layout tensor forward and transposed),
# as the build before its lean rewrite gave them on the card (that commit's
# tool, --scales 4 --digests): the lean build is held to them byte for byte
LADDER_CSR_SHA256 = (
    "1dbda80945c9602ef0e35c193568c2bb7e031fd63d79e233a8c470eb1e6730c8")
LADDER_DIGESTS = {
    dtype: dict(plan="bcsr", csr=LADDER_CSR_SHA256, band=None, band_t=None,
                bcsr=bcsr, bcsr_t=bcsr, dense_q=None, dense_q_t=None)
    for dtype, bcsr in (
        ("int8",
         "b427bf1e224e9e546a9556c842719975d5df8d6e07a36682fd7b354a97c592a5"),
        ("f32",
         "2f1c3ab3fed417e6b55340411cc81c141615b1eee2c391e9c3121c8076685763"))}


def phase_scale_ladder(device) -> list:
    """[scale_ladder]: one rung of tools/torch_max_scale.py's ladder, 4x
    em_user, built through build_graph (native CSR and fills, the
    planner's layout) in int8 slabs with bf16 activations and in f32, the
    host's peak resident bytes by build phase printed; the plan, the edge
    arrays and every layout tensor byte-equal to the build before its lean
    rewrite by their digests (LADDER_DIGESTS); on each, every SpMM kernel of the layout and of its transposed layout
    against its plain version on x in the rung's compute dtype (the
    tool's check_kernels, within KERNEL_TOL x max |plain|), then GLASS at em_user's width trained LADDER_COMPARED_STEPS steps
    eagerly and on the captured step from one seed: losses and parameters
    bit-equal, finite; one capture, the card's counters its count once a
    step both ways, the embedding backward once a step, check_replays;
    then the tool's own timed run (train_rung): losses finite and the
    last epoch's mean below the warm epoch's; the rung's record line.
    Returns the embedding backward's kernels-line record at the rung's
    ids (its launches: the graphed runs')."""
    tool = load_tool("torch_max_scale")
    t0 = time.perf_counter()
    ei, n = tool.clustered_graph(LADDER_RUNG)
    base = dict(scale=LADDER_RUNG, n_node=n, directed_edges=int(ei.shape[1]),
                generate_s=time.perf_counter() - t0, card=card_line())
    x_np, pos, y = tool.rung_inputs(n, tool.steps_for(LADDER_RUNG))
    x = torch.from_numpy(x_np).to(device)
    k = LADDER_COMPARED_STEPS
    emb_launches = 0
    for dtype in LADDER_DTYPES:
        what = f"scale_ladder {dtype}"
        _, compute = tool.DTYPES[dtype]
        graph, built = tool.build_rung(ei, n, dtype, EM_USER["hidden_dim"],
                                       device, digests=True)
        check(graph.band is not None or graph.bcsr is not None,
              f"{what}: the planner chose {graph.plan}")
        check(built["digests"] == LADDER_DIGESTS[dtype],
              f"{what}: the build differs from the pinned one: "
              f"{built['digests']} against {LADDER_DIGESTS[dtype]}")
        check(built["native"] and set(built["host_peak_by_phase"]) == set(
            tool.PHASES) - {"generate"},
              f"{what}: native {built['native']}, host peaks by phase "
              f"{built['host_peak_by_phase']}")
        kernels = tool.check_kernels(graph, EM_USER["hidden_dim"], device,
                                     compute)
        check(kernels["kernel_x_dtype"] == (compute or "float32")
              and kernels["kernel_rel_err"] <= KERNEL_TOL,
              f"{what}: the layout's kernels against their plain versions "
              f"{kernels}")
        runs = {}
        for graphed in (False, True):
            trainer = Trainer(tool.make_model(graph, EM_USER["hidden_dim"],
                                              compute, device),
                              graph, x, tool.train_config())
            trainer._graphed = graphed  # the eager loop: this comparison
            trainer.init(0)
            card_embedding(reset=True)
            with card_launches() as ran, EpochProbe() as probe:
                losses = trainer.train_epoch(pos[:k], y[:k]).step_losses
            runs[graphed] = (losses, trainer, probe, ran, card_embedding())
        (le, te, _, ran_e, emb_e), (lg, tr, probe, ran, emb_g) = (
            runs[False], runs[True])
        check(np.isfinite(lg).all() and np.array_equal(lg, le),
              f"{what}: graphed losses {lg} against eager {le}")
        state = te.model.state_dict()
        for key, v in tr.model.state_dict().items():
            check(torch.equal(v, state[key]), f"{what}: parameter {key} "
                  f"differs by {float((v - state[key]).abs().max())}")
        check(len(probe.captures) == 1 and probe.epochs[0]["captured"],
              f"{what}: {len(probe.captures)} captures")
        want = probe.captures[0]
        check(want == plan_launches(graph, 2),
              f"{what}: the capture counted {want}, a step is "
              f"{plan_launches(graph, 2)}")
        check(ran.card == ran_e.card == scaled_sum((k, want)),
              f"{what}: the card ran {ran.card} graphed, {ran_e.card} "
              f"eager, {want} a step")
        check(emb_g == emb_e == k, f"{what}: the card ran the embedding "
              f"backward {emb_g} times graphed, {emb_e} eager in {k} steps")
        per_step = check_replays(tr, what)
        emb_launches += emb_g
        del runs, te, tr, probe
        rec = tool.train_rung(graph, x_np, pos, y, EM_USER["hidden_dim"],
                              compute, device, base["directed_edges"])
        check(rec["graphed"] and np.isfinite(rec["losses"]).all()
              and np.isfinite(rec["last_epoch_losses"]).all(),
              f"{what}: losses not finite or the step not captured")
        warm = float(np.mean(rec["losses"][1:]))
        last = float(np.mean(rec["last_epoch_losses"]))
        check(last < warm, f"{what}: losses did not fall ({warm} -> {last})")
        emit("scale_ladder", **base, dtype=dtype,
             compute_dtype=compute or "float32", remat=False, **built,
             **kernels, **rec,
             compared_steps=k, bit_equal=True, per_step_launches=per_step,
             embedding_launches=emb_g)
        del graph
        gc.collect()  # the trainers and graph (reference cycles)
        torch.cuda.empty_cache()
    del ei
    order = eb.cached_order(x[:, 0], tool.MAX_ID + 1)
    g = torch.randn(n, EM_USER["hidden_dim"], device=device,
                    generator=torch.Generator(device=device).manual_seed(80))
    out = check_embedding("embedding_bwd ladder", order, g)
    record = embedding_record(order, x[:, 0], g, out["max_abs_err"],
                              f"ladder_{LADDER_RUNG}x")
    record["launches"] = emb_launches
    return [record]


REMAT_LAYERS = (1, 2)  # em_user's conv layers, and ppi_bp's
REMAT_STEPS, REMAT_TIMED = 3, 20  # the compared epoch; the timed one


def remat_training(graph, feats, max_deg: int, layers: int, order,
                   on: bool) -> dict:
    """em_user at ``layers`` conv layers (dropout 0.5, batch 6, lr 1e-3)
    on captured steps with GLASS_TPU_REMAT ``on`` or off: an epoch of
    REMAT_STEPS steps (the first eager, then the capture and replays) with
    the peak allocated bytes over it, then an epoch of REMAT_TIMED replays
    timed by the host clock (ending in its readback), under card_launches
    and an EpochProbe."""
    model = em_user_model(max_deg, "pallas", graph.device,
                          dropout=EM_USER["dropout"], layers=layers)
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=EM_USER["lr"], resi=EM_USER["resi"],
        batch_size=EM_USER["batch_size"], loss="bce"))
    trainer.init(0)
    rng = np.random.default_rng(77)
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS, N_COMM, COMM_SIZE)
    if order is not None:
        pos = relabel_pos(pos, order, graph.n_node)
    b = EM_USER["batch_size"]
    with card_launches() as ran, EpochProbe() as probe, remat(on):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pos_b, y_b = make_train_batches(rng, pos, y, b)
        losses = trainer.train_epoch(pos_b[:REMAT_STEPS],
                                     y_b[:REMAT_STEPS]).step_losses
        peak = torch.cuda.max_memory_allocated() - base
        pos_b, y_b = make_train_batches(rng, pos, y, b)
        t0 = time.perf_counter()
        res = trainer.train_epoch(pos_b[:REMAT_TIMED], y_b[:REMAT_TIMED])
        ms = (time.perf_counter() - t0) * 1e3 / REMAT_TIMED
    return dict(run=(losses, trainer, probe, ran), peak=peak, ms=ms,
                losses=losses, timed_loss=res.loss)


def embedding_spread(ids: torch.Tensor, width: int = 64,
                     repeats: int = 6) -> dict:
    """The gradient of an (ids.max() + 1, width) table over ``ids`` (on
    the card) for one cotangent, taken ``repeats`` times: the max
    |difference| from the first, by nn.Embedding's backward (PyTorch's
    default algorithm, and under ``deterministic``) and by the port's
    fixed-order backward (ops/embedding.py, the trunks' path) as the step
    runs it, by default."""
    import torch.nn.functional as F

    gen = torch.Generator(device=ids.device).manual_seed(78)
    w = torch.randn(int(ids.max()) + 1, width, device=ids.device,
                    generator=gen)
    g = torch.randn(ids.shape[0], width, device=ids.device, generator=gen)
    out = {}
    for name, det, lookup in (
            ("default", False, lambda t: F.embedding(ids, t)),
            ("deterministic", True, lambda t: F.embedding(ids, t)),
            ("fixed_order", False, lambda t: eb.embedding(t, ids))):
        grads = []
        with deterministic(det):
            for _ in range(repeats):
                ww = w.clone().requires_grad_(True)
                lookup(ww).backward(g)
                grads.append(ww.grad)
        out[name] = max(float((x - grads[0]).abs().max())
                        for x in grads[1:])
    return out


def phase_remat(device, routes: list) -> None:
    """[remat]: GLASS_TPU_REMAT on against off inside the captured step,
    em_user at 1 and 2 conv layers on each route phase_train_graph built
    (the default route, RCM and the planner's layout; the forced band
    with the fused norm), as the step runs by default (the fixed-order
    embedding backward makes it reproducible): losses over REMAT_STEPS
    steps and the parameters bit-equal, the card's launches held to the
    remat term (check_remat_run); the peak allocated bytes over the first
    epoch above the memory allocated before it and ms a step over
    REMAT_TIMED replays, on and off.
    Then on the small layouts of the families train_graph_small lacks
    (bf16 band, hybrid split; small_serve_cases), a remat run against its
    off run likewise. First, the spread of nn.Embedding's backward over
    the stand-in's degree ids, by default and deterministic, and of the
    fixed-order backward, 0 by default (embedding_spread)."""
    spread = embedding_spread(routes[0][2][:, 0])
    emit("remat_embedding_spread", card=card_line(),
         ids=int(routes[0][2].shape[0]), max_abs_grad_diff=spread)
    check(spread["deterministic"] == 0.0 and spread["fixed_order"] == 0.0,
          f"remat: the deterministic or fixed-order embedding backward "
          f"spreads {spread}")
    for route, graph, feats, max_deg, order, fused in routes:
        for layers in REMAT_LAYERS:
            runs = {}
            with fused_norm(fused):
                for on in (False, True):
                    runs[on] = remat_training(graph, feats, max_deg, layers,
                                              order, on)
                out = check_remat_run(f"remat {route} {layers}",
                                      runs[False]["run"], runs[True]["run"])
            emit("remat", route=route, card=card_line(), conv_layers=layers,
                 fused_norm=fused, steps=REMAT_STEPS,
                 per_step_launches_off=runs[False]["run"][2].captures[0],
                 per_step_launches_on=out["remat_per_step_launches"],
                 losses=runs[True]["losses"].tolist(), bit_equal=True,
                 peak_allocated_bytes_off=runs[False]["peak"],
                 peak_allocated_bytes_on=runs[True]["peak"],
                 ms_per_step_off=runs[False]["ms"],
                 ms_per_step_on=runs[True]["ms"])
            del runs
    for name, graph, mode, compute, fused in small_serve_cases(device):
        if name not in ("band_bf16", "hybrid_f32"):
            continue
        rng = np.random.default_rng(63)
        pos, y = class_labelled_subgraphs(rng, GRAPH_SMALL_SUBGRAPHS,
                                          graph.n_node, 2)
        feats = torch.from_numpy(rng.integers(0, 6, (graph.n_node, 1))).to(
            device)
        runs = {}
        for on in (False, True):
            model = GLASS(5, 16, 2, (1,), ("size",), dropout=0.5,
                          spmm_mode=mode, compute_dtype=compute, seed=0,
                          device=device)
            trainer = Trainer(model, graph, feats, TrainConfig(
                lr=EM_USER["lr"], batch_size=6, loss="bce"))
            trainer.init(1)
            with card_launches() as ran, EpochProbe() as probe, remat(on):
                losses = trainer.train_epoch(*make_train_batches(
                    np.random.default_rng(62), pos, y.astype(np.float32),
                    6)).step_losses
            runs[on] = (losses, trainer, probe, ran)
        out = check_remat_run(f"remat {name}", runs[False], runs[True])
        emit("remat_small", case=name, n_node=graph.n_node,
             compute_dtype=compute or "float32", steps=len(runs[True][0]),
             per_step_launches_off=runs[False][2].captures[0], **out)


# ----------------------------------------- captured inference programs

# every (batch, width) bucket of Predictor's defaults
SERVE_BUCKETS = [(b, w) for b in (1, 8, 64, 256) for w in (16, 64, 256)]
SERVE_SMALL_LAYERS = 2
REQUEST_TIMED = 20  # requests timed a batch size, graphed and eager
EVAL_TIMED = 20  # evaluations timed a split, graphed and eager
PROFILED_CALLS = 5  # requests or evaluations under the profiler
EVAL_SPLIT = 60  # the stand-in's val and test splits (CLI_SUBGRAPHS)


def bucket_request(rng, b: int, w: int, n: int) -> list:
    """``b`` subgraphs of 1..w of the n nodes, the first of w: the request
    lands in bucket (b, w)."""
    sizes = [w] + rng.integers(1, w + 1, b - 1).tolist()
    return [rng.choice(n, k, replace=False).tolist() for k in sizes]


def forward_launches(graph, model, fused: bool, norm_dtype="float32"):
    """One GLASS forward's launches on ``graph``'s layout (plan_launches):
    one SpMM a conv layer; with the fused norm K1-K3 once a GraphNorm."""
    norms, convs = model_counts(model)
    norm = counts_form(norm={k: norms for k in ("colsum", "varsum",
                                                "affine")} if fused
                       else None, norm_dtype=norm_dtype)
    return scaled_sum((1, plan_launches(graph, convs)), (1, norm))


def small_serve_cases(device) -> list:
    """(name, graph, SpMM mode, compute dtype, fused norm) on small layouts
    of every kernel family a forward reaches: the int8 dense layout of the
    kernel_q_small phase, and on train_graph_small's 1,024-node graph
    ("gcn", symmetric) BCSR f32 and int8, band f32, bf16 and int8, a
    hybrid split (400 far edges between its first and last communities)
    and the band f32 with the fused norm."""
    ei, n = clustered_graph(8, BLOCK, 3000, seed=6)
    rng = np.random.default_rng(66)
    src = rng.integers(0, BLOCK, 200)
    dst = 7 * BLOCK + rng.integers(0, BLOCK, 200)
    far = np.concatenate([ei, np.stack([np.r_[src, dst], np.r_[dst, src]])],
                         axis=1)

    def sym(edges, layout, dense_dtype="f32"):
        return build_graph(edges, None, n, "gcn", materialize_dense=False,
                           materialize_bcsr=True, sparse_layout=layout,
                           dense_dtype=dense_dtype, device=device)

    hybrid = sym(far, "hybrid")
    check(hybrid.band is not None and hybrid.bcsr is not None,
          "the small hybrid graph lacks its band or its BCSR residue")
    return [("dense_q_int8", dense_q_graph(device), "dense", None, False),
            ("bcsr_f32", sym(ei, "bcsr"), "pallas", None, False),
            ("bcsr_int8", sym(ei, "bcsr", "int8"), "pallas", None, False),
            ("band_f32", sym(ei, "band"), "pallas", None, False),
            ("band_bf16", sym(ei, "band", "bf16"), "pallas", "bfloat16",
             False),
            ("band_int8", sym(ei, "band", "int8"), "pallas", "bfloat16",
             False),
            ("hybrid_f32", hybrid, "pallas", None, False),
            ("band_f32_fused_norm", sym(ei, "band"), "pallas", None, True)]


def phase_serve_graph_small(device) -> None:
    """[serve_graph_small]: on small layouts of every kernel family
    (small_serve_cases), a request in every bucket of SERVE_BUCKETS served
    through Predictor's captured programs and again eagerly
    (``Predictor._graphed`` cleared): one program a bucket, each capture
    counting one forward's launches, the card's counters equal to the
    captures' counts times (1 + replays), the replay bit-identical to the
    bucket's first (eager) call, the graphed logits bit-equal to the
    eager ones; with the fused norm, the tickets of the predictor's
    stream 0 after the replays."""
    for name, graph, mode, compute, fused in small_serve_cases(device):
        rng = np.random.default_rng(67)
        model = GLASS(5, EM_USER["hidden_dim"], SERVE_SMALL_LAYERS, (1,),
                      ("size",), activation="elu", z_ratio=0.75, jk=True,
                      spmm_mode=mode, compute_dtype=compute, seed=0,
                      device=device)
        feats = torch.from_numpy(rng.integers(0, 6, (graph.n_node, 1))).to(
            device)
        pred = Predictor(model, graph, feats, device=device)
        reqs = {bw: bucket_request(rng, *bw, graph.n_node)
                for bw in SERVE_BUCKETS}
        per_call = forward_launches(
            graph, model, fused, "bfloat16" if compute else "float32")
        with fused_norm(fused):
            probe = ProgramProbe()
            with card_launches(probe) as ran, probe:
                graphed = {bw: (pred(r), pred(r)) for bw, r in reqs.items()}
            check(sorted(pred._programs.programs) == sorted(SERVE_BUCKETS)
                  and len(probe.programs) == len(SERVE_BUCKETS),
                  f"{name}: programs {sorted(pred._programs.programs)}")
            check_served(name, ran, probe, per_call)
            check_tickets(pred, per_call, name)
            pred._graphed = False  # the eager path: this comparison only
            with card_launches() as ran_e:
                eager = {bw: pred(r) for bw, r in reqs.items()}
        check(ran_e.card == ran_e.counted
              == scaled_sum((len(reqs), per_call)),
              f"{name}: eager, the card ran {ran_e.card}, the wrappers "
              f"counted {ran_e.counted}, {per_call} a request expected")
        for (b, w), (out, again) in graphed.items():
            check(out.shape == (b, 1) and np.isfinite(out).all(),
                  f"{name} ({b}, {w}): logits {out.shape}")
            check(np.array_equal(out, again),
                  f"{name} ({b}, {w}): the replay differs from the first call")
            check(np.array_equal(out, eager[(b, w)]),
                  f"{name} ({b}, {w}): graphed logits differ from eager, max "
                  f"|diff| {float(np.abs(out - eager[(b, w)]).max())}")
        emit("serve_graph_small", case=name, n_node=graph.n_node,
             spmm_mode=mode, compute_dtype=compute or "float32",
             fused_norm=fused, buckets=len(reqs), per_request=per_call,
             card_launches=ran.card,
             max_abs_logit=max(float(np.abs(o).max())
                               for o, _ in graphed.values()))
        del pred, model, graph


def device_ms_per_call(calls: int, fn) -> float:
    """Device ms a call of ``calls`` calls of ``fn`` under torch.profiler
    (the card's kernels and copies, summed)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3 / calls


def host_ms(fn) -> tuple:
    """(fn(), host ms of the call)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def phase_request_graph(what: str, pred, make, per_call: dict) -> list:
    """[request_graph]: REQUEST_TIMED requests of each of REQUEST_BATCHES
    subgraphs (``make(rng, b)``) through ``pred``, graphed and eagerly
    (``_graphed`` cleared): host ms by request (each ends in reading its
    logits back), median; device ms a request (the profiler over
    PROFILED_CALLS graphed requests) and the idle share both ways; the
    card's reserved memory that each bucket's capture adds, the cache
    emptied before its first call and after the capture (the graph
    pool's growth: the predictor's programs share one pool). The graphed
    logits bit-equal to the eager ones, the card's counters those of the
    captures times (1 + replays), and the eager path's per_call a
    request."""
    t0 = time.perf_counter()
    device = pred.device
    rng = np.random.default_rng(68)
    rows = []
    for b in REQUEST_BATCHES:
        reqs = [make(rng, b) for _ in range(REQUEST_TIMED)]
        reserved = []
        probe = ProgramProbe()
        with card_launches(probe) as ran, probe:
            for r in reqs:  # each bucket's first call captures
                torch.cuda.empty_cache()
                before, n_prog = (torch.cuda.memory_reserved(device),
                                  len(probe.programs))
                pred(r)
                if len(probe.programs) > n_prog:
                    torch.cuda.empty_cache()  # the eager call's blocks
                    reserved.append(torch.cuda.memory_reserved(device)
                                    - before)
            graphed = [host_ms(lambda: pred(r)) for r in reqs]
            device_ms = device_ms_per_call(
                PROFILED_CALLS, lambda: pred(reqs[0]))
        check_served(f"{what} batch {b}", ran, probe, per_call)
        check_tickets(pred, per_call, f"{what} batch {b}")
        pred._graphed = False  # the eager path: this comparison only
        with card_launches() as ran_e:
            for r in reqs:
                pred(r)
            eager = [host_ms(lambda: pred(r)) for r in reqs]
        pred._graphed = True
        check(ran_e.card == scaled_sum((2 * len(reqs), per_call)),
              f"{what} batch {b}: eager, the card ran {ran_e.card}")
        for (g, _), (e, _) in zip(graphed, eager):
            check(g.shape[0] == b and np.isfinite(g).all()
                  and np.array_equal(g, e),
                  f"{what} batch {b}: graphed logits differ from eager")
        g_ms = statistics.median(ms for _, ms in graphed)
        e_ms = statistics.median(ms for _, ms in eager)
        rows.append(dict(
            batch=b, buckets=sorted({pred_bucket(pred, r) for r in reqs}),
            graphed_host_ms=g_ms, eager_host_ms=e_ms,
            graphed_host_ms_max=max(ms for _, ms in graphed),
            eager_host_ms_max=max(ms for _, ms in eager),
            device_ms=device_ms, graphed_idle_share=1 - device_ms / g_ms,
            eager_idle_share=1 - device_ms / e_ms, host_speedup=e_ms / g_ms,
            reserved_bytes_per_capture=reserved))
    emit("request_graph", route=what, card=card_line(),
         per_request=per_call, requests=rows,
         seconds=time.perf_counter() - t0)
    return rows


def phase_eval_graph(what: str, trainer, splits: dict,
                     per_forward: dict) -> list:
    """[eval_graph]: one evaluation of each split of ``splits`` (name ->
    (pos, y)) at the trainer's batch size, as the protocol draws it
    (make_eval_batches with an rng, the last batch padded), graphed and
    eagerly (``Trainer._graphed`` cleared): evaluate_score's host ms
    (ending in its (3,) readback), median of EVAL_TIMED, and its device ms
    (the profiler over PROFILED_CALLS graphed calls); evaluate's logits
    bit-equal both ways, the device F1 counts and the scores equal; one
    program a kind and shape, each capture nb forwards' launches, the
    card's counters those of the captures times (1 + replays); with the
    fused norm, the tickets of the trainer's stream 0."""
    t0 = time.perf_counter()
    bsz = trainer.cfg.batch_size
    rng = np.random.default_rng(69)
    rows, shapes = [], set()
    progs = trainer._eval_programs.programs
    n_progs = len(progs)
    for split, (pos, y) in splits.items():
        b, y_p, n_real = make_eval_batches(pos, y, bsz, rng)
        y_pad, mask = pad_eval_labels(y_p, b.shape[0], bsz)
        nb = b.shape[0]
        shapes.add(b.shape)  # splits of one shape share its programs

        def score():
            return trainer.evaluate_score(b, y_pad, mask)

        def counts():
            return trainer._eval_program(
                trainer._batch_counts,
                *map(trainer._to_device, (b, y_pad, mask))).cpu().numpy()

        runs = {}
        for graphed in (True, False):
            trainer._graphed = graphed  # False: this comparison only
            probe = ProgramProbe()
            with card_launches(probe) as ran, probe:
                first, first_ms = host_ms(score)
                logits, c = trainer.evaluate(b, n_real), counts()
                ms = [host_ms(score)[1] for _ in range(EVAL_TIMED)]
                device_ms = (device_ms_per_call(PROFILED_CALLS, score)
                             if graphed else None)
            calls = 3 + EVAL_TIMED + (PROFILED_CALLS if graphed else 0)
            check(ran.card == scaled_sum((calls * nb, per_forward)),
                  f"{what} {split}: the card ran {ran.card} in {calls} "
                  f"evaluations of {nb} batches, {per_forward} a forward")
            if graphed:
                check(len(progs) == n_progs + 2 * len(shapes),
                      f"{what} {split}: {len(progs)} eval programs for "
                      f"{len(shapes)} shapes")
                check_served(f"{what} {split}", ran, probe,
                             scaled_sum((nb, per_forward)))
                check_tickets(trainer, per_forward, f"{what} {split}")
            else:
                check(ran.card == ran.counted, f"{what} {split}: eager, "
                      f"the wrappers counted {ran.counted}")
            runs[graphed] = dict(score=first, logits=logits, counts=c,
                                 first_ms=first_ms,
                                 host_ms=statistics.median(ms),
                                 device_ms=device_ms)
        trainer._graphed = True
        g, e = runs[True], runs[False]
        check(np.isfinite(g["logits"]).all()
              and np.array_equal(g["logits"], e["logits"]),
              f"{what} {split}: graphed logits differ from eager")
        check(np.array_equal(g["counts"], e["counts"])
              and g["score"] == e["score"],
              f"{what} {split}: counts {g['counts']} vs {e['counts']}")
        rows.append(dict(
            split=split, subgraphs=n_real, batches=nb, width=b.shape[2],
            micro_f1=g["score"], counts=g["counts"].tolist(),
            graphed_host_ms=g["host_ms"], eager_host_ms=e["host_ms"],
            graphed_first_ms=g["first_ms"], device_ms=g["device_ms"],
            graphed_idle_share=1 - g["device_ms"] / g["host_ms"],
            eager_idle_share=1 - g["device_ms"] / e["host_ms"],
            host_speedup=e["host_ms"] / g["host_ms"]))
    emit("eval_graph", route=what, card=card_line(), per_forward=per_forward,
         evaluations=rows, seconds=time.perf_counter() - t0)
    return rows


def predict_cli(data_root: Path, ckpt: Path, trainer) -> None:
    """[predict_cli]: ``python -m glass_tpu_torch.cli.glass_predict`` on the
    em_user stand-in with the checkpoint of the CLI's fused run, on the
    test split and on a --subgraphs TSV: one row per subgraph, original
    ids (restored through the RCM order), logits equal to Trainer.evaluate
    of ``trainer`` (the CLI's default-route run: the same RCM graph and
    layout) with the checkpoint loaded, within rtol 1e-5 (6 digits
    printed); the two processes run side by side, ``seconds`` their
    common wall time."""
    from glass_tpu_torch.data.loaders import load_dataset
    from glass_tpu_torch.train.protocol import apply_feature
    from glass_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  params_from_flax)

    base = load_dataset("em_user", np.random.default_rng(0), str(data_root))
    apply_feature(base, "deg")
    perm = native.rcm_ordering(base.edge_index, base.n_node)
    params_from_flax(trainer.model, load_checkpoint(ckpt))
    split_pos, _ = base.get_split("test")
    tsv_pos = np.full((25, 250), -1, np.int64)
    for i, s in enumerate(make_request(np.random.default_rng(65), 25,
                                       N_COMM, COMM_SIZE)):
        tsv_pos[i, :len(s)] = s
    cmd = [sys.executable, "-m", "glass_tpu_torch.cli.glass_predict",
           "--dataset", "em_user", "--use_deg", "--use_maxzeroone",
           "--data_root", str(data_root), "--ckpt", str(ckpt), "--logits"]
    with tempfile.TemporaryDirectory(prefix="glass_predict_") as tmp:
        tsv = Path(tmp) / "subgraphs.tsv"
        tsv.write_text("".join("-".join(map(str, row[row >= 0])) + "\tx\n"
                               for row in tsv_pos))
        runs = {"split": (cmd + ["--split", "test"], split_pos),
                "subgraphs": (cmd + ["--subgraphs", str(tsv)], tsv_pos)}
        # both processes at once: each spends its time on the host
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=Path(__file__).resolve().parent)
            for name, (argv, _) in runs.items()}
        try:
            outs = {name: proc.communicate(timeout=900)
                    for name, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        seconds = time.perf_counter() - t0
        for name, (_, pos) in runs.items():
            stdout, stderr = outs[name]
            check(procs[name].returncode == 0,
                  f"glass_predict {name}: exit {procs[name].returncode}\n"
                  f"{stderr[-3000:]}")
            rows = [line.split("\t") for line in stdout.splitlines()]
            check(len(rows) == len(pos), f"glass_predict {name}: "
                  f"{len(rows)} rows for {len(pos)} subgraphs")
            ids = ["-".join(map(str, row[row >= 0])) for row in pos]
            check([r[1] for r in rows] == ids,
                  f"glass_predict {name}: node ids are not the input's")
            got = np.array([float(r[3]) for r in rows])
            b, _, n_real = make_eval_batches(
                relabel_pos(pos, perm, base.n_node),
                np.zeros(len(pos), np.float32), EM_USER["batch_size"])
            ref = trainer.evaluate(b, n_real)[:, 0]
            check(np.isfinite(got).all() and np.allclose(got, ref,
                                                          rtol=1e-5, atol=0),
                  f"glass_predict {name}: logits vs Trainer.evaluate, max "
                  f"|diff| {float(np.abs(got - ref).max())}")
            check(all(r[2] == str(int(v > 0)) for r, v in zip(rows, got)),
                  f"glass_predict {name}: predictions are not the logits' "
                  "signs")
            emit("predict_cli", source=name, rows=len(rows), seconds=seconds,
                 card=card_line(),
                 max_abs_diff_vs_evaluate=float(np.abs(got - ref).max()),
                 max_abs_logit=float(np.abs(ref).max()),
                 stderr_tail=stderr.strip().splitlines()[-1:])


# ---------------------------------------- SSL pretraining (the gnn_emb path)

# glass_tpu_torch/train/ssl.py::SSLConfig's defaults on the "pallas" route
SSL = dict(hidden_dim=64, conv_layer=3, dropout=0.3, aggr="mean",
           batch_size=131072, batches_per_epoch=10, spmm_mode="pallas")
SSL_EPOCHS = 6  # epochs 0 and 5 evaluate
SSL_LAUNCH_EPOCH, SSL_PROFILED_EPOCH = 1, 2  # per-step counts; device time
# the eager comparison: 3 epochs (epoch 0 evaluates), epoch 1 profiled,
# epoch 2 timed
SSL_EAGER_EPOCHS, SSL_EAGER_PROFILED = 3, 1
SSL_FIRST_LOSS_RTOL = 1e-4  # "segment" against the planned kernels
SSL_CLI_TRIALS, SSL_GLASS_EPOCHS = 1, 3
SSL_TRIAL_LINE = re.compile(r"trial (\d+): (\{.*\}) -> (\S+)$")
SSL_TOP_KERNELS = 8


class SSLProbe:
    """Wraps glass_tpu_torch.train.ssl's build_graph and plateau_step and
    BaseGraphData.get_lp_dataset while a pretrain_once run lasts, with a
    StepProbe and a ProgramProbe over its captured step and its node-table
    and validation programs: the graph built and the seconds of its build
    and plan, get_lp_dataset's seconds, and each training step's loss and
    host clock (plateau_step is called once a batch, after the loss is
    read back). Over the steps of epoch ``launch_epoch`` it reads the
    launches the card ran between two steps (card_counts: one step's);
    over those of ``profiled_epoch`` it runs torch.profiler (the steps
    after its first; stopped before the last step's clock is read, so the
    next epoch's span holds no profiler). ``cache`` (a dict shared by the
    probes of one phase) keeps get_lp_dataset's result by its base and rng
    state, and build_graph's by its arguments: a later run of the same
    seed on the same base takes them, the rng moved on to the state the
    first call left, instead of sampling the 18M pairs and building the
    layout again."""

    def __init__(self, steps_per_epoch: int, cache: dict,
                 launch_epoch: int = SSL_LAUNCH_EPOCH,
                 profiled_epoch: int = SSL_PROFILED_EPOCH):
        self.per_epoch = steps_per_epoch
        self.cache = cache
        self.launch_epoch, self.profiled_epoch = launch_epoch, profiled_epoch
        self.graphs, self.build_s, self.lp_s = [], [], []
        self.losses, self.clock, self.step_launches = [], [], []
        self.steps, self.programs = StepProbe(), ProgramProbe()
        self.prof = None

    def __enter__(self):
        from glass_tpu_torch.data.basegraph import BaseGraphData
        from glass_tpu_torch.train import ssl

        self._real = (ssl.build_graph, ssl.plateau_step,
                      BaseGraphData.get_lp_dataset)
        real_build, real_step, real_lp = self._real

        def build(*a, **kw):
            key = ("graph", tuple(map(id, a[:2])), a[2:],
                   tuple(sorted((k, str(v)) for k, v in kw.items())))
            if key not in self.cache:
                t0 = time.perf_counter()
                self.cache[key] = real_build(*a, **kw)
                sync(self.cache[key].device)
                self.build_s.append(time.perf_counter() - t0)
            self.graphs.append(self.cache[key])
            return self.cache[key]

        def get_lp_dataset(base, rng, use_loop=False):
            key = (id(base), json.dumps(rng.bit_generator.state), use_loop)
            if key in self.cache:
                out, state = self.cache[key]
                rng.bit_generator.state = state
                return out
            t0 = time.perf_counter()
            out = real_lp(base, rng, use_loop)
            self.lp_s.append(time.perf_counter() - t0)
            self.cache[key] = out, rng.bit_generator.state
            return out

        def plateau_step(state, loss, **kw):
            epoch, i = divmod(len(self.losses), self.per_epoch)
            if epoch == self.profiled_epoch and i == self.per_epoch - 1:
                torch.cuda.synchronize()
                self.prof.stop()
            self.clock.append(time.perf_counter())
            self.losses.append(float(loss))
            if epoch == self.launch_epoch:
                self.step_launches.append(card_counts())
            if epoch == self.profiled_epoch and i == 0:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
            return real_step(state, loss, **kw)

        ssl.build_graph, ssl.plateau_step = build, plateau_step
        BaseGraphData.get_lp_dataset = get_lp_dataset
        self.steps.__enter__()
        self.programs.__enter__()
        return self

    def __exit__(self, *exc):
        from glass_tpu_torch.data.basegraph import BaseGraphData
        from glass_tpu_torch.train import ssl

        self.programs.__exit__(*exc)
        self.steps.__exit__(*exc)
        (ssl.build_graph, ssl.plateau_step,
         BaseGraphData.get_lp_dataset) = self._real

    def per_step_launches(self) -> list:
        """The card's launches of each step of the launch epoch but its
        first (the difference of two reads, one step apart)."""
        c = self.step_launches
        return [scaled_sum((1, b), (-1, a)) for a, b in zip(c, c[1:])]

    def host_ms_per_step(self, epochs) -> float:
        """The median host ms between two steps of one epoch, over
        ``epochs`` (the first step of an epoch follows the epoch's shuffle
        and an eval, and is left out)."""
        n = self.per_epoch
        return statistics.median(
            (self.clock[k] - self.clock[k - 1]) * 1e3
            for e in epochs for k in range(e * n + 1, (e + 1) * n))

    def epoch_s(self, epochs) -> float:
        """The median seconds of the ``epochs`` (each after an epoch that
        did not evaluate): from the last step of the epoch before to the
        last of its own, the numpy shuffle of the training pairs and the
        copy of the order the epoch uses included."""
        n = self.per_epoch
        return statistics.median(self.clock[(e + 1) * n - 1]
                                 - self.clock[e * n - 1] for e in epochs)

    def device_ms_per_step(self) -> tuple:
        """The profiled steps' device time (this repo's kernels and
        PyTorch's) per step, and the SSL_TOP_KERNELS largest parts of it
        by kernel name (ms per step)."""
        kernels = [e for e in self.prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)]
        steps = self.per_epoch - 1
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        return (sum(e.self_device_time_total for e in kernels) / 1e3 / steps,
                {e.key[:80]: e.self_device_time_total / 1e3 / steps
                 for e in top[:SSL_TOP_KERNELS]})

    def host_ops_per_step(self) -> dict:
        """The host's side of the same profiled steps: the wall ms per step
        by the host clock (profiler on), the self CPU ms per step inside
        PyTorch's ops and the part outside them (the Python between ops),
        the kernels launched per step, and the SSL_TOP_KERNELS largest ops
        by self CPU ms per step."""
        events = self.prof.key_averages()
        ops = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.self_cpu_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
        kernels = sum(e.count for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and not getattr(e, "is_user_annotation", False))
        steps = self.per_epoch - 1
        first = self.profiled_epoch * self.per_epoch
        wall = (self.clock[first + steps - 1] - self.clock[first]) * 1e3 / (
            steps - 1)
        in_ops = sum(e.self_cpu_time_total for e in ops) / 1e3 / steps
        top = sorted(ops, key=lambda e: -e.self_cpu_time_total)
        return {"wall_ms": wall, "in_ops_ms": in_ops,
                "outside_ops_ms": wall - in_ops,
                "kernels_per_step": kernels / steps,
                "top_ops_ms": {e.key[:80]: e.self_cpu_time_total / 1e3 / steps
                               for e in top[:SSL_TOP_KERNELS]}}


def ssl_layout_record(graph, x, card: dict, per_step: int) -> list:
    """Kernels-line records of the layout the planner gave the SSL graph:
    each kernel (band, BCSR) against its plain version at the path's shape
    (the forward layout; check_planned holds the transposed one), timed
    beside torch.sparse.mm of the adjacency and its bound; its launches
    those the card ran on the path (``card``, card_counts' form)."""
    adj = csr_adjacency(graph)
    out = []
    if graph.band is not None:
        band = graph.band
        affine = band.affine_stride is not None
        err, _ = check_vs_plain("ssl band", lambda v: bd.band_spmm(band, v),
                                lambda v: bd.band_spmm_reference(band, v), x)
        rec = kernel_record(
            "band_spmm_ssl", "glass_tpu_torch/csrc/band_spmm.cu",
            BAND_TPU[0 if affine else 1].split()[0],
            BAND_TPU[:1] if affine else BAND_TPU[1:],
            lambda v: bd.band_spmm(band, v),
            lambda v: bd.band_spmm_reference(band, v),
            lambda v: torch.sparse.mm(adj, v), x, band_bound_ms(band, x), err)
        out.append(rec)
    if graph.bcsr is not None:
        bcsr = graph.bcsr
        err, _ = check_vs_plain("ssl bcsr", lambda v: bs.bcsr_spmm(bcsr, v),
                                lambda v: bs.bcsr_spmm_reference(bcsr, v), x)
        out.append(kernel_record(
            "bcsr_spmm_ssl", "glass_tpu_torch/csrc/bcsr_spmm.cu",
            "glass_tpu/ops/pallas_spmm.py:411",
            ["glass_tpu/ops/pallas_spmm.py:321 _bcsr_chunk_kernel",
             "glass_tpu/ops/pallas_spmm.py:411 _bcsr_chunk_kernel_large"],
            lambda v: bs.bcsr_spmm(bcsr, v),
            lambda v: bs.bcsr_spmm_reference(bcsr, v),
            lambda v: torch.sparse.mm(adj, v), x, bound_ms(bcsr, x), err))
    for rec in out:
        kind = rec["name"].split("_")[0]
        rec["launches"] = sum(card[kind].values())
        rec["launches_per_step"] = per_step
    del adj
    return out


def ssl_run(base, cfg, init_state, cache: dict, graphed: bool = True,
            **probe_kw) -> tuple:
    """pretrain_once(cfg, base, seed 0) from ``init_state`` under an
    SSLProbe (sharing ``cache``; ``probe_kw`` its epochs) and
    card_launches, captured or, with ``graphed`` False, eager: (probe,
    Launches, best score, table, seconds, log lines)."""
    from glass_tpu_torch.train import ssl

    lines = []
    with card_launches() as ran, SSLProbe(cfg.batches_per_epoch, cache,
                                          **probe_kw) as probe:
        t0 = time.perf_counter()
        score, table = ssl.pretrain_once(cfg, base, 0, log=lines.append,
                                         init_state=init_state,
                                         _graphed=graphed)
        seconds = time.perf_counter() - t0
    return probe, ran, score, table, seconds, lines


def check_ssl_captures(what: str, probe: SSLProbe, ran: Launches,
                       per_step: dict, per_fwd: dict) -> dict:
    """A captured pretrain_once run: one step capture counting
    ``per_step``, replayed every step after the first; the node-table and
    validation programs captured once each, counting ``per_fwd`` (one
    trunk forward's launches; the head runs none of this repo's kernels);
    the card ran each capture's count times (1 + its replays), and nothing
    else. Returns the counts."""
    steps = len(probe.losses)
    caps = probe.steps.programs
    check(len(caps) == 1 and caps[0].counts == per_step,
          f"{what}: step captures counted {[c.counts for c in caps]}, a "
          f"step is {per_step}")
    check(probe.steps.replayed() == steps - 1,
          f"{what}: {probe.steps.replayed()} replays in {steps} steps")
    progs = probe.programs.programs
    check(len(progs) == 2 and all(p.counts == per_fwd for p in progs),
          f"{what}: programs counted {[p.counts for p in progs]}, a trunk "
          f"forward is {per_fwd}")
    want = scaled_sum((1, probe.steps.want()), (1, probe.programs.want()))
    check(ran.card == want, f"{what}: the card ran {ran.card}, the captures' "
          f"counts times (1 + replays) are {want}")
    return dict(step_captures=len(caps), step_replays=probe.steps.replayed(),
                programs=len(progs), program_replays=probe.programs.replayed())


def phase_ssl_em_user(device, data_root: Path) -> list:
    """[ssl_em_user]: pretrain_once at SSLConfig's defaults (hidden 64, 3
    conv layers, dropout 0.3, "mean", 131,072-pair batches, 10 an epoch)
    on the "pallas" route, nodeid feature, on the em_user stand-in, for
    SSL_EPOCHS epochs on its captured step and programs: the planned
    layout and each of its kernels against the plain version at the path's
    shape; the step's capture 2 SpMM launches per conv layer, each program's
    1 per conv layer, the card's counters those of the captures times (1 +
    replays), one step's read between two steps; finite, falling losses;
    the host and device ms per step, the idle share, an epoch's seconds and
    the peak allocated memory. Then the same seed and initial state for
    SSL_EAGER_EPOCHS epochs eagerly (_graphed cleared), twice, and
    captured: the eager repeats' spread of losses and best table, 0, and
    the captured run held to the eager one within it (bit-equal). Then the first loss against the same step on "segment",
    and one epoch with the fused norm, K1-K5 once per GraphNorm and step.
    Every run after the first takes its pair set and graph
    (SSLProbe's cache). Returns the planned kernels' records."""
    from glass_tpu_torch.data.loaders import load_dataset
    from glass_tpu_torch.nn.pretrain import EdgeGNN
    from glass_tpu_torch.train import ssl
    from glass_tpu_torch.train.protocol import apply_feature

    base = load_dataset("em_user", np.random.default_rng(0), str(data_root))
    apply_feature(base, "nodeid")
    cfg = ssl.SSLConfig(dataset="em_user", max_epochs=SSL_EPOCHS,
                        device=device.type, **SSL)
    layers = cfg.conv_layer
    init = EdgeGNN(base.max_deg, cfg.hidden_dim, layers, dropout=cfg.dropout,
                   spmm_mode=cfg.spmm_mode, device="cpu").state_dict()
    cache = {}
    torch.cuda.reset_peak_memory_stats()
    with fused_norm(False):
        probe, ran, score, table, seconds, lines = ssl_run(base, cfg, init,
                                                           cache)
    peak = torch.cuda.max_memory_allocated()
    graph = probe.graphs[0]
    check(graph.plan == held_kind(graph) and graph.plan not in
          ("dense", "segment"), f"ssl: the planner chose {graph.plan}")
    steps = len(probe.losses)
    n_b = cfg.batches_per_epoch
    check(steps == SSL_EPOCHS * n_b,
          f"ssl: {steps} steps in {SSL_EPOCHS} epochs")
    per_step = plan_launches(graph, 2 * layers)
    for i, c in enumerate(probe.per_step_launches()):
        check(c == per_step, f"ssl: step {i} of epoch {SSL_LAUNCH_EPOCH} "
              f"ran {c}, a step is {per_step}")
    captures = check_ssl_captures("ssl", probe, ran, per_step,
                                  plan_launches(graph, layers))
    losses = np.asarray(probe.losses)
    check(np.isfinite(losses).all() and np.isfinite(table).all()
          and table.shape == (base.n_node, cfg.hidden_dim),
          f"ssl: losses or table {table.shape} not finite")
    check(losses[-n_b:].mean() < losses[:n_b].mean(),
          f"ssl: losses did not fall ({losses[:n_b].mean()} -> "
          f"{losses[-n_b:].mean()})")
    x = torch.randn(graph.n_node, cfg.hidden_dim,
                    generator=torch.Generator().manual_seed(71)).to(device)
    errs = check_planned("ssl", graph, x)
    records = ssl_layout_record(graph, x, ran.card, 2 * layers)
    del x
    host_ms = probe.host_ms_per_step(range(SSL_PROFILED_EPOCH + 1,
                                           SSL_EPOCHS))
    device_ms, top = probe.device_ms_per_step()
    emit("ssl_em_user", card=card_line(), n_node=base.n_node,
         directed_edges=graph.n_edge, pairs_per_batch=cfg.batch_size,
         conv_layers=layers, hidden=cfg.hidden_dim, aggr=cfg.aggr,
         **plan_summary(graph), max_abs_err=errs, steps=steps,
         launches_per_step=per_step, **captures,
         run_launches=ran.card, host_ms_per_step=host_ms,
         device_ms_per_step=device_ms, idle_share=1 - device_ms / host_ms,
         device_ms_per_step_by_kernel=top,
         host_ops_per_step=probe.host_ops_per_step(),
         epoch_s=probe.epoch_s(range(SSL_PROFILED_EPOCH + 1, SSL_EPOCHS)),
         peak_allocated_bytes=peak,
         lp_dataset_s=probe.lp_s[0], build_and_plan_s=probe.build_s[0],
         seconds=seconds, best_val_f1=score,
         first_epoch_loss=float(losses[:n_b].mean()),
         last_epoch_loss=float(losses[-n_b:].mean()), log=lines,
         kernels={r["name"]: {k: r[k] for k in TIME_KEYS} for r in records})
    del probe, graph

    # eager (twice) against captured, from one seed and initial state
    short = dataclasses.replace(cfg, max_epochs=SSL_EAGER_EPOCHS)
    runs = {}
    with fused_norm(False):
        for name, graphed in (("eager", False), ("eager_again", False),
                              ("graphed", True)):
            runs[name] = ssl_run(base, short, init, cache, graphed,
                                 launch_epoch=-1,
                                 profiled_epoch=SSL_EAGER_PROFILED)
    (pe, ran_e, _, te, _, _), (pa, _, _, ta, _, _), (pg, _, _, tg, _, _) = (
        runs["eager"], runs["eager_again"], runs["graphed"])
    le, la, lg = (np.asarray(p.losses) for p in (pe, pa, pg))
    spread = (float(np.abs(la - le).max()), float(np.abs(ta - te).max()))
    diff = (float(np.abs(lg - le).max()), float(np.abs(tg - te).max()))
    check(ran_e.card == ran_e.counted and not pe.steps.programs,
          f"ssl eager: the card ran {ran_e.card}, the wrappers counted "
          f"{ran_e.counted}, {len(pe.steps.programs)} step captures")
    check(np.array_equal(lg, losses[:len(lg)]),
          "ssl: the captured runs' first epochs differ")
    check(spread == (0.0, 0.0), f"ssl: the eager repeats' losses and "
          f"tables spread by {spread}")
    check(diff[0] <= spread[0] and diff[1] <= spread[1],
          f"ssl: captured against eager, losses {diff[0]} and table "
          f"{diff[1]} apart; the eager repeats {spread[0]} and {spread[1]}")
    e_host = pe.host_ms_per_step([SSL_EAGER_PROFILED + 1])
    e_device, _ = pe.device_ms_per_step()
    emit("ssl_em_user_eager", card=card_line(), epochs=SSL_EAGER_EPOCHS,
         eager_repeat_max_abs_loss_diff=spread[0],
         eager_repeat_max_abs_table_diff=spread[1],
         graphed_max_abs_loss_diff=diff[0],
         graphed_max_abs_table_diff=diff[1], bit_equal=diff == (0.0, 0.0),
         eager_host_ms_per_step=e_host, eager_device_ms_per_step=e_device,
         eager_idle_share=1 - e_device / e_host,
         eager_epoch_s=pe.epoch_s([SSL_EAGER_PROFILED + 1]),
         eager_kernels_per_step=pe.host_ops_per_step()["kernels_per_step"],
         eager_run_launches=ran_e.card)
    del runs, pe, pa, pg

    seg = dataclasses.replace(cfg, spmm_mode="segment", max_epochs=1,
                              batches_per_epoch=1)
    with fused_norm(False):
        probe_s, _, _, _, _, _ = ssl_run(base, seg, init, cache)
    first, first_seg = float(losses[0]), probe_s.losses[0]
    check(math.isclose(first, first_seg, rel_tol=SSL_FIRST_LOSS_RTOL),
          f"ssl: first loss {first} against {first_seg} on segment")
    del probe_s

    one = dataclasses.replace(cfg, max_epochs=1)
    with fused_norm(True):
        probe_f, ran_f, _, _, _, _ = ssl_run(base, one, init, cache)
    graph = probe_f.graphs[0]
    norms = 2 * layers - 1  # each conv's GraphNorm, and one between convs
    per_step_f = scaled_sum((1, plan_launches(graph, 2 * layers)), (1, counts_form(
        norm={k: norms for k in fn.KERNELS}, norm_dtype="float32")))
    fwd = counts_form(norm={k: norms for k in ("colsum", "varsum", "affine")},
                      norm_dtype="float32")
    check_ssl_captures("ssl fused norm", probe_f, ran_f, per_step_f,
                       scaled_sum((1, plan_launches(graph, layers)),
                                  (1, fwd)))
    check(np.isfinite(probe_f.losses).all() and math.isclose(
        probe_f.losses[0], first, rel_tol=SSL_FIRST_LOSS_RTOL),
        f"ssl fused norm: first loss {probe_f.losses[0]} against {first}")
    emit("ssl_em_user_fused_norm", steps=len(probe_f.losses),
         launches_per_step=per_step_f, run_launches=ran_f.card,
         first_loss=probe_f.losses[0], first_loss_unfused=first,
         first_loss_segment=first_seg,
         rel_diff_segment=abs(first - first_seg) / abs(first_seg))
    return records


def phase_ssl_cli(device, root: Path) -> None:
    """[ssl_cli]: python -m glass_tpu_torch.cli.gnn_emb on the em_user
    stand-in (--use_nodeid --spmm pallas, SSL_CLI_TRIALS TPE trials of
    SSL_EPOCHS epochs) in a subprocess: a line per trial, a finite (N, 64)
    table in em_user_64.npz, the study in em_user.db; the same command
    again resumes its study and trains nothing; then glass_test
    --use_nodeid on the default route (RCM, the planner) trains from that
    table: the trunk's embedding at its first epoch equals the table row
    for row, its rows indexed by the original node ids."""
    emb = root / "Emb"
    cmd = [sys.executable, "-m", "glass_tpu_torch.cli.gnn_emb",
           "--dataset", "em_user", "--use_nodeid", "--spmm", "pallas",
           "--optruns", str(SSL_CLI_TRIALS), "--max_epochs", str(SSL_EPOCHS),
           "--sampler", "tpe", "--data_root", str(root / "data"),
           "--path", str(emb)]
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900,
                              cwd=Path(__file__).resolve().parent)
        runs.append((proc, time.perf_counter() - t0))
        check(proc.returncode == 0, f"gnn_emb: exit {proc.returncode}\n"
              f"{proc.stderr[-3000:]}")
    lines = runs[0][0].stdout.splitlines()
    trials = [m for m in map(SSL_TRIAL_LINE.match, lines) if m]
    check([int(m[1]) for m in trials] == list(range(SSL_CLI_TRIALS))
          and all(math.isfinite(float(m[3])) for m in trials),
          f"gnn_emb: trial lines {[m[0] for m in trials]}")
    again = runs[1][0].stdout.splitlines()
    check(any(f"resumed study: {SSL_CLI_TRIALS} completed trials" in l
              for l in again) and not any(SSL_TRIAL_LINE.match(l)
                                          or l.startswith("iter ")
                                          for l in again),
          f"gnn_emb again: {again[-5:]}")
    table = np.load(emb / "em_user_64.npz")["embedding"]
    check(table.shape == (N_COMM * COMM_SIZE, 64) and np.isfinite(table).all()
          and (emb / "em_user.db").exists(),
          f"gnn_emb: table {table.shape}, study {(emb / 'em_user.db').exists()}")
    emit("ssl_cli", card=card_line(), trials=[m[0] for m in trials],
         seconds=runs[0][1], resume_seconds=runs[1][1],
         table_shape=list(table.shape),
         iter_lines=[l for l in lines if l.startswith("iter ")],
         resumed=[l for l in again if l.startswith("resumed")])

    starts = []
    real_epoch = Trainer._epoch

    def epoch(trainer, pos_b, y_b):
        if not starts:
            starts.append((trainer.model.conv.input_emb.weight.detach()
                           .cpu().clone().numpy(),
                           trainer.x[:, 0].cpu().clone().numpy()))
        return real_epoch(trainer, pos_b, y_b)

    Trainer._epoch = epoch
    try:
        with fused_norm(False):
            out, probe, mean, _, secs, _ = run_cli(
                ["--dataset", "em_user", "--use_nodeid", "--use_maxzeroone",
                 "--data_root", str(root / "data"), "--emb_path", str(emb),
                 "--repeat", "1", "--max_epochs", str(SSL_GLASS_EPOCHS)])
    finally:
        Trainer._epoch = real_epoch
    weight, ids = starts[0]
    n = table.shape[0]
    check(np.array_equal(weight, table), "glass_test --use_nodeid: the "
          "trunk's embedding at the first epoch is not the table")
    check(np.array_equal(np.sort(ids), np.arange(n))
          and not np.array_equal(ids, np.arange(n)),
          "glass_test --use_nodeid: x is not the RCM-ordered node ids")
    losses = [e["loss"] for e in probe.epochs]
    check(np.isfinite(losses).all(), f"glass_test --use_nodeid: {losses}")
    emit("ssl_glass_test", card=card_line(), plan=probe.trainer.graph.plan,
         epoch_losses=losses, seconds=secs,
         table_rows_equal=True, **epoch_stats(probe))


SEG_EPOCHS = 30  # [seg_em_user]: evals at 0, 5, ..., 25
SEG_PROFILED_EPOCH = 2
SEG_DEPTH_EPOCHS, SEG_STEPS = 3, 3
SEG_LOSS_RTOL, SEG_LOGIT_TOL = 1e-5, 1e-5  # the latter times max |logit|
SEG_NORM_DRAW = 0.3  # the spread of the drawn norms' parameters
SEG_END_LINE = re.compile(r"end: val (\S+) tst (\S+)$")
ATTENTION_NODES, ATTENTION_EDGES, ATTENTION_H = 3000, 30_000, 32


class SegProbe:
    """Wraps glass_tpu_torch.train.seg_protocol's segregate, train_epoch
    and infer while a run lasts, with a StepProbe and a ProgramProbe over
    its captured steps and eval programs: segregate's splits and seconds;
    each epoch's steps, loss and host ms (train_epoch ends in the loss's
    readback, so its wall time is the epoch's), and the seconds from the
    probe's start to the first epoch; each eval call's ms and batches,
    and whether it captured a program. Epoch SEG_PROFILED_EPOCH runs under
    torch.profiler."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.splits, self.segregate_s = None, None
        self.epochs, self.evals, self.first_epoch_s = [], [], None
        self.steps, self.programs = StepProbe(), ProgramProbe()
        self.prof = None

    def __enter__(self):
        from glass_tpu_torch.train import seg_protocol as sp

        self._real = sp.segregate, sp.train_epoch, sp.infer
        real_seg, real_epoch, real_infer = self._real

        def segregate(base, kind):
            t0 = time.perf_counter()
            self.splits = real_seg(base, kind)
            self.segregate_s = time.perf_counter() - t0
            return self.splits

        def train_epoch(step, order, stream=None):
            if self.first_epoch_s is None:
                self.first_epoch_s = time.perf_counter() - self.t0
            profiled = len(self.epochs) == SEG_PROFILED_EPOCH
            if profiled:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
            t0 = time.perf_counter()
            loss = real_epoch(step, order, stream)
            ms = (time.perf_counter() - t0) * 1e3
            if profiled:
                self.prof.stop()
            self.epochs.append(dict(steps=len(order), loss=loss, host_ms=ms,
                                    profiled=profiled))
            return loss

        def infer(model, data, batch_size, programs, stream=None):
            n_prog = len(self.programs.programs)
            t0 = time.perf_counter()
            out = real_infer(model, data, batch_size, programs, stream)
            self.evals.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                batches=-(-data.y.shape[0] // batch_size),
                captured=len(self.programs.programs) > n_prog))
            return out

        sp.segregate, sp.train_epoch, sp.infer = segregate, train_epoch, infer
        self.steps.__enter__()
        self.programs.__enter__()
        return self

    def __exit__(self, *exc):
        from glass_tpu_torch.train import seg_protocol as sp

        self.programs.__exit__(*exc)
        self.steps.__exit__(*exc)
        sp.segregate, sp.train_epoch, sp.infer = self._real

    def host_ms_per_step(self) -> float:
        """The median over the epochs after the first, the profiled one
        left out, of an epoch's host ms per step."""
        return statistics.median(e["host_ms"] / e["steps"]
                                 for e in self.epochs[1:] if not e["profiled"])

    def eval_ms_per_batch(self) -> float:
        """The median ms a batch of the eval calls that captured nothing."""
        return statistics.median(e["ms"] / e["batches"] for e in self.evals
                                 if not e["captured"])

    def device_ms_per_step(self) -> tuple:
        """The profiled epoch's device time per step (every kernel), and
        the SSL_TOP_KERNELS largest parts of it by kernel name."""
        kernels = [e for e in self.prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)]
        steps = self.epochs[SEG_PROFILED_EPOCH]["steps"]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        return (sum(e.self_device_time_total for e in kernels) / 1e3 / steps,
                sum(e.count for e in kernels) / steps,
                {e.key[:80]: e.self_device_time_total / 1e3 / steps
                 for e in top[:SSL_TOP_KERNELS]})

    def timings(self, prefix: str) -> dict:
        """Host and device ms a step, the idle share, kernels a step and
        eval ms a batch, their names prefixed."""
        host = self.host_ms_per_step()
        device, kernels, _ = self.device_ms_per_step()
        return {f"{prefix}host_ms_per_step": host,
                f"{prefix}device_ms_per_step": device,
                f"{prefix}idle_share": 1 - device / host,
                f"{prefix}kernels_per_step": kernels,
                f"{prefix}eval_ms_per_batch": self.eval_ms_per_batch()}


def check_seg_graphed(what: str, graphed: SegProbe, eager: SegProbe,
                      repeats: int = 1) -> dict:
    """A GNN-seg run on captured steps and programs against the same run
    eager, from one seed: the epoch losses bit-equal; one step capture a
    repeat, replayed every step after a repeat's first; one eval program a
    batch shape and repeat, replayed by every later batch of its shape;
    none of this repo's kernels captured; no capture eagerly."""
    lg = [e["loss"] for e in graphed.epochs]
    le = [e["loss"] for e in eager.epochs]
    check(lg == le, f"{what}: graphed epoch losses {lg} against eager {le}")
    steps = sum(e["steps"] for e in graphed.epochs)
    caps = graphed.steps.programs
    check(len(caps) == repeats and graphed.steps.replayed() == steps - repeats,
          f"{what}: {len(caps)} step captures, {graphed.steps.replayed()} "
          f"replays in {steps} steps")
    batches = sum(e["batches"] for e in graphed.evals)
    progs = graphed.programs.programs
    check(progs and len(progs) + graphed.programs.replayed() == batches,
          f"{what}: {len(progs)} eval programs and "
          f"{graphed.programs.replayed()} replays for {batches} batches")
    check(all(c.counts == counts_form() for c in caps + progs),
          f"{what}: a capture counted one of this repo's kernels")
    check(not eager.steps.programs and not eager.programs.programs,
          f"{what}: the eager run captured")
    return dict(step_captures=len(caps), step_replays=graphed.steps.replayed(),
                eval_programs=len(progs),
                eval_replays=graphed.programs.replayed())


def check_seg_log(lines: list, repeats: int, mean: float, err: float) -> list:
    """JAX's log format: per repeat a "repeat r" line, iter lines, an end
    line; then "tst scores [...]" and "{mean} {err}". Returns the iter
    lines' (epoch, loss, val, tst)."""
    check(sum(l.startswith("repeat ") for l in lines) == repeats,
          f"seg: {repeats} repeats logged: {lines[:3]}")
    iters = [ITER_LINE.match(l) for l in lines if l.startswith("iter ")]
    check(iters and all(iters), f"seg: iter lines {lines}")
    ends = [SEG_END_LINE.match(l) for l in lines if l.startswith("end: ")]
    check(len(ends) == repeats and all(ends), f"seg: end lines {lines}")
    check(any(l.startswith("tst scores [") for l in lines)
          and f"{mean} {err}" in lines and math.isfinite(mean),
          f"seg: the closing lines {lines[-3:]}")
    return [(int(m[1]), float(m[2]), float(m[3]), float(m[4]))
            for m in iters]


def phase_seg_em_user(device, data_root: Path) -> dict:
    """[seg_em_user]: the gnn_seg CLI at em_user's best hyperparameters on
    the stand-in for SEG_EPOCHS epochs, in this process, on captured steps
    and eval programs, then the same run eagerly (run_seg_experiment with
    _graphed cleared) from the same seed: see the module docstring.
    Returns the run's splits (SegData by split name)."""
    from glass_tpu_torch.cli import gnn_seg
    from glass_tpu_torch.train import seg_protocol as sp

    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with SegProbe() as probe, contextlib.redirect_stdout(out):
        mean, err = gnn_seg.main(["--dataset", "em_user", "--data_root",
                                  str(data_root), "--max_epochs",
                                  str(SEG_EPOCHS)])
    seconds = time.perf_counter() - probe.t0
    peak = torch.cuda.max_memory_allocated()
    lines = out.getvalue().splitlines()
    iters = check_seg_log(lines, 1, mean, err)
    losses = [e["loss"] for e in probe.epochs]
    check(len(losses) == SEG_EPOCHS and np.isfinite(losses).all(),
          f"seg_em_user: epoch losses {losses}")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"seg_em_user: losses did not fall: {losses}")
    hp = sp.BEST_HYPERPARAMS["em_user"]
    cfg = sp.SegConfig(dataset="em_user", max_epochs=SEG_EPOCHS,
                       data_root=str(data_root), device=device.type, **hp)
    eager_lines = []
    with SegProbe() as eager:
        sp.run_seg_experiment(cfg, log=eager_lines.append, _graphed=False)
    captures = check_seg_graphed("seg_em_user", probe, eager)
    check([l for l in lines if ITER_LINE.match(l)]
          == [l for l in eager_lines if ITER_LINE.match(l)],
          "seg_em_user: graphed and eager log different iter lines")
    trn = probe.splits["train"]
    S, L, F = trn.feats.shape
    resident = sum(d.adj_norm.nbytes + d.adj_sum.nbytes
                   for d in probe.splits.values())
    _, _, top = probe.device_ms_per_step()
    emit("seg_em_user", card=card_line(), hyperparameters=hp,
         subgraphs={k: int(d.y.shape[0]) for k, d in probe.splits.items()},
         L=L, F=F, segregate_s=probe.segregate_s,
         resident_adjacency_bytes=resident,
         resident_feature_bytes=sum(d.feats.nbytes
                                    for d in probe.splits.values()),
         steps_per_epoch=probe.epochs[0]["steps"], **probe.timings(""),
         **eager.timings("eager_"), **captures,
         device_ms_per_step_by_kernel=top, eval_calls=len(probe.evals),
         first_epoch_s=probe.first_epoch_s, seconds=seconds,
         epoch_losses=losses, losses_bit_equal_eager=True, iter_lines=iters,
         mean=mean, err=err, peak_allocated_bytes=peak)
    return probe.splits


def seg_models(in_ch: int, out_ch: int, layers: int, conv: str, device,
               drawn: bool):
    """(card model, CPU model) of GSegGNN with dropout 0 from one state:
    the initial one, or with ``drawn`` the norms' weight, bias and
    mean_scale moved by N(0, SEG_NORM_DRAW^2) draws."""
    from glass_tpu_torch.nn.seg import GSegGNN

    cpu = GSegGNN(in_ch, 64, out_ch, layers, conv=conv, seed=5, device="cpu")
    if drawn:
        gen = torch.Generator().manual_seed(76)
        with torch.no_grad():
            for name, p in cpu.named_parameters():
                if name.startswith("gn_"):
                    p.add_(SEG_NORM_DRAW * torch.randn(p.shape, generator=gen))
    card = GSegGNN(in_ch, 64, out_ch, layers, conv=conv, seed=6,
                   device=device)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, got moved to want's device."""
    return float((got.to(want.device) - want).abs().max()
                 / want.abs().max())


def phase_seg_depth(device, data_root: Path, splits: dict) -> None:
    """[seg_depth]: ppi_bp's best hyperparameters (8 GCN layers) on the
    em_user stand-in: run_seg_experiment for SEG_DEPTH_EPOCHS epochs on
    captured steps and eval programs and again eagerly from the same seed
    (epoch losses bit-equal; host and device ms per step both ways,
    check_seg_graphed); then with dropout 0, from one state on
    both devices, SEG_STEPS Adam steps on the card and on the CPU on the
    same batches, and the logits of a |test|-sized eval batch; and the gin
    conv's forward and backward on one batch. Checked from the state with
    the norms' parameters drawn: losses within rtol SEG_LOSS_RTOL, logits
    within SEG_LOGIT_TOL x max|logit|, the gin logits and loss likewise,
    gradients finite. From the initial state (every mean_scale 1) the
    losses are reported only: there each conv bias ahead of a norm has an
    analytically zero gradient, which Adam's first step turns, rounding
    noise and all, into a step of +-lr, so the second step's loss is not
    determined to rtol SEG_LOSS_RTOL on either device."""
    from glass_tpu_torch.train import seg_protocol as sp
    from glass_tpu_torch.train.loop import LOSSES

    hp = sp.BEST_HYPERPARAMS["ppi_bp"]
    cfg = sp.SegConfig(dataset="em_user", max_epochs=SEG_DEPTH_EPOCHS,
                       data_root=str(data_root), device=device.type, **hp)
    lines = []
    torch.cuda.reset_peak_memory_stats()
    with SegProbe() as probe:
        _, mean, err = sp.run_seg_experiment(cfg, log=lines.append)
    peak = torch.cuda.max_memory_allocated()
    check_seg_log(lines, 1, mean, err)
    with SegProbe() as eager:
        sp.run_seg_experiment(cfg, log=lambda *_: None, _graphed=False)
    captures = check_seg_graphed("seg_depth", probe, eager)
    losses = [e["loss"] for e in probe.epochs]

    trn, tst = splits["train"], splits["test"]
    cpu_dev = torch.device("cpu")
    data = {dev: (sp.to_device(trn, np.float32, dev),
                  sp.to_device(tst, np.float32, dev))
            for dev in (device, cpu_dev)}
    order = np.random.default_rng(73).permutation(trn.y.shape[0])
    batch = tst.y.shape[0]
    in_ch, layers = trn.feats.shape[-1], hp["conv_layer"]
    step_losses, logit_err = {}, {}
    for state in ("drawn", "initial"):
        card, cpu = seg_models(in_ch, 1, layers, "gcn", device,
                               drawn=state == "drawn")
        logit_err[state] = max_rel(*(torch.from_numpy(sp.infer(
            model, data[dev][1], batch, InferencePrograms(dev)))
            for dev, model in ((device, card), (cpu_dev, cpu))))
        for dev, model in ((device, card), (cpu_dev, cpu)):
            opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
            step_losses[state, dev.type] = [float(sp.train_step(
                model, opt, LOSSES["bce"],
                data[dev][0].take(torch.from_numpy(
                    order[k * batch:(k + 1) * batch]).to(dev)), None))
                for k in range(SEG_STEPS)]
    loss_rel = {state: max(abs(a - b) / abs(b) for a, b in zip(
        step_losses[state, device.type], step_losses[state, "cpu"]))
        for state in ("drawn", "initial")}

    card_g, cpu_g = seg_models(in_ch, 1, layers, "gin", device, drawn=True)
    gin = {}
    for dev, model in ((device, card_g), (cpu_dev, cpu_g)):
        b = data[dev][0].take(torch.from_numpy(order[:batch]).to(dev))
        logits = model(b.adj_norm, b.adj_sum, b.feats, b.mask)
        loss = LOSSES["bce"](logits, b.y)
        loss.backward()
        gin[dev.type] = (logits.detach(), float(loss.detach()), all(
            bool(torch.isfinite(p.grad).all()) for p in model.parameters()))
    gin_err = max_rel(gin[device.type][0], gin["cpu"][0])
    emit("seg_depth", card=card_line(), hyperparameters=hp,
         epochs=len(losses), epoch_losses=losses, **probe.timings(""),
         **eager.timings("eager_"), **captures, losses_bit_equal_eager=True,
         peak_allocated_bytes=peak,
         step_losses={f"{k[0]}_{k[1]}": v for k, v in step_losses.items()},
         step_loss_max_rel=loss_rel, eval_logits_max_rel=logit_err,
         gin_logits_max_rel=gin_err, gin_loss=gin[device.type][1],
         gin_loss_cpu=gin["cpu"][1])
    check(np.isfinite(losses).all(), f"seg_depth: losses {losses}")
    check(loss_rel["drawn"] <= SEG_LOSS_RTOL,
          f"seg_depth: card losses {step_losses['drawn', device.type]} "
          f"against CPU {step_losses['drawn', 'cpu']}")
    check(max(logit_err.values()) <= SEG_LOGIT_TOL,
          f"seg_depth: eval logits differ by {logit_err} x max|logit|")
    check(gin_err <= SEG_LOGIT_TOL and math.isclose(
        gin[device.type][1], gin["cpu"][1], rel_tol=SEG_LOSS_RTOL)
        and gin[device.type][2] and gin["cpu"][2],
        f"seg_depth gin: logits {gin_err} x max, loss "
        f"{gin[device.type][1]} against {gin['cpu'][1]}, gradients finite "
        f"{gin[device.type][2]}, {gin['cpu'][2]}")


def phase_attention_small(device) -> None:
    """[attention_small]: sddmm (dense, gather), segment_softmax and one
    AttentionConv forward and backward on a random 3,000-node "gcn" graph
    (with its padding edges), card against CPU: each result and gradient
    within KERNEL_TOL x its CPU max."""
    from glass_tpu_torch.nn.modules import AttentionConv
    from glass_tpu_torch.ops import sddmm as sd

    rng = np.random.default_rng(74)
    ei = rng.integers(0, ATTENTION_NODES, (2, ATTENTION_EDGES))
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    x = rng.standard_normal((ATTENTION_NODES, ATTENTION_H)).astype(np.float32)
    y = rng.standard_normal(x.shape).astype(np.float32)
    # one score an edge, padding edges included (E_pad < E + EDGE_BUCKET)
    scores = rng.standard_normal(ei.shape[1] + EDGE_BUCKET).astype(np.float32)
    res = {}
    for dev in (device, torch.device("cpu")):
        g = build_graph(ei, None, ATTENTION_NODES, "gcn", device=dev)
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        conv = AttentionConv(ATTENTION_H, ATTENTION_H,
                             generator=torch.Generator().manual_seed(75))
        conv.to(dev)
        xg = xt.clone().requires_grad_(True)
        out = conv(g, xg)
        (out * yt).sum().backward()
        r = {"sddmm_dense": sd.sddmm(g, xt, yt, "dense"),
             "sddmm_gather": sd.sddmm(g, xt, yt, "gather"),
             "sddmm_auto": sd.sddmm(g, xt),
             "segment_softmax": sd.segment_softmax(
                 g, torch.from_numpy(scores[:g.row.shape[0]]).to(dev)),
             "attention_out": out.detach(), "attention_dx": xg.grad}
        r.update({f"attention_d{k}": p.grad
                  for k, p in conv.named_parameters()})
        res[dev.type] = r
    errs = {k: max_rel(v, res["cpu"][k]) for k, v in res[device.type].items()}
    bad = {k: e for k, e in errs.items() if not e <= KERNEL_TOL}
    check(not bad, f"attention_small: card against CPU {bad}")
    emit("attention_small", nodes=ATTENTION_NODES,
         directed_edges=int(ei.shape[1]), hidden=ATTENTION_H,
         max_rel_err=errs)


def phase_profiling(device, splits: dict, tmp: Path) -> None:
    """[profiling]: trace around one GNN-seg step (em_user's
    configuration, one |test|-sized batch) writes one Chrome trace holding
    the step's name and the card's kernels; nan_check_mode raises at a NaN
    from a forward op (sqrt of -1) and from a backward op (sqrt's
    gradient at 0 times 0, whose forward is finite), lets one finite
    GNN-seg step through, and leaves the anomaly switches and the dispatch
    mode stack as they were."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from glass_tpu_torch.train import seg_protocol as sp
    from glass_tpu_torch.train.loop import LOSSES
    from glass_tpu_torch.utils.profiling import nan_check_mode, trace

    trn = sp.to_device(splits["train"], np.float32, device)
    batch = trn.take(torch.arange(splits["test"].y.shape[0], device=device))
    model = sp.GSegGNN(trn.feats.shape[-1], 64, 1, 1, dropout=0.4,
                       device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        return float(sp.train_step(model, opt, LOSSES["bce"], batch, gen))

    log_dir = tmp / "trace"
    with trace("gnn_seg_step", str(log_dir)):
        step()
    files = list(log_dir.glob("gnn_seg_step.*.pt.trace.json"))
    check(len(files) == 1 and files[0].stat().st_size > 0,
          f"profiling: trace files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    device_kernels = sum(e.get("cat") == "kernel" for e in events)
    check(any(e.get("name") == "gnn_seg_step" for e in events)
          and device_kernels > 0,
          f"profiling: the trace holds {device_kernels} kernels")

    def switches():
        return (torch.is_anomaly_enabled(),
                torch.is_anomaly_check_nan_enabled(),
                _get_current_dispatch_mode())

    before = switches()
    raised = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with nan_check_mode():
                torch.sqrt(torch.full((4,), -1.0, device=device))
        except FloatingPointError as e:
            raised["forward"] = str(e)
        z = torch.zeros(4, device=device, requires_grad=True)
        try:
            with nan_check_mode():
                (torch.sqrt(z) * 0.0).sum().backward()
        except (FloatingPointError, RuntimeError) as e:
            raised["backward"] = f"{type(e).__name__}: {str(e)[:200]}"
        with nan_check_mode():
            finite_loss = step()
    check(set(raised) == {"forward", "backward"},
          f"profiling: nan_check_mode raised only {raised}")
    check(switches() == before and math.isfinite(finite_loss),
          f"profiling: switches {switches()} after, {before} before")
    check(bool(torch.isnan(torch.sqrt(torch.full((1,), -1.0,
                                                 device=device))).all()),
          "profiling: NaN checks still on after the block")
    emit("profiling", trace_file=files[0].name,
         trace_bytes=files[0].stat().st_size, trace_events=len(events),
         trace_kernels=device_kernels, nan_check_raised=raised,
         finite_step_loss=finite_loss)


# --------------------------------------------------------------- the ranks
# One process per rank, each watched: the sharded phases here and the
# port's multi-process tests (tests/test_torch_parallel.py,
# tests/test_torch_multihost.py) start their ranks through these two.


def run_ranks(cmds: list, logs: list, timeout: float, env=None) -> list:
    """Runs one command a rank (with ``env``'s variables added), each
    writing to its log file, and waits for all; at the first rank that
    fails (or at ``timeout`` s) kills the others and fails. Returns the
    logs' text."""
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent),
         os.environ.get("PYTHONPATH", "")]))
    files = [open(p, "w") for p in logs]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for c, f in zip(cmds, files)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    texts = [Path(p).read_text() for p in logs]
    for i, (p, t) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"rank {i} exited {p.returncode}:\n"
              f"{t[-3000:]}")
    return texts


def spawn(fn, world: int, args: tuple = (), *, backend: str = "gloo",
          timeout: float = 600.0) -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each run by
    run_ranks in a process of its own (rank_main) joined to a ``backend``
    process group of ``world`` ranks through a ``file://`` rendezvous (no
    TCP port another process could hold). ``fn`` is a module-level
    function, importable from this process's sys.path; ``args`` pickle."""
    import pickle

    module = fn.__module__
    if module == "__main__":  # this script, run as one
        module = Path(sys.modules["__main__"].__file__).stem
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "path.json").write_text(json.dumps(sys.path))
        (tmp / "call.pkl").write_bytes(pickle.dumps(
            (module, fn.__qualname__, args)))
        here = str(Path(__file__).resolve().parent)
        cmd = [sys.executable, "-c",
               f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
               "chip_smoke.rank_main(*sys.argv[1:])", str(tmp), str(world),
               backend]
        run_ranks([cmd + [str(r)] for r in range(world)],
                  [tmp / f"rank{r}.log" for r in range(world)], timeout)
        return [pickle.loads((tmp / f"out{r}.pkl").read_bytes())
                for r in range(world)]


def rank_main(tmp: str, world: str, backend: str, rank: str) -> None:
    """One rank of spawn: joins the group with one CPU thread, runs the
    pickled call and writes what it returned."""
    import datetime
    import importlib
    import pickle

    import torch.distributed as dist

    tmp, world, rank = Path(tmp), int(world), int(rank)
    sys.path.extend(p for p in json.loads((tmp / "path.json").read_text())
                    if p not in sys.path)
    module, name, args = pickle.loads((tmp / "call.pkl").read_bytes())
    fn = getattr(importlib.import_module(module), name)
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{tmp / 'rendezvous'}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    (tmp / f"out{rank}.pkl").write_bytes(pickle.dumps(out))


END_LINE = re.compile(r"end: epoch (\d+), train time (\S+) s, val (\S+), "
                      r"tst (\S+)$")


# ------------------------------------------------------------ sharded paths

# [sharded_train]: (data, graph) ranks, all on the one card, over gloo
SHARD_MESH = (2, 2)
# [sharded_kernels_main]: the em_user stand-in over [sharded_train]'s graph
# shards (nb = 28,672), each per-shard layout family and slab type the
# sharded path runs
SHARD_K = SHARD_MESH[1]
SHARD_LAYOUTS = (("bcsr", "f32"), ("bcsr", "int8"), ("band", "f32"),
                 ("band", "int8"), ("hybrid", "f32"), ("hybrid", "int8"))
# where two int8 layouts quantize different rows (a shard's transposed
# layout quantizes each partial column by its own largest weight; the
# hybrid splits band and residue apart by shard): within the quantization's
# bound, 1/254 of a row's largest weight on bf16-rounded x (as
# tests/test_torch_partition.py holds the int8 per-shard layouts)
SHARD_Q_TOL = 2e-2
SHARD_TIME = dict(groups=5, per_group=5)  # the per-shard and plain timings
SHARD_COLD_REPS = 5
SHARD_STEPS = 3
# case -> (edges, partition_graph keywords, spmm mode): JAX's dry-run
# matrix (__graft_entry__.py::dryrun_multichip) at em_user width
SHARD_TRAIN_CASES = {
    "segment": ("em_user", dict(overlap=False), "segment"),
    "overlap": ("em_user", dict(), "segment"),
    "ring": ("em_user", dict(ring=True), "segment"),
    "bcsr_f32": ("em_user", dict(materialize_bcsr=True,
                                 sparse_layout="bcsr"), "pallas"),
    "bcsr_int8": ("em_user", dict(materialize_bcsr=True, sparse_layout="bcsr",
                                  dense_dtype="int8"), "pallas"),
    "band_f32": ("em_user", dict(materialize_bcsr=True,
                                 sparse_layout="band"), "pallas"),
    "band_int8": ("em_user", dict(materialize_bcsr=True, sparse_layout="band",
                                  dense_dtype="int8"), "pallas"),
    "hybrid_f32": ("hybrid", dict(materialize_bcsr=True,
                                  sparse_layout="hybrid"), "pallas"),
    "hybrid_int8": ("hybrid", dict(materialize_bcsr=True,
                                   sparse_layout="hybrid",
                                   dense_dtype="int8"), "pallas"),
}
# losses against the one-process Trainer on the same layout: f32 within the
# port's f32 parity tolerance; int8 within 1e-3: the transposed per-shard
# layouts quantize other rows (a shard's partial columns) than the
# unsharded one, so the gradients differ within the quantization's bound
# (5e-2 x max|grad| between two roundings, tests/test_torch_quant.py), and
# Adam moves a parameter by at most lr a step (at most 2.5e-4 apart over
# the int8 cases, on an NVIDIA H100 80GB HBM3 at 700 W)
SHARD_LOSS_RTOL, SHARD_Q_LOSS_RTOL = 1e-5, 1e-3
SHARD_NCCL_RTOL = 1e-6
# bench.py:39-52's random stand-in for the density graph (the AutoTrainer's
# graph axis splits its dense rows)
DENSITY_N, DENSITY_E = 4998, 29962
SHARD_CLI_EPOCHS = 2  # before the eval gate (epoch 10): train_epochs
# the AutoTrainer over 4 data ranks: em_user's batch (6) rounded up to a
# multiple of 4
AUTO_DATA_BATCH = 8


def density_edges():
    rng = np.random.default_rng(0)
    src = rng.integers(0, DENSITY_N, size=DENSITY_E)
    dst = rng.integers(0, DENSITY_N, size=DENSITY_E)
    return np.stack([np.r_[src, dst], np.r_[dst, src]]), DENSITY_N


def named_edges(name: str):
    return {"em_user": clustered_graph, "hybrid": hybrid_edges,
            "density": density_edges}[name]()


def build_host(kind: str, edges: str, k: int, kw: dict, save=None):
    """A host build, run in a worker process: partition_graph (kind
    "partition", k shards) or build_graph on the CPU (kind "graph");
    returns (the result, seconds), or with ``save`` (a path) writes the
    result there (torch.save) and returns (the path, seconds)."""
    from glass_tpu_torch.parallel.partition import partition_graph

    ei, n = named_edges(edges)
    t0 = time.perf_counter()
    if kind == "partition":
        out = partition_graph(ei, None, n, EM_USER["aggr"], k, **kw)
    else:
        out = build_graph(ei, None, n, EM_USER["aggr"], device="cpu", **kw)
    seconds = time.perf_counter() - t0
    if save is None:
        return out, seconds
    torch.save(out, save)
    return save, seconds


def build_all(jobs: dict) -> dict:
    """The host builds of ``jobs`` (name -> build_host's arguments), side
    by side in spawned worker processes: name -> (result, seconds)."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(jobs), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {name: pool.submit(build_host, *args)
                   for name, args in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def to_device(obj, device, memo=None):
    """A host-built Graph (or layout) with every tensor on ``device``,
    shared layouts (A's and A^T's when A is symmetric) kept shared."""
    memo = {} if memo is None else memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif dataclasses.is_dataclass(obj):
        out = dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device, memo)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(obj, f.name))})
    else:
        return obj
    memo[id(obj)] = out
    return out


def layout_csr(layout) -> torch.Tensor:
    """A band or BCSR layout (rectangular, trimmed, int8 dequantized) as a
    torch CSR tensor: the library yardstick's input; timed only."""
    if isinstance(layout, bd.BandedAdj):
        g, r, k = torch.nonzero(layout.slabs, as_tuple=True)
        rows = ((g + (layout.g_lo or 0)) * layout.rps * BLOCK + r)
        cols = layout.clo.long()[g] * BLOCK + k
        vals = layout.slabs[g, r, k].float()
        srow = g * layout.rps * BLOCK + r
    else:
        s, r, k = torch.nonzero(layout.blocks, as_tuple=True)
        slot = s * bs.CHUNK + k // BLOCK
        rb = torch.searchsorted(layout.block_row_ptr, slot.int(),
                                right=True) - 1
        rows = rb * BLOCK + r
        cols = layout.block_col.long()[slot] * BLOCK + k % BLOCK
        vals = layout.blocks[s, r, k].float()
        srow = rows
    if layout.row_scale is not None:
        vals = vals * layout.row_scale[srow]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), vals,
            (layout.n_node, layout.n_cb * BLOCK)).coalesce().to_sparse_csr()


def layout_bound(layout, x) -> tuple:
    return (band_bound_ms(layout, x) if isinstance(layout, bd.BandedAdj)
            else bound_ms(layout, x))


def kernel_of(layout):
    if isinstance(layout, bd.BandedAdj):
        return ((lambda v: bd.band_spmm(layout, v)),
                (lambda v: bd.band_spmm_reference(layout, v)))
    return ((lambda v: bs.bcsr_spmm(layout, v)),
            (lambda v: bs.bcsr_spmm_reference(layout, v)))


SHARD_TPU = {
    "bcsr": ("glass_tpu/ops/pallas_spmm.py:411",
             ["glass_tpu/ops/pallas_spmm.py:321 _bcsr_chunk_kernel",
              "glass_tpu/ops/pallas_spmm.py:411 _bcsr_chunk_kernel_large"],
             "glass_tpu_torch/csrc/bcsr_spmm.cu"),
    "band": ("glass_tpu/ops/pallas_band.py:465", BAND_TPU[1:] + BAND_TPU[:1],
             "glass_tpu_torch/csrc/band_spmm.cu"),
}


def shard_direction(layouts: list, xs: list, what: str) -> tuple:
    """Each shard's kernel against its plain version on its input, timed
    eager and cold; (outputs, max err, per-shard timings, the slowest
    shard's index)."""
    outs, err, times = [], 0.0, []
    for k, (layout, x) in enumerate(zip(layouts, xs)):
        fn, plain = kernel_of(layout)
        e, _ = check_vs_plain(f"{what} shard {k}", fn, plain, x)
        err = max(err, e)
        outs.append(fn(x))
        times.append(dict(ms=time_ms(lambda: fn(x), **SHARD_TIME),
                          device_ms=cold_ms(lambda: fn(x),
                                            reps=SHARD_COLD_REPS)))
    slow = max(range(len(times)), key=lambda k: times[k]["ms"])
    return outs, err, times, slow


def shard_record(family: str, dtype: str, part: str, fwd: tuple, bwd: tuple,
                 unsharded: dict) -> dict:
    """A kernels-line record of one per-shard layout family: the forward
    (local rows x global columns) on the slowest shard as the record's
    times, the transposed direction's beside them (t_*), every shard's
    times, and the unsharded kernel's."""
    rec = dict(name=f"{family}_spmm_shard_{dtype}" + (f"_{part}" if part
                                                       else ""),
               route="cuda", source=SHARD_TPU[family][2],
               replaces=SHARD_TPU[family][0], tpu=SHARD_TPU[family][1],
               shards=SHARD_K, unsharded=unsharded)
    for prefix, (layout, x, err, times, k) in (("", fwd), ("t_", bwd)):
        fn, plain = kernel_of(layout)
        adj = layout_csr(layout)
        bound, by = layout_bound(layout, x)
        rec.update({
            f"{prefix}max_abs_err": err,
            f"{prefix}ms": times[k]["ms"],
            f"{prefix}device_ms": times[k]["device_ms"],
            f"{prefix}plain_ms": time_ms(lambda: plain(x), **SHARD_TIME),
            f"{prefix}library_ms": time_ms(lambda: torch.sparse.mm(adj, x),
                                           **SHARD_TIME),
            f"{prefix}bound_ms": bound, f"{prefix}bound_by": by,
            f"{prefix}shard": k,
            f"{prefix}shard_ms": [t["ms"] for t in times],
            f"{prefix}shard_device_ms": [t["device_ms"] for t in times],
            f"{prefix}shape": [layout.n_node, layout.n_cb * BLOCK,
                               x.shape[1]],
        })
        if isinstance(layout, bd.BandedAdj):
            rec[f"{prefix}band"] = dict(rps=layout.rps,
                                        w_blocks=layout.w_blocks,
                                        groups=layout.n_groups,
                                        trimmed=layout.g_lo is not None)
        del adj
    return rec


def phase_sharded_kernels_main(device, built: dict) -> list:
    """The per-shard layouts of the sharded path at em_user scale, on
    [sharded_train]'s own partitions (``built``, shard_builds): each
    shard's forward (local rows x global columns) and transposed (global
    rows x local columns, the band's row-range trimmed) kernels against
    their plain versions, the shards' forward outputs stacked against the
    unsharded kernel's A @ x and their transposed outputs summed against
    its A^T g, each timed beside the unsharded kernel. Returns the kernels
    line's records (their launches come from [sharded_train], on these
    layouts); takes the unsharded graphs out of ``built``."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(71)
    h = EM_USER["hidden_dim"]
    records, lines = [], []
    for layout, dt in SHARD_LAYOUTS:
        path, pg_s = built[f"{layout}_{dt}"]
        pg, load_s = load_partition(path)
        check(pg.n_shards == SHARD_K, f"{path}: {pg.n_shards} shards")
        graph = to_device(built.pop(f"g_{layout}_{dt}")[0], device)
        n, nb = pg.n_node, pg.block
        x = torch.randn(SHARD_K * nb, h, generator=gen).to(device)
        x[n:] = 0
        g = torch.randn(SHARD_K * nb, h, generator=gen).to(device)
        g[n:] = 0
        fwd_sum = x.new_zeros((SHARD_K * nb, h))
        bwd_sum = x.new_zeros((SHARD_K * nb, h))
        parts = [p for p in ("band", "bcsr") if getattr(pg, p) is not None]
        for part in parts:
            fwd = [getattr(pg, part).local(k, device) for k in range(SHARD_K)]
            bwd = [getattr(pg, part + "_t").local(k, device)
                   for k in range(SHARD_K)]
            what = f"sharded {layout} {dt} {part}"
            fo, fe, ft, fk = shard_direction(fwd, [x] * SHARD_K, what)
            gs = [g[k * nb:(k + 1) * nb] for k in range(SHARD_K)]
            bo, be, bt, bk = shard_direction(bwd, gs, what + " transposed")
            for k in range(SHARD_K):
                fwd_sum[k * nb:(k + 1) * nb] += fo[k]
                bwd_sum += bo[k]
            unsh = getattr(graph, part)
            ufn, _ = kernel_of(unsh)
            unsharded = dict(ms=time_ms(lambda: ufn(x[:n]), **SHARD_TIME),
                             device_ms=cold_ms(lambda: ufn(x[:n]),
                                               reps=SHARD_COLD_REPS),
                             shape=[unsh.n_node, unsh.n_cb * BLOCK, h])
            rec = shard_record(part, dt, layout if layout == "hybrid" else "",
                               (fwd[fk], x, fe, ft, fk),
                               (bwd[bk], gs[bk], be, bt, bk), unsharded)
            records.append(rec)
            del fwd, bwd
        ax = spmm(graph, x[:n], "pallas")
        atg = spmm(graph, g[:n], "pallas")  # A is symmetric ("gcn")
        f_err = float((fwd_sum[:n] - ax).abs().max())
        b_err = float((bwd_sum[:n] - atg).abs().max())
        f_tol = (SHARD_Q_TOL if dt == "int8" and layout == "hybrid"
                 else KERNEL_TOL) * float(ax.abs().max())
        b_tol = (SHARD_Q_TOL if dt == "int8" else KERNEL_TOL) * float(
            atg.abs().max())
        check(f_err <= f_tol, f"sharded {layout} {dt}: stacked forward "
              f"max|diff| {f_err} > {f_tol}")
        check(b_err <= b_tol, f"sharded {layout} {dt}: summed transposed "
              f"max|diff| {b_err} > {b_tol}")
        line = dict(layout=layout, dtype=dt, shards=SHARD_K, block=nb,
                    n_node=n, partition_s=pg_s, load_s=load_s, parts=parts,
                    stacked_fwd_max_abs_diff=f_err,
                    summed_bwd_max_abs_diff=b_err,
                    **{f"{r['name']}_{key}": r[key] for r in records[-len(parts):]
                       for key in ("ms", "device_ms", "t_ms", "t_device_ms",
                                   "bound_ms", "t_bound_ms")},
                    unsharded_ms={r["name"]: r["unsharded"]["ms"]
                                  for r in records[-len(parts):]})
        if pg.band is not None:
            line.update(rps=pg.band.rps, w_fwd=pg.band.w_blocks,
                        w_bwd=pg.band_t.w_blocks,
                        groups_bwd_stored=int(pg.band_t.slabs.shape[1]),
                        groups_bwd_total=pg.band_t.n_g_total)
        lines.append(line)
        del pg, graph, x, g, fwd_sum, bwd_sum
        torch.cuda.empty_cache()
    for line in lines:
        emit("sharded_kernels_main", **line)
    emit("sharded_kernels_main_done", seconds=time.perf_counter() - t0,
         kernels=len(records))
    return records


def shard_problem(bsz: int = EM_USER["batch_size"]):
    """The em_user training problem of [sharded_train]: SHARD_STEPS batches
    of ``bsz`` size-labelled subgraphs."""
    pos, y = size_labelled_subgraphs(np.random.default_rng(61),
                                     SHARD_STEPS * bsz, N_COMM, COMM_SIZE)
    return (pos.reshape(SHARD_STEPS, bsz, -1), y.reshape(SHARD_STEPS, bsz))


def shard_cfg(bsz: int = EM_USER["batch_size"]) -> TrainConfig:
    return TrainConfig(lr=EM_USER["lr"], resi=EM_USER["resi"],
                       batch_size=bsz, loss="bce")


def rank_epoch(trainer, pos_b, y_b) -> dict:
    """One epoch of SHARD_STEPS steps on this rank with its launches read
    from this process's device counters; losses, launches, ms per step."""
    reset_counts()
    card_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train_epoch(pos_b, y_b)
    ms = (time.perf_counter() - t0) * 1e3 / SHARD_STEPS
    return dict(losses=[float(v) for v in res.step_losses],
                card=card_counts(), counted=full_counts(), ms_per_step=ms)


def load_partition(path: str):
    """A partition that build_host saved, and the seconds its load took."""
    t0 = time.perf_counter()
    return torch.load(path, weights_only=False), time.perf_counter() - t0


def shard_builds(root: Path) -> dict:
    """The host builds of the sharded phases, each made once, side by side
    in worker processes: the partitions of [sharded_train] (one a case,
    SHARD_K graph shards; [sharded_kernels_main] checks their per-shard
    layouts) and of [sharded_nccl] (one shard, BCSR), saved under ``root``
    (every rank loads them): name -> (path, build seconds); and the
    unsharded graphs [sharded_kernels_main] holds them against: "g_<layout>
    _<dtype>" -> (the Graph, build seconds)."""
    root.mkdir(parents=True, exist_ok=True)
    jobs = {case: ("partition", edges, SHARD_K, kw, str(root / f"{case}.pt"))
            for case, (edges, kw, _) in SHARD_TRAIN_CASES.items()}
    jobs["nccl"] = ("partition", "em_user", 1,
                    dict(materialize_bcsr=True, sparse_layout="bcsr"),
                    str(root / "nccl.pt"))
    for layout, dt in SHARD_LAYOUTS:
        jobs[f"g_{layout}_{dt}"] = (
            "graph", "hybrid" if layout == "hybrid" else "em_user", 0,
            dict(materialize_dense=False, materialize_bcsr=True,
                 sparse_layout=layout, dense_dtype=dt))
    t0 = time.perf_counter()
    built = build_all(jobs)
    emit("sharded_builds", jobs=len(jobs),
         seconds=time.perf_counter() - t0,
         build_s={name: sec for name, (_, sec) in built.items()})
    return built


def sharded_train_rank(rank: int, parts: dict) -> dict:
    """[sharded_train] on one of the 2 x 2 ranks (all on the one card):
    each case of SHARD_TRAIN_CASES through the ShardedTrainer on its
    partition from ``parts`` (shard_builds), then the AutoTrainer over
    4 data ranks (the em_user stand-in, BCSR) and over 2 graph ranks (the
    density-scale dense graph)."""
    from glass_tpu_torch.parallel import AutoTrainer, ShardedTrainer, make_mesh
    from glass_tpu_torch.ops.collectives import transport

    torch.cuda.set_device(0)
    device = torch.device("cuda")
    pos_b, y_b = shard_problem()
    mesh = make_mesh(graph_shards=SHARD_MESH[1], data_shards=SHARD_MESH[0])
    out = dict(backend=mesh.backend,
               transport=transport(mesh.graph_group, device), cases={})
    feats = {}
    for case, (edges, kw, mode) in SHARD_TRAIN_CASES.items():
        if edges not in feats:
            feats[edges] = degree_features(*named_edges(edges))
        pg, load_s = load_partition(parts[case][0])
        model = em_user_model(int(feats[edges].max()), mode, device)
        trainer = ShardedTrainer(model, pg, feats[edges], shard_cfg(), mesh)
        trainer.init(0)
        del pg
        out["cases"][case] = dict(rank_epoch(trainer, pos_b, y_b),
                                  partition_s=parts[case][1], load_s=load_s)
        del trainer, model
        torch.cuda.empty_cache()
    # the AutoTrainer: the batch over 4 data ranks, on the whole graph
    ei, n = clustered_graph()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="bcsr", device=device)
    f = feats["em_user"]
    trainer = AutoTrainer(em_user_model(int(f.max()), "pallas", device),
                          graph, f, shard_cfg(AUTO_DATA_BATCH),
                          make_mesh(graph_shards=1, data_shards=4))
    trainer.init(0)
    out["cases"]["auto_data"] = rank_epoch(trainer,
                                           *shard_problem(AUTO_DATA_BATCH))
    del trainer, graph, ei
    # ... and the dense rows over 2 graph ranks
    ei, n = density_edges()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_dense=True,
                        device=device)
    f = degree_features(ei, n)
    trainer = AutoTrainer(em_user_model(int(f.max()), "dense", device),
                          graph, f, shard_cfg(),
                          make_mesh(graph_shards=2, data_shards=2))
    trainer.init(0)
    dpos, dy = density_problem()
    out["cases"]["auto_graph"] = rank_epoch(trainer, dpos, dy)
    return out


def density_problem():
    """SHARD_STEPS batches of em_user's batch size on the density stand-in:
    random 5-node subgraphs (the density task's size), random labels."""
    rng = np.random.default_rng(62)
    bsz = EM_USER["batch_size"]
    pos = np.stack([rng.choice(DENSITY_N, 5, replace=False)
                    for _ in range(SHARD_STEPS * bsz)])
    y = rng.integers(0, 2, SHARD_STEPS * bsz).astype(np.float32)
    return pos.reshape(SHARD_STEPS, bsz, 5), y.reshape(SHARD_STEPS, bsz)


def reference_losses(graph, mode, feats_np, pos_b, y_b, device) -> list:
    """The one-process card Trainer's step losses on ``graph``."""
    feats = torch.from_numpy(feats_np).to(device)
    trainer = Trainer(em_user_model(int(feats_np.max()), mode, device),
                      graph, feats, shard_cfg(pos_b.shape[1]))
    trainer.init(0)
    return [float(v) for v in trainer.train_epoch(pos_b, y_b).step_losses]


def shard_launch_want(case: str) -> dict:
    """The card launches one rank runs in SHARD_STEPS steps of ``case``: 2
    per conv layer and step of each kernel its layout has."""
    per = 2 * EM_USER["conv_layer"] * SHARD_STEPS
    kw = SHARD_TRAIN_CASES.get(case, (None, {}, None))[1]
    dt = {"f32": "float32", "int8": "int8"}[kw.get("dense_dtype", "f32")]
    layout = kw.get("sparse_layout") if kw.get("materialize_bcsr") else None
    if case == "auto_data":
        layout = "bcsr"
    return counts_form(bcsr={dt: per} if layout in ("bcsr", "hybrid") else None,
                       band={dt: per} if layout in ("band", "hybrid") else None)


def phase_sharded_train(device, records: list, parts: dict) -> dict:
    """[sharded_train]: SHARD_STEPS steps of each case on 4 ranks (2 data
    x 2 graph) spawned on the one card over gloo (the host transport: NCCL
    refuses two ranks of one communicator on one device), against the
    one-process card Trainer on the same layout and batches (the reference
    built and trained here while the ranks run); each rank's launches read
    from the card's counters. Fills the per-shard records' launches. Returns
    the bcsr_f32 reference losses (for [sharded_nccl])."""
    import concurrent.futures
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks_f = ex.submit(spawn, sharded_train_rank,
                            SHARD_MESH[0] * SHARD_MESH[1], args=(parts,),
                            timeout=900)
        pos_b, y_b = shard_problem()
        refs, ref_s = {}, {}
        seg = {}
        for case, (edges, kw, mode) in SHARD_TRAIN_CASES.items():
            t1 = time.perf_counter()
            g = None
            ei, n = named_edges(edges)
            feats = degree_features(ei, n)
            if mode == "segment":
                if edges not in seg:
                    g = build_graph(ei, None, n, EM_USER["aggr"],
                                    materialize_dense=False, device=device)
                    seg[edges] = reference_losses(g, "segment", feats, pos_b,
                                                  y_b, device)
                refs[case] = seg[edges]
            else:
                g = build_graph(ei, None, n, EM_USER["aggr"],
                                materialize_dense=False, materialize_bcsr=True,
                                sparse_layout=kw["sparse_layout"],
                                dense_dtype=kw.get("dense_dtype", "f32"),
                                device=device)
                refs[case] = reference_losses(g, mode, feats, pos_b, y_b,
                                              device)
                if case == "bcsr_f32":
                    refs["auto_data"] = reference_losses(
                        g, mode, feats, *shard_problem(AUTO_DATA_BATCH),
                        device)
            ref_s[case] = time.perf_counter() - t1
            g = None
        ei, n = density_edges()
        g = build_graph(ei, None, n, EM_USER["aggr"], materialize_dense=True,
                        device=device)
        dpos, dy = density_problem()
        refs["auto_graph"] = reference_losses(g, "dense",
                                              degree_features(ei, n), dpos,
                                              dy, device)
        ranks = ranks_f.result()
    seconds = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        check(out["backend"] == "gloo" and out["transport"] == "host",
              f"rank {r}: backend {out['backend']}, {out['transport']}")
    totals = {}
    for case, ref in refs.items():
        got = [out["cases"][case] for out in ranks]
        int8 = case.endswith("int8")
        rtol = SHARD_Q_LOSS_RTOL if int8 else SHARD_LOSS_RTOL
        for r, res in enumerate(got):
            check(res["losses"] == got[0]["losses"],
                  f"{case}: rank {r} losses {res['losses']} != rank 0's")
            check(np.isfinite(res["losses"]).all(), f"{case}: non-finite")
            check(np.allclose(res["losses"], ref, rtol=rtol, atol=0),
                  f"{case}: rank losses {res['losses']} vs one-process "
                  f"{ref} (rtol {rtol})")
            want = shard_launch_want(case)
            check(res["card"] == want,
                  f"{case}: rank {r}'s card ran {res['card']}, expected "
                  f"{want}")
            check(res["counted"]["bcsr"] == want["bcsr"]
                  and res["counted"]["band"] == want["band"],
                  f"{case}: rank {r}'s wrappers counted {res['counted']}")
        for kind in ("bcsr", "band"):
            for dt, k in got[0]["card"][kind].items():
                key = (kind, dt, "hybrid" if case.startswith("hybrid")
                       else "")
                if not case.startswith("auto"):
                    totals[key] = totals.get(key, 0) + sum(
                        res["card"][kind][dt] for res in got)
        emit("sharded_train", case=case, mesh=list(SHARD_MESH)
             if case != "auto_data" else [4, 1],
             batch=AUTO_DATA_BATCH if case == "auto_data"
             else EM_USER["batch_size"],
             losses=got[0]["losses"], one_process_losses=ref,
             max_rel_diff=float(np.max(np.abs(np.subtract(
                 got[0]["losses"], ref)) / np.abs(ref))),
             launches_per_rank=got[0]["card"],
             ms_per_step=[res["ms_per_step"] for res in got],
             partition_s=got[0].get("partition_s"),
             load_s=[res.get("load_s") for res in got],
             reference_build_train_s=ref_s.get(case))
    for rec in records:
        kind, dt = rec["name"].split("_spmm_shard_")
        dt, _, part = dt.partition("_")
        rec["launches"] = totals.get(
            (kind, {"f32": "float32", "int8": "int8"}[dt], part), 0)
        check(rec["launches"] > 0, f"{rec['name']}: no launch on the main "
              "path")
    emit("sharded_train_done", ranks=len(ranks), backend="gloo",
         transport="host", seconds=seconds)
    return refs


def sharded_nccl_rank(rank: int, path: str) -> dict:
    """[sharded_nccl]: world size 1 over NCCL, the BCSR layout (K = 1,
    saved at ``path``)."""
    from glass_tpu_torch.parallel import ShardedTrainer, make_mesh
    from glass_tpu_torch.ops.collectives import transport

    torch.cuda.set_device(0)
    device = torch.device("cuda")
    feats = degree_features(*clustered_graph())
    pg, _ = load_partition(path)
    mesh = make_mesh(graph_shards=1, data_shards=1)
    trainer = ShardedTrainer(em_user_model(int(feats.max()), "pallas",
                                           device),
                             pg, feats, shard_cfg(), mesh)
    trainer.init(0)
    check(trainer.graph.axis is not None, "no graph axis at world size 1")
    pos_b, y_b = shard_problem()
    return dict(rank_epoch(trainer, pos_b, y_b), backend=mesh.backend,
                transport=transport(mesh.graph_group, device))


def phase_sharded_nccl(device, refs: dict, path: str) -> None:
    t0 = time.perf_counter()
    out = spawn(sharded_nccl_rank, 1, args=(path,), backend="nccl",
                timeout=600)[0]
    ref = refs["bcsr_f32"]
    check(out["backend"] == "nccl" and out["transport"] == "device",
          f"backend {out['backend']}, transport {out['transport']}")
    check(np.allclose(out["losses"], ref, rtol=SHARD_NCCL_RTOL, atol=0),
          f"NCCL world-1 losses {out['losses']} vs one-process {ref}")
    check(out["card"] == shard_launch_want("bcsr_f32"),
          f"the card ran {out['card']}")
    emit("sharded_nccl", backend="nccl", transport="device",
         losses=out["losses"], one_process_losses=ref,
         launches=out["card"], ms_per_step=out["ms_per_step"],
         seconds=time.perf_counter() - t0)


def sharded_cli_rank0(argv: list) -> None:
    """Rank 0 of [sharded_cli], in its own process: glass_test.main(argv)
    under EpochProbe; prints the log, then one SHARDED_CLI JSON line with
    the epochs and the trainer the run built."""
    from glass_tpu_torch.cli import glass_test

    out = io.StringIO()
    with EpochProbe() as probe, contextlib.redirect_stdout(out):
        mean, err = glass_test.main(argv)
    trainer = probe.trainer
    print(out.getvalue(), end="")
    print("SHARDED_CLI " + json.dumps(dict(
        mean=mean, err=err, trainer=type(trainer).__name__,
        mesh=trainer.mesh.shape,
        layout=("band" if trainer.graph.band is not None else "")
        + ("bcsr" if trainer.graph.bcsr is not None else ""),
        epochs=[dict(loss=e["loss"], steps=e["steps"], host_ms=e["host_ms"])
                for e in probe.epochs])), flush=True)


END_LINE = re.compile(r"end: epoch (\d+), train time (\S+) s, val (\S+), "
                      r"tst (\S+)$")


def phase_sharded_cli(tmp: Path) -> None:
    """[sharded_cli]: glass_test on the em_user stand-in over 2 graph x 2
    data ranks, --spmm pallas, 4 processes on the one card
    (--coordinator/--num_processes/--process_id, --cpu_collectives gloo;
    rank 0 under EpochProbe). Rank 0's log in JAX's format, its epoch
    losses finite and falling; ranks 1-3 silent past their bootstrap line.
    The stand-in's parse is cached first (every rank loads it)."""
    from glass_tpu_torch.data.loaders import load_dataset

    t0 = time.perf_counter()
    load_dataset("em_user", np.random.default_rng(0), str(tmp / "data"))
    argv = ["--dataset", "em_user", "--use_deg", "--use_maxzeroone",
            "--data_root", str(tmp / "data"), "--spmm", "pallas",
            "--graph_shards", "2", "--data_shards", "2",
            "--max_epochs", str(SHARD_CLI_EPOCHS),
            "--coordinator", f"file://{tmp / 'sharded_cli_rendezvous'}",
            "--num_processes", "4", "--cpu_collectives", "gloo"]
    here = str(Path(__file__).resolve().parent)
    rank0 = [sys.executable, "-c", f"import sys; sys.path.insert(0, {here!r}); "
             "import chip_smoke; chip_smoke.sharded_cli_rank0(sys.argv[1:])"]
    cmds = [rank0 + argv + ["--process_id", "0"]] + [
        [sys.executable, "-m", "glass_tpu_torch.cli.glass_test", *argv,
         "--process_id", str(i)] for i in (1, 2, 3)]
    texts = run_ranks(cmds, [tmp / f"sharded_cli_{i}.log" for i in range(4)],
                      timeout=600)
    for i, t in enumerate(texts):
        check(f"multihost: process {i}/4 backend=gloo" in t,
              f"rank {i}: no bootstrap line")
        check(i == 0 or "repeat 0" not in t,
              f"rank {i} logged past its bootstrap line")
    lines = texts[0].splitlines()
    res = json.loads(next(l for l in lines if l.startswith("SHARDED_CLI "))
                     .split(" ", 1)[1])
    ends = [m for m in map(END_LINE.match, lines) if m]
    check(lines.count("repeat 0 (seed 0)") == 1 and len(ends) == 1
          and int(ends[0][1]) == SHARD_CLI_EPOCHS
          and any(l.startswith("throughput: ") for l in lines)
          and any(l.startswith("average ") for l in lines)
          and math.isfinite(res["mean"]) and math.isfinite(res["err"]),
          f"sharded_cli log: {lines[-6:]}")
    losses = [e["loss"] for e in res["epochs"]]
    check(len(losses) == SHARD_CLI_EPOCHS and np.isfinite(losses).all()
          and losses[-1] < losses[0], f"sharded_cli epoch losses {losses}")
    check(res["trainer"] == "ShardedTrainer"
          and res["mesh"] == {"data": 2, "graph": 2},
          f"sharded_cli trained on {res['trainer']} {res['mesh']}")
    emit("sharded_cli", ranks=4, mesh=[2, 2], epochs=SHARD_CLI_EPOCHS,
         epoch_losses=losses, layout=res["layout"],
         ms_per_step=[e["host_ms"] / e["steps"] for e in res["epochs"]],
         log=[l for l in lines if l.startswith(("repeat", "end:",
                                                "throughput:", "average"))],
         seconds=time.perf_counter() - t0)


def phase_sharded(device, tmp: Path) -> list:
    """The sharded paths, in order: [sharded_kernels_main],
    [sharded_train], [sharded_nccl], [sharded_cli]; returns the per-shard
    kernels' records."""
    t0 = time.perf_counter()
    parts = shard_builds(tmp / "partitions")
    records = phase_sharded_kernels_main(device, parts)
    refs = phase_sharded_train(device, records, parts)
    phase_sharded_nccl(device, refs, parts["nccl"][0])
    phase_sharded_cli(tmp)
    emit("sharded", seconds=time.perf_counter() - t0)
    return records


def elapsed(t0: float, after: str) -> None:
    emit("elapsed", after=after, seconds=time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    paths = _build.build()
    notes = [line.strip() for p in paths.values()
             for line in p.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in paths.values()], ptxas=notes)
    phase_native(device)
    elapsed(t0, "native")

    phase_probe_small(device)
    records = phase_probe_main(device)
    with fused_norm(False):  # the unfused GraphNorm on the earlier paths
        phase_small(device)
        records.append(phase_main(device))
        phase_train_bcsr(device, records[-1])
        phase_band_small(device)
        phase_grad_small(device)
        phase_train_small(device)
        band_record, f32_score = phase_band_main(device)
        records.append(band_record)
        phase_kernel_q_small(device)
        phase_grad_q_small(device)
        phase_train_q_small(device)
        records.append(phase_band_q_main(device, f32_score))
        records.extend(phase_q_layouts_main(device))
        records.append(phase_dense_q_main(device))
        phase_planner_rates(device)
        phase_autotune(device)
        phase_planner_main(device)
        records.append(phase_hybrid_main(device))
    elapsed(t0, "hybrid_main")
    phase_kernel_norm_small(device)
    phase_norm_dx_draws(device)
    norm_records = phase_kernel_norm_main(device)
    phase_train_norm_small(device)
    phase_train_graph_small(device)
    phase_serve_graph_small(device)
    elapsed(t0, "serve_graph_small")
    emb_record = phase_embedding_bwd(device)
    routes = phase_train_graph(device, emb_record)
    records.append(emb_record)
    elapsed(t0, "train_graph")
    phase_remat(device, routes)
    del routes
    elapsed(t0, "remat")
    records.extend(phase_scale_ladder(device))
    elapsed(t0, "scale_ladder")
    with em_user_standin_dir() as tmp:
        phase_cli_em_user(device, norm_records, tmp)
        elapsed(t0, "cli_em_user")
        records.extend(phase_ssl_em_user(device, tmp / "data"))
        elapsed(t0, "ssl_em_user")
        phase_ssl_cli(device, tmp)
        elapsed(t0, "ssl_cli")
        splits = phase_seg_em_user(device, tmp / "data")
        phase_seg_depth(device, tmp / "data", splits)
        phase_profiling(device, splits, tmp)
        del splits
        elapsed(t0, "seg")
        phase_attention_small(device)
        records.extend(phase_sharded(device, tmp))
        elapsed(t0, "sharded")
    records.extend(norm_records.values())

    for record in records:
        record["us"] = record["ms"] * 1e3
        record["library_us"] = (None if record["library_ms"] is None
                                else record["library_ms"] * 1e3)
        record["max_abs_diff"] = record["max_abs_err"]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
