#!/usr/bin/env python3
"""Smoke run of the PyTorch port (targetdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py profile [hybrid|knn|block|train] [BATCH] [bf16]
    python3 chip_smoke.py duel [CHECKOUT]
    python3 chip_smoke.py margins [CHECKOUT]
    python3 chip_smoke.py cone
    python3 chip_smoke.py host [CHECKOUT] [STEPS]
    python3 chip_smoke.py gate [STEPS] [N_MOLS]
    python3 chip_smoke.py ddim [STEPS] [N_MOLS]
    python3 chip_smoke.py prop-gate [EPOCHS] [DIFF_STEPS]

With no arguments: builds the CUDA kernels from targetdiff_tpu_torch/csrc, holds each kernel
against its plain PyTorch version at the main path's shapes (the example
pocket: 572 atoms padded to 576, 32 ligand slots, K = 32, four complexes;
flagship width: 9 layers, hidden 128, 16 heads), holds the kNN kernel bit
for bit against knn_graph_exact at B=4, B=100 and the train step's shape
(each timed beside its bound and torch.topk of a precomputed d2), holds
the node launch, the
x2h edge launch and the h2x edge launch alone against their plain versions
(the edge launches at float32-grade bars) and times each beside its bound
(the node launch also beside `torch.addmm` of its projection and the whole
function as a short PyTorch chain, and again alone at kNN B=100 for both
passes: `node_b100_fields`), holds the
edge-weight launch against float64 at B=4 and at the bench's B=100, then samples
molecules for that pocket through the port's entry point
`sample_diffusion_ligand` with seeded random flagship weights, and checks the
outputs. [ddim-sample] holds single strided jumps of `sample_step` (ddim at
eta 0 and 1, dpm2, the final jump) on the kernels against the eager path
with the same noise, then runs ddim-100 (uniform, eta 0), ddim-100
(quadratic, eta 1), dpm2-50 and a position-only 1000-step DDPM run with its
trajectory at the same shape, each with its launches counted exactly and
timed per network evaluation. [likelihood] holds `batch_likelihood_estimation` on the kernels
against the eager path with the same draws at tools/likebench.py's shape (8
synthetic complexes x 10 timesteps, 384 + 32 slots) and [embedding] holds
`fetch_embedding` (frozen coordinates: no h2x pass) against eager at the
likelihood CLI's padding (640 + 64 slots, B = 8), each with its launches
counted exactly and timed. Then the training
path: the train-mode block kernel and the block-VJP kernel against autograd
of the plain block and, within BWD64_BAR, of its float64 copy (two backward
runs bitwise equal), the backwards' weight-gradient kernel alone against
float64 at the shapes of the B=32 step's products (each timed beside its
bound and `torch.mm`), the backward's node kernel alone against float64 at
the B=32 step's rows for both passes (timed beside its bound and `torch.mm`
of its dh product), the backward's inverse adjacency alone bit for bit
against its plain version for both passes at the B=32 step's graph (timed
beside its bound and the plain version's stable torch.sort), the
backward's transposed second layers alone against float64 at the B=32
step's edges for both passes ([train-block tprod]: timed beside its bound
and `torch.mm` of the same product), the whole
loss and its gradients on the kernel path
against the eager path, `make_train_step` at the bench's train shape (B=32,
384-slot synthetic pockets), a short fit, and the train CLI's `run` on a
six-entry dataset, whose checkpoint is reloaded and sampled from. Then the
per-layer path: the per-layer attention kernels and their backwards against
the plain layers (the backwards also against their float64 copies, within
BWD64_BAR) on the hybrid graph (the example pocket with 64 ligand
slots: N = 640, K = 95) and the kNN graph, the node and edge launches alone
at the hybrid shape, 1000 DDPM steps of a hybrid model
through `sample_diffusion_ligand`, and the per-layer training loss
(`impl='fast_pl'`) against the eager one and its train step at B=32. [eval]
writes [sample]'s molecules to a result_0.pkl through the sampling CLI's
writer and scores them with the evaluation CLI's `evaluate_results`;
[gate-short] runs the port's quality gate (targetdiff_tpu_torch/tools/
quality_gate.py) at 200 train steps and 8 pockets x 4 molecules on the
kernel path and checks that its report is complete, not that its checks
pass. [likelihood-cli] runs the likelihood CLI from [train-cli]'s checkpoint
and `analyze_affinity` on the pickle it writes. [egnn-sample] runs the EGNN
denoiser (the flagship's widths, `model_type: egnn`) on the example pocket
against the CPU and for 1000 DDPM steps, one kNN launch per layer;
[egnn-train] its eager train step at [train]'s B=32 batch, the first loss
against the CPU's; [prop] PropPredNet at configs/prop/pdbbind_general_egnn.
yml's width (K = 48: the kNN kernel's rounds, bit for bit against
knn_graph_exact and timed) against the CPU and its Adam steps; [prop-enc]
PropPredNetEnc fed the flagship's final_h from the block kernels against
the eager final_h; [prop-cli] pdbbind_preparation -> train_prop -> eval_prop
-> inference_prop on copies of examples/3ug2; [prop-gate-short] the prop
gate at 2 epochs and 200 diffusion steps (report complete, checks need not
pass). [dp-train] and [dp-sample] run targetdiff_tpu_torch/tools/dryrun_multi
at full width: two ranks of one process group on this card over gloo (and,
on a machine with two cards, one card a rank over NCCL) take [train]'s B=32
step split 16 / 16 and 8 rows of the example pocket for 20 DDPM steps, each
held to one process in the same call, with each rank's launches, ms per
step and the gradient all-reduce's ms and bytes. After [egnn-train], the
uni_o2 options the released model does not use, eager, at its widths, the
graph on the kNN kernel (one launch a block call, no other kernel):
[variant-sample] runs V1 (ew_net_type r, the x2h output MLP) and V2
(ew_net_type m, two x2h and two h2x sub-layers, sync_twoup, swish, no norm,
the 'sin' time embedding) on the example pocket against the CPU and
through `sample_diffusion_ligand` (V1 1000 DDPM steps, V2 100);
[variant-train] their eager train step (V1 at [train]'s B = 32, V2 at the
largest of 32 / 16 / 8 that fits), the first loss against the CPU's, ms per
step and peak GiB; [bf16-eager] the bf16 model (model_dtype=torch.bfloat16)
of V1 and of the EGNN denoiser against the CPU (positions and final_h
within 2e-2 of scale, logits five bf16 ulps), V1's
bf16 train step beside float32's, and the train CLI with --dtype bf16 on V1
(the bf16 model trained eagerly, a float32 checkpoint).

[cone], after [forward], holds the sampler's dependency cone
(need_full_h=False, the last block computing only the rows a ligand output
reads) at kNN B=4 and B=100: `cone_kernel` bit for bit against its plain
version, one launch a call (torch.profiler), its grid and its phases'
clock64 cycles (cone.PHASES, and complex 0's levels: the stamped
instantiation, `cone.cone_phase_cycles`), the block kernels on the cone's
row lists against the all-live
block kernels (x and ligand h bit for bit, float32 and bf16), timed layer
by layer, and one sampling step under torch.cuda.set_sync_debug_mode(
"error") with one cone call; [sample] and the other sampling and
likelihood paths count one cone call a forward.

Sampling's default precision is bf16, as the JAX package's: the phases above
that hold the kernels to float32-grade bars ([forward], [sample],
[ddim-sample], [hybrid-sample], [embedding], the train CLI's sampling) pass
dtype=torch.float32; [gate-short], [dp-sample] and the `gate` and `ddim`
modes sample at the default. After [hybrid-sample], [bf16-block] holds the
bf16 block kernels (B=4, N=608, K=32, L=9) against the bf16 plain block and
float64 (x and ligand h within 2e-2 of scale, the JAX package's bf16 bar;
max and median printed) and each bf16 launch alone (node, x2h edge, h2x
edge, edge weights) the same way, timed beside its bound at the bf16
tensor-core rate (the x2h and h2x edge launches, x2h_edge_mma_kernel and
h2x_edge_mma_kernel, also at kNN B=100; two of each one's launches bitwise
equal, rows without an edge keeping h, or x, bitwise; the node launch
beside `torch.addmm` with bf16 operands and the PyTorch chain, and alone at
kNN B=100 for both passes); [bf16-layers] the bf16 per-layer kernels at the
hybrid shape (N = 640, K = 95), the x2h and h2x edge launches alone there
too; [bf16-sample] runs 1000 DDPM steps of B=4 at the
default precision on the kNN and the hybrid model, with the bf16 launches
counted exactly (the node kernel's in C, two a layer and step), no
float32 launch, and ms per step beside the float32 runs'. Each bf16 launch
has its own entry in the kernels' JSON line.
After [train-cli], bf16 training (`impl='fast_bf16'`, the JAX package's
bf16 training variant): [bf16-train-block] holds the bf16 train-mode
forward's checkpoints and the bf16 block backward (B=4, N=608, K=32, L=9)
against the bf16 plain block (autograd through precision.Bf16Linear) and
float64: checkpoints within 2e-2 of scale; every gradient within 1e-2 of
scale of the replay of the kernel's rounding points
(ops/kernels/block_vjp_replay.py) and within 2e-2 of the bf16 plain
version unless the replay itself lies that far from it, the median within
0.08 of float64 (`bf16_grad_margins`), with the float32 kernels timed beside;
[bf16-train-block weight-grad] / [... node-bwd] / [... tprod] the bf16
weight-gradient and node kernels and the transposed product alone;
[bf16-layers-bwd] the bf16 per-layer backwards at
the hybrid shape (N = 640, K = 95) and three `fast_bf16` steps of the
hybrid model; [bf16-train] 100 `fast_bf16` and 100 `fast` B=32 steps from
one init and one set of draws (the bf16 run's launches counted: bf16
training kernels only; both losses fall, the tail losses agree within 5%,
the parameters' change within a quarter of a float32 control's distance),
ms per step of each in turns and the device time by kernel;
[bf16-train-cli] the train CLI with --dtype bf16, its float32 checkpoint
sampled from. Every phase prints one line; any failure exits non-zero. The last two lines are a
JSON record of the kernels (each with its time, its plain version's time and
the least time the card could take for its work) and the contract line
{"ok": true, "device": {...}}.

`profile` traces 10 DDPM steps of hybrid (64 ligand slots: N = 640, K = 95)
or kNN (32 slots: N = 608, K = 32) sampling of BATCH molecules (default 4),
in float32 or, with a trailing `bf16`, in bf16, with torch.profiler: the device
time of each kernel and of the step, beside the host time of the same steps
run just before without the profiler; `profile block` the inference block
and the train-mode block forward on the same inputs, in turns, kernel by
kernel; `profile train` 5 `fast` B=32 train steps ([train]'s batch) after 3
warm-up steps, by kernel, beside the host time of 5 steps run just before,
and the backwards' own kernels per launch beside their bounds and the
PyTorch calls that compute the same function.
`duel` times the whole-block kernels (B=4, N=608, K=32), the node launch
and the x2h and h2x edge launches alone at the kNN shape, one per-layer x2h
and one h2x call at the hybrid shape with their kernels' device time, the
backwards' kernels' device time, 50 kNN and 50 hybrid sampling steps,
the B=32 `fast` and `fast_pl` train steps, and in bf16 the node launch
and the x2h and h2x edge launches alone at kNN B=4 and B=100 (with
digests), the per-layer x2h and h2x at the hybrid shape, the sampler's
forward's ligand outputs and of the embedding export (digests, both
precisions, kNN B=4 and B=100),
1000 kNN B=4 bf16 sampling steps, 10 kNN B=100 sampling steps in bf16 and
float32 (device time, node_kernel's, the edge kernels' and cone_kernel's
shares, the x2h edge and node launches one by one) and the B=32
`fast_bf16` step (device time, node_kernel's share) of the port found in
CHECKOUT (this checkout by default), through entry points
every version of the port since the per-layer slice has: run it once per
checkout, in turns, within one call,
to compare two versions on one card. `margins` gives the gradient margins
of [train-block] and of [layers]' hybrid backwards (against the plain
float32 versions and against float64, worst tensor of each) of CHECKOUT on
those phases' inputs. Each prints one JSON line that starts with the card's
name and power limit. `cone` runs [cone] alone (below). `host` times STEPS
(default 1000) kNN DDPM steps of B=4 molecules in bf16, the default
sampling precision, of this checkout's port by the host clock, and the
forward alone with every row and on the dependency cone in turns within
the process (`forward_host_ms`), then STEPS steps in ten rounds, the
order rotating, of this port with the cone, with the cone switched off
and, given CHECKOUT (a parent), CHECKOUT's port imported beside it in the
same process (`host_rounds`), and 20 traced steps of each with the host
operators whose time differs (one JSON line, as `duel`): the host-bound
step moves more between processes than between versions.

`gate` runs the port's quality gate in full (default 12000 `fast` train
steps of the flagship on the synthetic corpus, then 256 molecules of 32
pockets from the untrained and the trained weights, 1000 DDPM steps each,
scored against the corpus), writes quality_gate_torch.json beside the JAX
package's quality_gate.json (the report, the card's name and power limit,
train ms per step, sampling ms per step of each model, evaluation seconds)
and exits non-zero if any of its checks fails.

`ddim` runs the port's tools/ddim_eval.py (default 4000 `fast` train steps,
then 128 molecules of 32 pockets for each of its ten sampler rows, scored as
the gate scores them), writes ddim_eval_torch.json beside the JAX package's
ddim_eval.json (the rows, each with seconds, mol/s, network evaluations and
ms per evaluation of a sampling chunk, the card's name and power limit) and
exits non-zero if a row is missing, the kernels' launches do not match the
rows' network evaluations, ddim-100 loses more than 0.10 of ddpm-1000's
atom stability, or ddpm-100-trunc is not at least 0.30 below ddim-100.

`prop-gate` runs the port's prop gate (targetdiff_tpu_torch/tools/
prop_quality_gate.py; default 30 epochs and 1500 diffusion steps, the JAX
gate's), writes prop_quality_gate_torch.json beside the JAX package's
prop_quality_gate.json (the report, its checks, host times with the card's
name and power limit beside them) and exits non-zero if a check fails.

Needs a CUDA device and the CUDA toolkit (nvcc); there is no CPU path.
"""

from __future__ import annotations

import copy
import functools
import inspect
import json
import logging
import pickle
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
POCKET_PDB = REPO / "examples" / "1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb"
LIGAND_SDF = REPO / "examples" / "3ug2_ligand.sdf"

# the released TargetDiff architecture (configs/training.yml `model`)
FLAGSHIP = dict(
    model_mean_type="C0", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
    v_beta_schedule="cosine", v_beta_s=0.01, num_diffusion_timesteps=1000,
    loss_v_weight=100.0, sample_time_method="symmetric", time_emb_dim=0,
    time_emb_mode="simple", center_pos_mode="protein", node_indicator=True,
    model_type="uni_o2", num_blocks=1, num_layers=9, hidden_dim=128, n_heads=16,
    edge_feat_dim=4, num_r_gaussian=20, knn=32, num_node_types=8, act_fn="relu",
    norm=True, cutoff_mode="knn", ew_net_type="global", num_x2h=1, num_h2x=1,
    r_max=10.0, x2h_out_fc=False, sync_twoup=False,
)
NUM_CLASSES = 13  # add_aromatic ligand vocabulary
B, MAX_PROTEIN, MAX_LIGAND, K = 4, 576, 32, 32
LIGAND_SIZES = [32, 27, 21, 14]  # ligand atoms per complex in the parity phases
KNN_RTOL = 1e-4
POS_TOL = dict(atol=2e-4, rtol=1e-3)
H_TOL = dict(atol=2e-3, rtol=1e-2)
# The x2h edge kernel alone against the plain layer: its products are
# float32-grade (three-term fp16, ~2^-21), ~7e-7 from plain on h' of order 1.
# One fp16 product per term lands ~2e-4 away; tests/test_torch_x2h_edge.py
# holds replays of one fp16 or one bf16 product per term outside this bar.
X2H_TOL = dict(atol=1e-5, rtol=0.0)
# The h2x edge kernel alone against the plain layer, on positions: its k and
# v products are float32-grade too; one fp16 product per term lands ~5e-5 to
# ~1e-4 away (tests/test_torch_h2x_edge.py; on the card: PERF.md).
H2X_TOL = dict(atol=1e-5, rtol=0.0)
# The node kernel's projections against float64: the largest error over the
# largest |exact| entry of each output (three-term fp16 on rows scaled by a
# power of two; float32 itself sits ~1e-7 there).
NODE_REL = 4e-6
# The edge-weight kernel alone against float64, on the valid slots: its first
# layer is three-term TF32 (float32-grade, ~1e-7 from float64); one TF32
# product per term lands ~1e-4 away (node_ew_variants.py `one_term_ew`,
# tests/test_torch_edge_weights.py).
EW_TOL = dict(atol=1e-5, rtol=0.0)
# The backward's node kernel alone against float64: every output (dq1, the
# query LayerNorm's partials, qa, dh) within NODE_BWD_BAR of its scale, the
# largest |exact| entry (three-term TF32 products; one TF32 product per term
# misses it: node_ew_variants.py `one_term_node_bwd`).
NODE_BWD_BAR = 1e-5
GRAD_ATOL_SCALE, GRAD_RTOL = 5e-3, 5e-3  # atol = 5e-3 * max|plain grad| per tensor
# The backwards' gradients against float64 autograd of the plain layers (a
# float64 copy of the module) at the same inputs; for the block, the chain of
# its sub-layers' VJPs at the kernel's own checkpoints (block_vjp_chain).
# Per tensor the largest error over the tensor's largest |exact| entry, the
# k biases (zero in exact arithmetic) left out. The median over the tensors
# stays within BWD64_MEDIAN; a per-layer backward's every tensor within
# BWD64_BAR, whatever the plain float32 version's own error: on d x at the
# hybrid shape that is ~4e-3 and the kernel's ~1.5e-6, and a floor of 4x the
# plain error there let one TF32 product per term in d rbf through
# (edge_bwd_variants.py `one_term_drbf`). The kNN shape keeps that floor
# (BWD64_F32 times the plain error, each tensor): there the kernel and the
# plain layer sit equally far from float64, to three or four digits (d x
# ~2.9e-3, the k first layer's bias ~1.8e-3), an error of the float32
# inputs' geometry that any float32 version shares. Not so the block's every
# tensor: over nine layers any float32 order, the plain one too, lands a few
# tensors ~2e-3 from float64, each order others. Float32-grade backwards (the FMA
# recompute, the three-term fp16 one) sit at medians ~3e-6 and per-layer
# worsts ~1.5e-6; one fp16 product per term in the recompute at ~2e-4 to
# ~6e-4, which the bar of 5e-3 of scale against the plain float32 version
# above lets through (PERF.md §6; edge_bwd_variants.py `one_term`).
BWD64_BAR, BWD64_F32, BWD64_MEDIAN = 1e-4, 4.0, 2e-5
# The weight-gradient kernel alone against float64: |got - want| <= WG_BAR * s
# elementwise, s[p][q] = sqrt(sum_m X[m][p]^2 Y[m][q]^2) (float64), the
# root-sum-square of the entry's terms: rounding errors add like sqrt(M),
# so a bar on |X|^T |Y| would shrink with M. Float32-grade products
# (three-term TF32, the old FMA kernel) sit ~1e-7..3e-6 s from it, one TF32
# product per term ~3e-4 s (tests/test_torch_weight_grad.py).
WG_BAR = 1e-5
OPTIMIZER = dict(type="adam", lr=5e-4, weight_decay=0.0, beta1=0.95, beta2=0.999,
                 max_grad_norm=8.0)
TRAIN_B, TRAIN_PROTEIN, TRAIN_VALID, TRAIN_STEPS, TRAIN_WARMUP = 32, 384, 330, 20, 3
HYBRID_LIGAND = 64  # the sampling CLI's default ligand slots: hybrid K = 64 - 1 + 32 = 95
HYBRID_SIZES = [64, 45, 27, 14]  # ligand atoms per complex in the [layers] phase
TRAIN_PL_STEPS = 10
GATE_SHORT = dict(steps=200, n_mols=32, n_pockets=8)  # [gate-short]: 8 pockets x 4 molecules
# [likelihood]: tools/likebench.py's shape, C complexes x T / stride timesteps
LIKE_C, LIKE_PROTEIN, LIKE_VALID, LIKE_STRIDE = 8, 384, 330, 100
# [embedding] and [likelihood-cli]: the likelihood CLI's padding
CLI_PROTEIN, CLI_LIGAND = 640, 64
EMBED_SIZES = [64, 52, 45, 38, 32, 27, 21, 14]  # ligand atoms per complex in [embedding]
ELBO_TOL = dict(atol=2e-4, rtol=2e-3)  # the ELBO terms, kernels against eager (JAX's own bar)
POCKET_LIGAND_SDF = REPO / "examples" / "1h36_A_rec_1h36_r88_lig_tt_docked_0.sdf"
# [ddim-sample]: single jumps (sampler, t, s, eta), kernels against eager
DDIM_JUMPS = [("ddim", 900, 800, 0.0), ("ddim", 500, 400, 1.0), ("dpm2", 700, 600, 0.0),
              ("ddim", 30, -1, 0.0)]
# ... and whole runs through sample_diffusion_ligand (the pos_only run takes
# the pocket's own ligand's types and keeps its trajectory)
DDIM_RUNS = [("ddim-100", dict(num_steps=100, sampler="ddim", eta=0.0)),
             ("ddim-100-quad-eta1", dict(num_steps=100, sampler="ddim", eta=1.0,
                                         ddim_spacing="quadratic")),
             ("dpm2-50", dict(num_steps=50, sampler="dpm2", eta=0.0)),
             ("ddpm-1000-pos-only-traj", dict(num_steps=1000, sampler="ddpm", pos_only=True,
                                              return_traj=True))]
GUMBEL_MARGIN = 1e-3  # types are held equal where the sampled class leads by more

# The card's published peaks (NVIDIA H100 SXM data sheet): TF32 on the tensor
# cores, float32 outside them, and device memory.
PEAK_TF32_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 495e12, 67e12, 3.35e12
PEAK_BF16_FLOPS = 989e12  # bf16 on the tensor cores (dense): the bf16 kernels' products
# FLOP per live edge and per real node as (dense products, the rest), counted
# from the kernels' arithmetic at the released widths (hidden 128, 16 heads,
# 20 RBF knots). Dense products, each counted once at the TF32 rate: the
# second layers, the node projections, the query MLP's second layer, the
# products of the RBF features with the edge-type table (k|v first layers)
# and with the edge-weight MLP's first layer, and in the backwards their
# transposes and weight gradients (the RBF-table gradient and d rbf). The
# rest, at the float32 rate: the first layer's adds of the node projections
# and the edge-type row, the LayerNorms, the logits, softmax and weighted
# sums, and in the backwards the edge-type rows' gradient and the LayerNorm
# backward.
HW, NHEADS, RK = 128, 16, 20
_RBF = 2 * RK * 2 * HW  # rbf [RK] @ w_rbf[type] [RK, 2H]
_FIRST = 2 * 2 * HW * 3 + 2 * 8 * HW  # + ni_i + nj_j + w_et[type], LayerNorm + ReLU
FLOP_EDGE = {"x2h": np.array([4 * HW * HW + _RBF, _FIRST + 4 * HW]),
             "h2x": np.array([2 * HW * HW + 2 * HW * NHEADS + _RBF,
                              _FIRST + 2 * HW + 8 * NHEADS])}
_EDGE_BWD_EXTRA = np.array([2 * _RBF, 2 * 2 * HW + 2 * 10 * HW])
FLOP_EDGE_BWD = {"x2h": FLOP_EDGE["x2h"] + [8 * HW * HW, 0] + _EDGE_BWD_EXTRA,
                 "h2x": FLOP_EDGE["h2x"] + [4 * HW * HW + 4 * HW * NHEADS, 0] + _EDGE_BWD_EXTRA}
# edge_bwd_kernel alone per live edge: the backward less its weight-gradient
# products (second layers, RBF table)
FLOP_EDGE_KERNEL_BWD = {"x2h": FLOP_EDGE_BWD["x2h"] - [4 * HW * HW + _RBF, 0],
                        "h2x": FLOP_EDGE_BWD["h2x"] - [2 * HW * HW + 2 * HW * NHEADS + _RBF, 0]}
FLOP_NODE = np.array([2 * HW * 5 * HW + 2 * HW * HW, 8 * HW])
FLOP_NODE_BWD = 3 * FLOP_NODE  # recompute, input gradients, weight gradients
FLOP_SRC = np.array([2 * HW * 2 * HW, 0])  # a source row's k and v first-layer projections
FLOP_EW_EDGE = np.array([2 * RK * HW, 10 * HW + 3 * RK])  # global edge-weight MLP


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase(label: str, **fields) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device milliseconds per call of fn: every kernel it launches, summed
    over `calls` calls traced by torch.profiler after one warm-up call. Where
    a call's host time exceeds its kernels' (a single ctypes launch of a
    kernel of a few microseconds), CUDA events around the call time the host."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(k["ms"] for k in device_times(prof, calls).values())


def nbytes(*tensors) -> int:
    """Bytes of tensors (and of the values of dicts of tensors)."""
    total = 0
    for t in tensors:
        for u in (t.values() if isinstance(t, dict) else [t]):
            total += u.numel() * u.element_size()
    return total


def digest(torch, *tensors) -> str:
    """A short hash of the tensors' bytes (and of dicts' values, in key
    order): equal digests from two checkouts mean bitwise equal results."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        for u in ([t[k] for k in sorted(t)] if isinstance(t, dict) else [t]):
            h.update(u.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bound(flops, bytes_moved: float, tc_peak: float = PEAK_TF32_FLOPS) -> dict:
    """The least time the card could take: the largest of the dense products
    at the TF32 tensor-core rate (the bf16 kernels: tc_peak=PEAK_BF16_FLOPS),
    the other operations at the float32 rate and the bytes at the memory
    rate. `flops` is (dense products, rest)."""
    t_tc, t_f32 = flops[0] / tc_peak, flops[1] / PEAK_F32_FLOPS
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    return {"bound_ms": float(1e3 * max(t_tc, t_f32, t_bytes)),
            "bound_by": "bytes" if t_bytes > max(t_tc, t_f32) else "operations"}


def tc_share(flops) -> float:
    """The dense products' share of the operations."""
    return float(flops[0] / (flops[0] + flops[1]))


NODE_FIELDS = ("w_node", "b_node", "q_ln", "w_q2", "b_q2")


def pass_launcher(torch, kblock, h, x, nbh, mask_ligand, e_w, stacks, n_ligand, bf16=False):
    """The first layer of `stacks` launched piece by piece through the C
    entries: `.node()` the node kernel on every row (`td_block_node`, as the
    x2h pass launches it), `.node_rows()` as the h2x pass launches it (rows
    below row0 = N - n_ligand get only nj: `td_block_node_rows`; a tree
    without that entry launches `td_block_node`), `.x2h()` and `.h2x()` the
    edge launches alone (`td_block_x2h`, `td_block_h2x`) on the projections
    of the last node launch, into `.out` (h') and `.xout` (x', protein rows
    as x). `.bytes[name]` is what a launch must read and write (each input
    once, the rows it needs). bf16=True launches the `*_bf16` entries
    (stacks packed in bf16)."""
    from types import SimpleNamespace

    from targetdiff_tpu_torch.ops.rbf import gaussian_smearing_offsets

    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    dev = h.device
    row0 = N - n_ligand
    offsets, coeff = gaussian_smearing_offsets(device=dev)
    fns, pp = kblock._entries(), kblock._pass_structs(stacks, 1)[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    t = SimpleNamespace(h=h.contiguous(), x=x.contiguous(), idx=nbh.idx.contiguous(),
                        nmask=nbh.mask.contiguous(), mlig=mask_ligand.contiguous(),
                        ew=e_w.contiguous(), ni=torch.empty((B * N, 2 * H), device=dev),
                        nj=torch.empty((B * N, 2 * H), device=dev),
                        q=torch.empty((B * N, H), device=dev), out=torch.empty_like(h),
                        xout=x.contiguous().clone())
    graph = (t.idx.data_ptr(), t.nmask.data_ptr(), t.mlig.data_ptr(), t.ew.data_ptr(),
             t.ni.data_ptr(), t.nj.data_ptr(), t.q.data_ptr(), offsets.data_ptr(), coeff, pp, B,
             N, K)
    node_args = (pp, t.ni.data_ptr(), t.nj.data_ptr(), t.q.data_ptr())
    e_node, e_rows, e_x2h, e_h2x = (name + ("_bf16" if bf16 else "") for name in (
        "td_block_node", "td_block_node_rows", "td_block_x2h", "td_block_h2x"))

    def node():
        kblock.build.check(fns[e_node](t.h.data_ptr(), B * N, *node_args, stream), e_node)

    def node_rows():
        if e_rows not in fns:
            return node()
        kblock.build.check(fns[e_rows](t.h.data_ptr(), B, N, row0, *node_args, None, stream),
                           e_rows)

    def x2h():
        kblock.build.check(fns[e_x2h](t.h.data_ptr(), t.x.data_ptr(), *graph, 0,
                                      t.out.data_ptr(), stream), e_x2h)

    def h2x():
        kblock.build.check(fns[e_h2x](t.x.data_ptr(), *graph, row0, t.xout.data_ptr(), stream),
                           e_h2x)

    weights = {k: v[0] for k, v in stacks.items()}
    node_w = {k: v for k, v in weights.items() if k in NODE_FIELDS}
    edge_w = {k: v for k, v in weights.items() if k not in NODE_FIELDS}
    lig, src, either = h2x_rows(torch, nbh, row0)
    row_bytes = {"ni": 2 * H * 4, "q": H * 4, "graph": K * (8 + 1 + 4), "x": 3 * 4 + 1}
    node_bytes = nbytes(t.h, node_w)
    sizes = {
        "node": node_bytes + nbytes(t.ni, t.nj, t.q),
        "node_rows": node_bytes + nbytes(t.nj) + lig * (row_bytes["ni"] + row_bytes["q"]),
        "x2h": nbytes(t.x, t.mlig, t.nj, edge_w, offsets, t.h, t.idx, t.nmask, t.ew, t.ni, t.q,
                      t.out),
        # x' of the ligand rows; nj of the distinct sources of their valid
        # edges; x and the ligand flag of both
        "h2x": nbytes(edge_w, offsets) + src * 2 * H * 4 + either * row_bytes["x"]
        + lig * (row_bytes["graph"] + row_bytes["ni"] + row_bytes["q"] + 3 * 4),
    }
    return SimpleNamespace(node=node, node_rows=node_rows, x2h=x2h, h2x=h2x, out=t.out,
                           xout=t.xout, ni=t.ni, nj=t.nj, q=t.q, tensors=(t, offsets),
                           bytes=sizes)


def h2x_rows(torch, nbh, row0):
    """(destination rows, distinct sources of their valid edges, rows that are
    either) of an h2x pass over rows [row0, N) of each complex, summed over
    the complexes: the rows whose data the pass must read."""
    B, N, _ = nbh.idx.shape
    src = either = 0
    for b in range(B):
        s = torch.unique(nbh.idx[b, row0:][nbh.mask[b, row0:]])
        src += s.numel()
        either += int((s < row0).sum()) + N - row0
    return B * (N - row0), src, either


def node_chain(torch, h, px, bf16=False):
    """The node function as a short PyTorch chain on h [rows, 128] (a
    yardstick of the whole function, timed for information): `torch.addmm`
    of the projection, `layer_norm` and `relu` of q's first layer, `addmm`
    of its second; bf16: bf16 operands, the LayerNorm in float32."""
    F = torch.nn.functional
    H = h.shape[-1]
    dt = torch.bfloat16 if bf16 else torch.float32
    hd, w, b = h.to(dt), px["w_node"][0].to(dt), px["b_node"][0].to(dt)
    w2, b2, ln = px["w_q2"][0].to(dt), px["b_q2"][0].to(dt), px["q_ln"][0]

    def run():
        proj = torch.addmm(b, hd, w)
        z = F.relu(F.layer_norm(proj[:, 4 * H:].float(), (H,), ln[0], ln[1], 1e-5))
        return proj, torch.addmm(b2, z.to(dt), w2)

    return run


def node_b100_fields(torch, kblock, b100, px, ph, bf16=False) -> dict:
    """The node launch alone at kNN B=100 (`knn_b100`: 60,800 rows) on
    layer 0's weights, every row (as the x2h pass launches it) and with row0
    = N - 32 (as the h2x pass does): ni, nj (and float32: q) within NODE_REL
    of float64 of the same operands, bf16 q within BF16_BAR of the bf16
    plain version in float64, two launches bitwise equal; CUDA-event and
    device ms of both launches beside their bounds (bf16: at the bf16 rate),
    the plain version's ms, `torch.addmm` of the projection (one call; bf16
    operands for bf16) and the whole function as a PyTorch chain
    (`node_chain`)."""
    h, x, node_mask, mlig, nbh = b100
    H = h.shape[-1]
    h2d = h.reshape(-1, H)
    nodes, lig_nodes, _, _ = layer_work(nbh, mlig, node_mask)
    e_w = torch.zeros(nbh.idx.shape, device=h.device)  # the node launches read no e_w
    xl = pass_launcher(torch, kblock, h, x, nbh, mlig, e_w, px, MAX_LIGAND, bf16=bf16)
    hl = pass_launcher(torch, kblock, h, x, nbh, mlig, e_w, ph, MAX_LIGAND, bf16=bf16)
    label = "bf16-block" if bf16 else "block"
    with torch.no_grad():
        xl.node()
        got = (xl.ni.clone(), xl.nj.clone(), xl.q.clone())
        xl.node()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, (xl.ni, xl.nj, xl.q))):
            raise AssertionError(f"{label} node launch B=100: two launches differ")
        want = kblock.node_projections_plain(
            h2d.double(), px if bf16 else {k: v.double() for k, v in px.items()})
        rel = [float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        f = {"ni_nj_max_rel_err": max(rel[:2]), "q_max_rel_err": rel[2]}
        if not max(rel[:2] if bf16 else rel) < NODE_REL or not rel[2] < BF16_BAR:
            raise AssertionError(f"{label} node launch B=100: errors {rel} of scale "
                                 f"(bars {NODE_REL}; bf16 q {BF16_BAR})")
        del got, want
        dt = torch.bfloat16 if bf16 else torch.float32
        hd, w_node, b_node = h2d.to(dt), px["w_node"][0].to(dt), px["b_node"][0].to(dt)
        runs = {"node": xl.node, "node_h2x": hl.node_rows,
                "addmm": lambda: torch.addmm(b_node, hd, w_node),
                "chain": node_chain(torch, h2d, px, bf16)}
        for name, fn in runs.items():
            f[f"{name}_ms"] = cuda_ms(torch, fn)
            f[f"{name}_device_ms"] = device_ms(torch, fn)
        f["plain_ms"] = cuda_ms(torch, lambda: kblock.node_projections_plain(h2d, px), reps=5)
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS
    for name, flops, nb in (("node", node_flops("x2h", nodes, lig_nodes), xl.bytes["node"]),
                            ("node_h2x", node_flops("h2x", nodes, lig_nodes),
                             hl.bytes["node_rows"])):
        f.update({f"{name}_{k}": v for k, v in bound(flops, nb, peak).items()})
    f["rows"] = h2d.shape[0]
    return f


def piece_fields(torch, kblock, kel, layer, h, x, nbh, mask_ligand, e_w, px, ph, n_ligand,
                 work, label):
    """The node launch and the x2h and h2x edge launches alone on one layer's
    inputs (`pass_launcher`; h2x on the plain x2h layer's output), each held
    against its plain version: the edge launches at their float32-grade
    bars, the node projections (every row) at NODE_REL against float64.
    CUDA-event ms, device ms (`device_ms`) and bounds of each, the h2x pass's
    node launch (source-only protein rows) beside the full one, and
    `torch.addmm` for the node projection's [rows, 128] @ [128, 640] part (the
    library yardstick; float32, TF32 off). Returns the fields and the two
    launchers."""
    nodes, lig_nodes, edges, lig_edges = work
    H = h.shape[-1]
    with torch.no_grad():
        xl = pass_launcher(torch, kblock, h, x, nbh, mask_ligand, e_w, px, n_ligand)
        xl.node()
        xl.x2h()
        h_ref = kel.x2h_layer_plain(layer, h, x, nbh, mask_ligand, e_w)
        hl = pass_launcher(torch, kblock, h_ref, x, nbh, mask_ligand, e_w, ph, n_ligand)
        hl.node_rows()
        hl.h2x()
        x_ref = kel.h2x_layer_plain(layer, h_ref, x, nbh, mask_ligand, e_w)
        want = kblock.node_projections_plain(h.double().reshape(-1, H),
                                             {k: v.double() for k, v in px.items()})
        torch.cuda.synchronize()
        f = {"x2h_edge_max_abs_err": check_close(f"{label} x2h edge launch", xl.out, h_ref,
                                                 **X2H_TOL),
             "h2x_edge_max_abs_err": check_close(f"{label} h2x edge launch", hl.xout, x_ref,
                                                 **H2X_TOL)}
        rel = max(float((g.double() - w).abs().max() / w.abs().max())
                  for g, w in zip((xl.ni, xl.nj, xl.q), want))
        if not rel < NODE_REL:
            raise AssertionError(f"{label} node launch: relative error {rel} (bar {NODE_REL})")
        f["node_max_rel_err"] = rel
        h2d, w_node, b_node = h.reshape(-1, H), px["w_node"][0], px["b_node"][0]
        runs = {"x2h_edge": xl.x2h, "h2x_edge": hl.h2x, "node": xl.node,
                "node_h2x": hl.node_rows,
                "node_addmm": lambda: torch.addmm(b_node, h2d, w_node),
                "node_chain": node_chain(torch, h2d, px)}
        for name, fn in runs.items():
            f[f"{name}_ms"] = cuda_ms(torch, fn)
            f[f"{name}_device_ms"] = device_ms(torch, fn)
    for name, flops, nb in (("x2h_edge", edges * FLOP_EDGE["x2h"], xl.bytes["x2h"]),
                            ("h2x_edge", lig_edges * FLOP_EDGE["h2x"], hl.bytes["h2x"]),
                            ("node", node_flops("x2h", nodes, lig_nodes), xl.bytes["node"]),
                            ("node_h2x", node_flops("h2x", nodes, lig_nodes),
                             hl.bytes["node_rows"])):
        b = bound(flops, nb)
        f.update({f"{name}_bound_ms": b["bound_ms"], f"{name}_bound_by": b["bound_by"]})
    return f, xl, hl


def ew_launch_fields(torch, kblock, rn, x, nbh, packed, live_edges, prefix="ew") -> dict:
    """The edge-weight launch alone (`edge_weights_cuda`: td_block_ew, as the
    block launches it once per call) on positions x and graph nbh, held on
    the valid slots against the module's edge weights in float64 (EW_TOL),
    two launches bitwise equal: CUDA-event and device ms beside its bound
    (the edge-weight MLP of every live edge; x, idx, the weights and e_w
    moved once) and the plain version's (`edge_weights`, float32) ms. Keys
    start with `prefix`."""
    with torch.no_grad():
        got = kblock.edge_weights_cuda(x, nbh, packed)
        again = kblock.edge_weights_cuda(x, nbh, packed)
        want = copy.deepcopy(rn).double().edge_weights(x.double(), nbh)[..., 0]
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{prefix} launch: two launches differ")
        f = {"max_abs_err": check_close(f"{prefix} launch", got[nbh.mask].double(),
                                        want[nbh.mask], **EW_TOL)}
        del want

        def run():
            return kblock.edge_weights_cuda(x, nbh, packed)

        f.update(ms=cuda_ms(torch, run), device_ms=device_ms(torch, run),
                 plain_ms=cuda_ms(torch, lambda: rn.edge_weights(x, nbh)))
    f.update(bound(live_edges * FLOP_EW_EDGE, nbytes(x, nbh.idx, got, *packed.ew)))
    return {f"{prefix}_{k}": v for k, v in f.items()}


# The edge-weight kernel's cases off the main path (tests/test_torch_cuda.py,
# node_ew_variants.py): cutoff mode, complexes, ligand slots.
EW_CASES = {"knn_K32": ("knn", 4, MAX_LIGAND), "hybrid_K95": ("hybrid", 4, HYBRID_LIGAND),
            "knn_B100": ("knn", 100, MAX_LIGAND)}


def ew_case(torch, dev, case):
    """(refine_net, x, nbh, packed) of an EW_CASES case: a flagship model of
    seeded random weights (27 protein features) and its graph over random
    complexes of MAX_PROTEIN protein slots (the last 6 padded) and the case's
    ligand slots: kNN (K = 32) or hybrid (K = 64 - 1 + 32 = 95)."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock

    cutoff, nb, n_lig = EW_CASES[case]
    torch.manual_seed(0)
    model = DiffusionModel(Config(dict(FLAGSHIP, cutoff_mode=cutoff)), 27, NUM_CLASSES,
                           device=dev, max_protein=MAX_PROTEIN, max_ligand=n_lig)
    rn = model.net.refine_net
    n = MAX_PROTEIN + n_lig
    x = torch.randn((nb, n, 3), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev) * 4
    node_mask = torch.ones((nb, n), dtype=torch.bool, device=dev)
    node_mask[:, MAX_PROTEIN - 6:MAX_PROTEIN] = False
    mlig = (torch.arange(n, device=dev) >= MAX_PROTEIN).expand(nb, n)
    with torch.no_grad():
        return rn, x, rn.graph(x, node_mask, mlig), kblock.pack_block_params(rn)


def layer_work(nbh, mask_ligand, node_mask):
    """(real nodes, real ligand nodes, live x2h edges, live h2x edges) of a graph."""
    return (int(node_mask.sum()), int((mask_ligand & node_mask).sum()), int(nbh.mask.sum()),
            int(nbh.mask[mask_ligand].sum()))


def node_flops(sub, nodes, lig_nodes, bwd=False):
    """FLOP of one pass's node work. x2h updates every real row. h2x moves
    only the ligand rows and needs of the other rows only their source
    projections. A backward is three times its forward (recompute, input
    and weight gradients)."""
    full = FLOP_NODE_BWD if bwd else FLOP_NODE
    if sub == "x2h":
        return nodes * full
    src = 3 * FLOP_SRC if bwd else FLOP_SRC
    return nodes * src + lig_nodes * (full - src)


def block_flops(nodes, lig_nodes, edges, lig_edges, bwd=False):
    """FLOP of one layer's x2h and h2x passes over a graph."""
    flop_edge = FLOP_EDGE_BWD if bwd else FLOP_EDGE
    return (node_flops("x2h", nodes, lig_nodes, bwd) + node_flops("h2x", nodes, lig_nodes, bwd)
            + edges * flop_edge["x2h"] + lig_edges * flop_edge["h2x"])


def check_close(name, got, want, atol, rtol) -> float:
    """Raise unless |got - want| <= atol + rtol |want|; return max |got - want|."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: {int(bad.sum())} entries outside atol={atol} "
                             f"rtol={rtol}; max abs err {float(err.max())}")
    return float(err.max())


def check_grads(got: dict, want: dict) -> float:
    """Every gradient within GRAD_ATOL_SCALE * max|want| + GRAD_RTOL |want|;
    returns the largest error relative to its tensor's scale. The k
    second-layer biases have zero gradient in exact arithmetic (softmax shift
    invariance): theirs are float32 noise, held to 1e-5 of the largest grad."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if name.endswith("k_func.net.3.bias"):
            if float(g.abs().max()) > 1e-5 * top:
                raise AssertionError(f"{name}: {float(g.abs().max())} not ~0")
            continue
        scale = float(w.abs().max())
        err = check_close(name, g, w, GRAD_ATOL_SCALE * scale, GRAD_RTOL)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def loss_draws(torch, model, batch, gen):
    """Timesteps, position noise and categorical uniforms for a batch."""
    dev = batch.ligand_pos.device
    t = torch.randint(0, model.num_timesteps, (batch.num_graphs,), generator=gen, device=dev)
    eps = torch.randn(batch.ligand_pos.shape, generator=gen, device=dev)
    u = torch.rand(batch.ligand_v.shape + (NUM_CLASSES,), generator=gen, device=dev)
    return t, eps, u


def loss_vs_eager(torch, model, batch, t, eps, u, label, impls=("fast",)) -> dict:
    """get_diffusion_loss and every parameter gradient on each kernel path
    of `impls` against one eager run, same draws: loss within relative 1e-4,
    grads to `check_grads`. Returns each path's fields, by impl."""
    out = {}
    for name in (*impls, "eager"):
        model.net.zero_grad(set_to_none=True)
        loss = model.get_diffusion_loss(batch, time_step=t, pos_noise=eps, v_uniform=u,
                                        impl=name)["loss"]
        loss.backward()
        out[name] = (float(loss.detach()), {n: p.grad for n, p in model.net.named_parameters()})
    model.net.zero_grad(set_to_none=True)
    eager, fields = out.pop("eager"), {}
    for impl, fast in out.items():
        loss_rel = abs(fast[0] - eager[0]) / abs(eager[0])
        if not loss_rel < 1e-4:
            raise AssertionError(f"{label} {impl}: relative loss error {loss_rel}")
        fields[impl] = dict(loss=fast[0], loss_eager=eager[0], rel_err=loss_rel,
                            max_grad_err_over_scale=check_grads(fast[1], eager[1]),
                            params=len(fast[1]))
    return fields


def main(argv) -> int:
    if not (REPO / "targetdiff_tpu_torch").is_dir() or not POCKET_PDB.is_file():
        raise RuntimeError(f"chip_smoke.py runs from a checkout of the repository; {REPO} "
                           "lacks targetdiff_tpu_torch/ or the example pocket")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: torch.cuda.is_available() is False")
    if argv and argv[0] == "gate":
        return gate(torch, argv[1:])
    if argv and argv[0] == "ddim":
        return ddim(torch, argv[1:])
    if argv and argv[0] == "prop-gate":
        return prop_gate(torch, argv[1:])
    if argv:
        return measure(torch, argv)
    sys.path.insert(0, str(REPO))
    from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data, reconstruct_all
    from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import build
    from targetdiff_tpu_torch.ops.kernels import cone as kcone
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    # 1. device
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    log = (build.build_dir() / "build.log").read_text().splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    phase("build", seconds=build_s, dir=build.build_dir().relative_to(REPO))
    for ln in ptxas:
        print("  ptxas:", ln, flush=True)

    # inputs at the main path's shapes: the example pocket, centred, with
    # ligands at the pocket centre plus unit noise
    feat = FeaturizeProteinAtom()
    data = pdb_to_pocket_data(str(POCKET_PDB), feat)
    pocket = {"protein_pos": data["protein_pos"], "protein_feat": data["protein_atom_feature"]}
    model, batch, h, x, node_mask, mask_ligand, plain_nbh = knn_setup(torch, dev, pocket,
                                                                      feat.feature_dim)
    lpos, lv, lmask = batch.ligand_pos, batch.ligand_v, batch.ligand_mask
    rn = model.net.refine_net
    N = x.shape[1]

    # 3. kNN kernel against the plain version (tie-tolerant), then bit for bit
    # against knn_graph_exact at the sampling shapes (B=4, the bench's B=100)
    # and the train step's, each timed beside its bound and torch.topk
    nbh = kknn.knn_graph_cuda(x, node_mask, K)
    torch.cuda.synchronize()
    if not torch.equal(nbh.mask, plain_nbh.mask):
        raise AssertionError("knn: neighbour masks differ from the plain version")
    if not bool(((nbh.idx >= 0) & (nbh.idx < N)).all()):
        raise AssertionError("knn: an index lies outside [0, N)")
    x64 = x.double()

    def chosen_d2(idx):
        return ((x64[:, :, None] - G.gather_nodes(x64, idx)) ** 2).sum(-1)

    d2_k = torch.where(nbh.mask, chosen_d2(nbh.idx), 0.0)
    d2_p = torch.where(plain_nbh.mask, chosen_d2(plain_nbh.idx), 0.0)
    kth_k, kth_p = d2_k.amax(-1), d2_p.amax(-1)
    knn_err = float((kth_k - kth_p).abs().max())
    tol = KNN_RTOL * kth_p + 1e-6
    if bool(((kth_k - kth_p).abs() > tol).any()) or bool((d2_k > (kth_p + tol)[..., None]).any()):
        raise AssertionError(f"knn: K-th distances disagree (max abs err {knn_err})")
    same = float((nbh.idx == plain_nbh.idx)[nbh.mask].float().mean())
    knn_ms = cuda_ms(torch, lambda: kknn.knn_graph_cuda(x, node_mask, K))
    knn_plain_ms = cuda_ms(torch, lambda: G.knn_graph(x, node_mask, K))
    with torch.no_grad():
        _, x100, mask100, _ = model.net.embed(*pocket_batch(
            torch, dev, pocket, feat.feature_dim, MAX_LIGAND, LIGAND_SIZES * 25, 0))
    knn_shapes = {"B4": knn_fields(torch, x, node_mask), "B100": knn_fields(torch, x100, mask100),
                  "train": knn_fields(torch, *train_positions(torch, dev))}
    del x100, mask100
    knn_b4_bound = {k: knn_shapes["B4"][k] for k in ("bound_ms", "bound_by")}
    phase("knn", shape=f"B={B},N={N},K={K}", max_abs_err_kth_d2=knn_err,
          same_index_fraction=same, ms=knn_ms, plain_ms=knn_plain_ms, **knn_b4_bound,
          tensor_core_share=0.0, exact=knn_shapes)

    # 4. block kernels against the plain block, f32, flagship width
    packed = kblock.pack_block_params(rn)
    with torch.no_grad():
        h_p, x_p = rn.block_forward(h, x, plain_nbh, mask_ligand)
        h_k, x_k = kblock.block_denoiser_cuda(rn, h, x, plain_nbh, mask_ligand, MAX_LIGAND, packed)
    torch.cuda.synchronize()
    lig = mask_ligand
    x_err = check_close("block x (ligand rows)", x_k[lig], x_p[lig], **POS_TOL)
    h_err = check_close("block h (ligand rows)", h_k[lig], h_p[lig], **H_TOL)
    h_err_all = float((h_k - h_p).abs()[node_mask].max())
    moved = float((x_k - x).abs()[lig].max())
    if moved < 1e-3:
        raise AssertionError(f"block: ligand positions did not move ({moved})")
    with torch.no_grad():
        block_ms = cuda_ms(torch, lambda: kblock.block_denoiser_cuda(
            rn, h, x, plain_nbh, mask_ligand, MAX_LIGAND, packed), reps=10)
        block_plain_ms = cuda_ms(torch, lambda: rn.block_forward(h, x, plain_nbh, mask_ligand),
                                 reps=10)
    work = layer_work(plain_nbh, mask_ligand, node_mask)
    L = FLAGSHIP["num_layers"]
    block_work = L * block_flops(*work) + work[2] * FLOP_EW_EDGE
    block_bound = bound(block_work, nbytes(h, x, plain_nbh.idx, plain_nbh.mask, mask_ligand,
                                           packed.x2h, packed.h2x, *packed.ew, h_k, x_k))
    # the node, x2h edge and h2x edge launches alone on layer 0's inputs,
    # each against its plain version
    with torch.no_grad():
        e_w0 = rn.edge_weights(x, plain_nbh)[..., 0]
    px0, ph0 = ({k: v[:1] for k, v in st.items()} for st in (packed.x2h, packed.h2x))
    pieces, _, _ = piece_fields(torch, kblock, kel, rn.base_block[0], h, x, plain_nbh,
                                mask_ligand, e_w0, px0, ph0, MAX_LIGAND, work, "block")
    pieces.update(ew_launch_fields(torch, kblock, rn, x, plain_nbh, packed, work[2]))
    # the edge-weight launch at the bench's batch: the example pocket 100 times
    with torch.no_grad():
        h100, x100, mask100, mlig100 = model.net.embed(*pocket_batch(
            torch, dev, pocket, feat.feature_dim, MAX_LIGAND, LIGAND_SIZES * 25, 0))
        nbh100 = G.knn_graph(x100, mask100, K)
    live100 = int(nbh100.mask.sum())
    pieces.update(ew_launch_fields(torch, kblock, rn, x100, nbh100, packed, live100,
                                   prefix="ew_b100"))
    # and the x2h edge launch alone there (device time beside its bound)
    with torch.no_grad():
        xl100 = pass_launcher(torch, kblock, h100, x100, nbh100, mlig100,
                              rn.edge_weights(x100, nbh100)[..., 0], px0, MAX_LIGAND)
        xl100.node()
        pieces["x2h_edge_b100_device_ms"] = device_ms(torch, xl100.x2h, calls=5)
    b100 = bound(live100 * FLOP_EDGE["x2h"], xl100.bytes["x2h"])
    pieces.update({f"x2h_edge_b100_{k}": v for k, v in b100.items()})
    del xl100
    # and the node launch alone there, both passes
    pieces.update({f"node_b100_{k}": v for k, v in node_b100_fields(
        torch, kblock, (h100, x100, mask100, mlig100, nbh100), px0, ph0).items()})
    del h100, x100, mask100, mlig100, nbh100
    phase("block", shape=f"B={B},N={N},K={K},L={L},H=128,heads=16",
          max_abs_err_x=x_err, max_abs_err_h=h_err, max_abs_err_h_valid_rows=h_err_all,
          ms=block_ms, plain_ms=block_plain_ms, **block_bound,
          tensor_core_share=tc_share(block_work), **pieces)

    # whole forward: kernel-backed against eager, same inputs
    with torch.no_grad():
        fk = model.fast_apply(batch, lpos, lv, packed=packed, dtype=torch.float32)
        fp = model.apply(batch, lpos, lv)
    lm = lmask[..., None].expand(-1, -1, 3)
    fwd_pos_err = check_close("forward pos", fk["pred_ligand_pos"][lm], fp["pred_ligand_pos"][lm],
                              **POS_TOL)
    lmv = lmask[..., None].expand(-1, -1, NUM_CLASSES)
    fwd_v_err = check_close("forward logits", fk["pred_ligand_v"][lmv], fp["pred_ligand_v"][lmv],
                            **H_TOL)
    phase("forward", max_abs_err_pos=fwd_pos_err, max_abs_err_logits=fwd_v_err)
    cone = cone_phase(torch, dev, model, pocket, feat.feature_dim)

    # 5. sample through the port's entry point
    steps = model.num_timesteps
    kknn.LAUNCHES = kcone.LAUNCHES = 0
    kblock.LAUNCHES = kblock.EW_LAUNCHES = 0
    t0 = time.perf_counter()
    res = sample_diffusion_ligand(
        model, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(2),
        batch_size=B, num_steps=steps, max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND,
        rng=np.random.default_rng(2), dtype=torch.float32)
    wall = time.perf_counter() - t0
    knn_launches, block_launches, ew_launches = kknn.LAUNCHES, kblock.LAUNCHES, kblock.EW_LAUNCHES
    cone_launches = kcone.LAUNCHES
    if (knn_launches == 0 or block_launches == 0 or ew_launches != block_launches
            or cone_launches != block_launches):
        raise AssertionError(f"sampling did not launch the kernels (knn {knn_launches}, "
                             f"block {block_launches}, edge weights {ew_launches}, "
                             f"cone {cone_launches})")
    for pos, v in zip(res["pos"], res["v"]):
        if pos.shape != (len(v), 3) or not np.isfinite(pos).all():
            raise AssertionError("sampling produced a non-finite or misshaped molecule")
        if not ((v >= 0) & (v < NUM_CLASSES)).all():
            raise AssertionError("sampling produced an atom type outside the vocabulary")
    sizes = [len(v) for v in res["v"]]
    dist = float(max(np.linalg.norm(p.mean(0) - pocket["protein_pos"].mean(0)) for p in res["pos"]))
    sdf = REPO / "outputs" / "chip_smoke_samples.sdf"
    sdf.parent.mkdir(exist_ok=True)
    sdf.unlink(missing_ok=True)
    rebuilt = reconstruct_all(res["pos"], res["v"], "add_aromatic", str(sdf),
                              logging.getLogger("chip_smoke"))
    sample_s = res["time"][0]
    phase("sample", samples=B, steps=steps, ligand_atoms=sizes, seconds=sample_s,
          wall_seconds=wall, ms_per_step=1e3 * sample_s / steps, mol_per_s=B / sample_s,
          knn_launches=knn_launches, block_launches=block_launches, ew_launches=ew_launches,
          cone_launches=cone_launches, max_centroid_offset_A=dist, reconstructed=f"{len(rebuilt)}/{B}")
    eval_phase(res)
    ddim_launches = ddim_sample_phase(torch, dev, model, pocket, batch, 1e3 * sample_s / steps)
    like_launches = likelihood_phase(torch, dev, model)
    embed_launches = embedding_phase(torch, dev, model, pocket, feat.feature_dim)

    layers = layer_phases(torch, dev, feat, pocket, rn, h, x, plain_nbh, mask_ligand, node_mask)
    failures = []
    hybrid_launches, hybrid_ms = hybrid_sample_phase(torch, dev, pocket, layers["model"],
                                                     failures)
    bf16 = {"block": bf16_block_phase(torch, kblock, kel, rn, h, x, plain_nbh, mask_ligand,
                                      node_mask, work,
                                      knn_b100(torch, dev, model, pocket, feat.feature_dim)),
            "layers": bf16_layers_phase(torch, dev, kel, pocket, feat.feature_dim),
            "launches": bf16_sample_phase(torch, dev, model, layers["model"], pocket,
                                          1e3 * sample_s / steps, hybrid_ms, failures)}
    train = train_phases(torch, dev, model, rn, h, x, plain_nbh, mask_ligand, node_mask, batch,
                         pocket, feat, layers["model"], layers["batch"])
    bf16_train = bf16_train_phases(torch, dev, rn, h, x, plain_nbh, mask_ligand, node_mask,
                                   pocket, feat.feature_dim)
    cli_launches = likelihood_cli_phase(torch, train["checkpoint"])
    gate_short_phase(torch, dev)
    egnn = egnn_phases(torch, dev, pocket, feat.feature_dim, batch)
    variant = variant_phases(torch, dev, pocket, feat.feature_dim, batch)
    bf16_eager = bf16_eager_phase(torch, dev, pocket, feat.feature_dim, batch,
                                  variant["train"]["V1"])
    prop = prop_phases(torch, dev, model, batch)
    prop_cli_phase(torch, dev)
    prop_gate_short_phase(torch, dev)
    dp = dp_phases(torch, pocket)
    if failures:
        raise AssertionError("; ".join(failures))

    no_library = {"library_ms": None}  # no single PyTorch call computes any of these functions

    def by_path(key):
        """A kernel's launches on the strided-sampling, likelihood, embedding
        and likelihood-CLI paths."""
        return {"launches_ddim_sample": ddim_launches[key],
                "launches_likelihood": like_launches[key], "launches_embedding":
                embed_launches[key], "launches_likelihood_cli": cli_launches[key]}

    print(json.dumps({"kernels": [
        {"name": "knn_graph", "route": "cuda", "source": "targetdiff_tpu_torch/csrc/knn.cu",
         "replaces": "targetdiff_tpu/ops/pallas/knn.py:27", "launches": knn_launches,
         "max_abs_err": knn_err, "ms": knn_ms, "plain_ms": knn_plain_ms, **knn_b4_bound,
         "topk_ms": knn_shapes["B4"]["topk_ms"], **by_path("knn"),
         "launches_egnn_sample": egnn["sample"], "launches_egnn_train": egnn["train"],
         "launches_variant_sample": variant["sample"],
         "launches_variant_train": {k: v["knn_launches"] for k, v in variant["train"].items()},
         "launches_bf16_eager": bf16_eager,
         "launches_prop": prop["train"], "launches_dp_train_rank0": dp["knn"]["train"],
         "launches_dp_sample_rank0": dp["knn"]["sample"], "rounds_shape": prop["rounds"]["shape"],
         **{f"rounds_{k}": prop["rounds"][k] for k in ("ms", "device_ms", "bound_ms",
                                                       "bound_by", "plain_ms", "topk_ms")},
         **no_library},
        {"name": "block_denoiser", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/block_denoiser.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_denoiser.py:154",
         "launches": block_launches, "max_abs_err": max(x_err, h_err), "ms": block_ms,
         "plain_ms": block_plain_ms, **block_bound, **by_path("block"),
         "launches_dp_sample_rank0": dp["block"]["sample"],
         "h2x_passes_embedding": embed_launches["h2x_pass"], **no_library},
        {"name": "cone_kernel", "route": "cuda", "source": "targetdiff_tpu_torch/csrc/cone.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_denoiser.py:154",
         "flags_of": "targetdiff_tpu/ops/pallas/block_denoiser.py:711",
         "launches": cone_launches, **by_path("cone"),
         "launches_bf16_sample": bf16["launches"]["knn"]["cone"],
         "launches_dp_sample_rank0": dp["cone"]["sample"], **cone, **no_library},
        {"name": "block_denoiser.ew", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/block_denoiser.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_denoiser.py:319", "launches": ew_launches,
         **{k: pieces[f"ew_{k}"] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by")}, **by_path("ew"), **no_library},
        *bf16_kernel_entries(bf16, dp),
        {"name": "block_denoiser_train", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/block_denoiser.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_denoiser.py:154", **train["fwd"],
         "launches_dp_train_rank0": dp["block_train"]["train"], **no_library},
        {"name": "block_vjp", "route": "cuda", "source": "targetdiff_tpu_torch/csrc/block_vjp.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_vjp.py:113", **train["bwd"],
         "launches_dp_train_rank0": dp["block_vjp"]["train"], **no_library},
        *[{"name": f"block_vjp.weight_grad_{cls}", "route": "cuda",
           "source": "targetdiff_tpu_torch/csrc/weight_grad.cuh",
           "replaces": "targetdiff_tpu/ops/pallas/block_vjp.py:113", **fields}
          for cls, fields in train["weight_grad"].items()],
        {"name": "block_vjp.stage_w2", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/pass_bwd.cuh",
         "replaces": "targetdiff_tpu/ops/pallas/block_vjp.py:113", **train["stage_w2"],
         **no_library},
        {"name": "block_vjp.adjacency", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/pass_bwd.cuh",
         "replaces": "targetdiff_tpu/ops/pallas/block_vjp.py:113", **train["adjacency"],
         **no_library},
        {"name": "block_vjp.node_bwd", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/node_bwd.cuh",
         "replaces": "targetdiff_tpu/ops/pallas/edge_layer_vjp.py:153", **train["node_bwd"],
         **no_library},
        {"name": "x2h_layer", "route": "cuda", "source": "targetdiff_tpu_torch/csrc/edge_layer.cu",
         "replaces": "targetdiff_tpu/ops/pallas/edge_layer.py:189",
         "launches": hybrid_launches["x2h"], **layers["x2h"], **no_library},
        {"name": "h2x_layer", "route": "cuda", "source": "targetdiff_tpu_torch/csrc/edge_layer.cu",
         "replaces": "targetdiff_tpu/ops/pallas/edge_layer.py:235",
         "launches": hybrid_launches["h2x"], **layers["h2x"], **no_library},
        {"name": "x2h_layer_bwd", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/edge_layer_vjp.cu",
         "replaces": "targetdiff_tpu/ops/pallas/edge_layer_vjp.py:231",
         "launches": train["pl_launches"]["x2h_bwd"], **layers["x2h_bwd"], **no_library},
        {"name": "h2x_layer_bwd", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/edge_layer_vjp.cu",
         "replaces": "targetdiff_tpu/ops/pallas/edge_layer_vjp.py:351",
         "launches": train["pl_launches"]["h2x_bwd"], **layers["h2x_bwd"], **no_library},
        *bf16_train,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def launches_per_call(torch, fn, piece, calls=3) -> float:
    """Launches of the kernels whose name holds `piece` per call of fn, as
    torch.profiler sees them over `calls` traced calls after a warm-up."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(v["launches"] for k, v in device_times(prof, calls).items() if piece in k)


@functools.lru_cache(maxsize=None)
def max_sm_clock_mhz() -> float:
    """The card's top SM clock (MHz), as nvidia-smi gives it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True)
    return float(smi.stdout.strip().splitlines()[0])


def launch_device_ms(torch, fn, piece, calls=3) -> list:
    """Device ms of each launch of the kernels whose name holds `piece` in
    one call of fn, in launch order, the mean over `calls` traced calls after
    one warm-up call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return per_launch_ms(prof, piece, calls)


def per_launch_ms(prof, piece, calls) -> list:
    """From a trace of `calls` equal calls: the device ms of each launch of
    the kernels whose name holds `piece` within a call, in launch order,
    averaged over the calls; None where the trace lost a launch (its count
    not a multiple of `calls`)."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and piece in e.name),
                 key=lambda e: e.time_range.start)
    if len(evs) % calls:
        return None
    n = len(evs) // calls
    return [float(np.mean([evs[c * n + i].time_range.elapsed_us() for c in range(calls)])) / 1e3
            for i in range(n)]


CONE_B = (4, 100)  # [cone]: the example pocket 4 and 100 times (kNN, N = 608, K = 32)


def cone_phase(torch, dev, model, pocket, feat_dim) -> dict:
    """[cone]: the sampler's dependency cone (need_full_h=False) at kNN B=4
    and B=100. `cone_kernel` against its plain version (hop, order, counts)
    bit for bit, two calls and the stamped launch equal, one launch a call,
    timed beside its bytes bound (the lists of the rows of hop <= L), the
    plain version and the stable torch.argsort of the hops, with its grid
    and each phase's cycles (the largest over the blocks); the live rows of each
    layer (x2h: hop <= L - l; node: hop <= L - l + 1; the h2x pass's
    sources: hop <= 1). In float32 and bf16: the block kernels on the
    cone's row lists against the all-live block kernels, x and the ligand
    rows of h bitwise equal, two launches bitwise equal, both timed (CUDA
    events and device ms, the x2h edge launches and node launches layer by
    layer); the forward's ligand outputs (need_full_h=False against True)
    bitwise equal; one `sample_step` under torch.cuda.set_sync_debug_mode(
    "error") (no host synchronisation) with one cone call, L x2h and L h2x
    pass launches and 2L node launches. Returns the kernels line's fields
    of `cone_kernel` (B=4; B=100 under b100_)."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import cone as kcone
    from targetdiff_tpu_torch.ops.kernels import knn as kknn

    rn = model.net.refine_net
    L = FLAGSHIP["num_layers"]
    fields = {}
    for nb in CONE_B:
        batch = pocket_batch(torch, dev, pocket, feat_dim, MAX_LIGAND,
                             LIGAND_SIZES * (nb // len(LIGAND_SIZES)), 0)
        with torch.no_grad():
            h, x, node_mask, mlig = model.net.embed(*batch)
        nbh = kknn.knn_graph_cuda(x, node_mask, K)
        rows = h.shape[0] * h.shape[1]
        calls = kcone.LAUNCHES
        got = [kcone.cone_cuda(nbh.idx, nbh.mask, MAX_LIGAND, L) for _ in range(2)]
        want = kcone.cone_plain(nbh.idx, nbh.mask, MAX_LIGAND, L)
        stamped = kcone.cone_phase_cycles(nbh.idx, nbh.mask, MAX_LIGAND, L)
        torch.cuda.synchronize()
        if kcone.LAUNCHES - calls != 2:
            raise AssertionError(f"cone B={nb}: {kcone.LAUNCHES - calls} counted calls, want 2")
        err = max(float((a.long() - w.long()).abs().max()) for a, w in zip(got[0], want))
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(*got)) or not all(
                torch.equal(a, b) for a, b in zip(stamped["cone"], got[0])):
            raise AssertionError(f"cone B={nb}: cone_kernel differs from its plain version "
                                 f"(max abs err {err}), between two calls or stamped")
        cone = got[0]
        counts = cone.counts.tolist()
        if counts[0] != nb * MAX_LIGAND:
            raise AssertionError(f"cone B={nb}: {counts[0]} rows of hop 0, want "
                                 f"{nb * MAX_LIGAND}")
        per_call = launches_per_call(torch, lambda: kcone.cone_cuda(nbh.idx, nbh.mask,
                                                                    MAX_LIGAND, L), "cone_kernel")
        if per_call != 1:
            raise AssertionError(f"cone B={nb}: {per_call} cone_kernel launches a call, want 1")
        K_ = nbh.idx.shape[-1]
        f = {"max_abs_err": err,
             "ms": cuda_ms(torch, lambda: kcone.cone_cuda(nbh.idx, nbh.mask, MAX_LIGAND, L)),
             "device_ms": device_ms(torch, lambda: kcone.cone_cuda(nbh.idx, nbh.mask,
                                                                   MAX_LIGAND, L)),
             "plain_ms": cuda_ms(torch, lambda: kcone.cone_plain(nbh.idx, nbh.mask, MAX_LIGAND,
                                                                 L)),
             "argsort_ms": cuda_ms(torch, lambda: torch.argsort(cone.hop.reshape(-1),
                                                                stable=True)),
             # one comparison a slot; the lists of the rows a sweep expands
             # (hop <= L: this run's data) read once, hop, order and counts
             # written once
             **bound(np.array([0, counts[L] * K_]),
                     counts[L] * K_ * (nbh.idx.element_size() + nbh.mask.element_size())
                     + nbytes(cone.hop, cone.order, cone.counts)),
             "launches_per_call": per_call,
             **kcone.cone_grid(*nbh.idx.shape[:2]),
             # each block's clock64 cycles by phase (stamped instantiation),
             # the largest over the grid, and as us at the card's top SM clock
             "phase_max_cycles": stamped["max_cycles"],
             "phase_mean_cycles": stamped["mean_cycles"],
             "sweeps_of_complex0": stamped["sweeps"],
             "phase_max_us_at_max_clock": {k: v / max_sm_clock_mhz()
                                           for k, v in stamped["max_cycles"].items()},
             "rows": rows,
             "live_x2h": [counts[L - l] / rows for l in range(L)],
             "live_node": [counts[L - l + 1] / rows for l in range(L)],
             "live_h2x_sources": counts[1] / rows}
        for dtype in (torch.float32, torch.bfloat16):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            packed = kblock.pack_block_params(rn, dtype)

            def block(c=None):
                return kblock.block_denoiser_cuda(rn, h, x, nbh, mlig, MAX_LIGAND, packed,
                                                  dtype=dtype, cone=c)

            with torch.no_grad():
                h_all, x_all = block()
                runs = [block(cone) for _ in range(2)]
                full = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, packed=packed,
                                        dtype=dtype)
                part = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, packed=packed,
                                        dtype=dtype, need_full_h=False)
            torch.cuda.synchronize()
            lig = slice(MAX_PROTEIN, None)
            if not (all(torch.equal(a, b) for a, b in zip(*runs))
                    and torch.equal(runs[0][1], x_all)
                    and torch.equal(runs[0][0][:, lig], h_all[:, lig])):
                raise AssertionError(f"cone B={nb} {tag}: the cone block's x or ligand h differ "
                                     "from the all-live block's, or two launches differ")
            keys = ("pred_ligand_pos", "pred_ligand_v", "final_ligand_h")
            if not all(torch.equal(part[k], full[k]) for k in keys):
                raise AssertionError(f"cone B={nb} {tag}: the forward's ligand outputs differ "
                                     "with need_full_h=False")
            with torch.no_grad():
                f[f"{tag}_block_ms"] = cuda_ms(torch, lambda: block(cone), reps=10)
                f[f"{tag}_block_all_live_ms"] = cuda_ms(torch, block, reps=10)
                f[f"{tag}_block_device_ms"] = device_ms(torch, lambda: block(cone), calls=5)
                f[f"{tag}_block_all_live_device_ms"] = device_ms(torch, block, calls=5)
                for label, fn in (("", lambda: block(cone)), ("_all_live", block)):
                    f[f"{tag}_x2h_edge_per_layer{label}"] = launch_device_ms(torch, fn,
                                                                             "x2h_edge")
                    node = launch_device_ms(torch, fn, "node_kernel") or [None, None]
                    f[f"{tag}_node_x2h_pass_per_layer{label}"] = node[0::2]
                    f[f"{tag}_node_h2x_pass_per_layer{label}"] = node[1::2]
            f[f"{tag}_ligand_digest"] = digest(torch, *(part[k] for k in keys))
        fields["b4" if nb == B else "b100"] = f
        phase(f"cone B={nb}", shape=f"B={nb},N={h.shape[1]},K={K},L={L}", bitwise=True,
              **{k: v for k, v in f.items()})
    # a sampling step (bf16, the default precision, and float32) with no host
    # synchronisation: one cone call, the passes and node launches unchanged
    batch = pocket_batch(torch, dev, pocket, feat_dim, MAX_LIGAND, LIGAND_SIZES, 3)
    gen = torch.Generator(device=dev).manual_seed(3)
    noise = torch.randn(batch.ligand_pos.shape, generator=gen, device=dev)
    uniform = torch.rand(batch.ligand_v.shape + (NUM_CLASSES,), generator=gen, device=dev)
    steps = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        packed = kblock.pack_block_params(rn, dtype)
        with torch.no_grad():
            model.sample_step(batch, batch.ligand_pos, batch.ligand_v, 500, noise, uniform,
                              packed=packed, dtype=dtype)  # warm: the kernels' library loaded
        torch.cuda.synchronize()
        passes = (("BF16_X2H_PASS_LAUNCHES", "BF16_H2X_PASS_LAUNCHES") if tag == "bf16"
                  else ("X2H_PASS_LAUNCHES", "H2X_PASS_LAUNCHES"))
        before = (kcone.LAUNCHES, *(getattr(kblock, a) for a in passes),
                  sum(kblock.node_launch_counts()))
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                pos, v = model.sample_step(batch, batch.ligand_pos, batch.ligand_v, 500, noise,
                                           uniform, packed=packed, dtype=dtype)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        after = (kcone.LAUNCHES, *(getattr(kblock, a) for a in passes),
                 sum(kblock.node_launch_counts()))
        counted = [b - a for a, b in zip(before, after)]
        if counted != [1, L, L, 2 * L] or not bool(pos.isfinite().all()):
            raise AssertionError(f"cone step {tag}: launches (cone, x2h, h2x, node) {counted}, "
                                 f"want [1, {L}, {L}, {2 * L}], or non-finite positions")
        steps[tag] = counted
    phase("cone step", sync_debug_mode="error", launches_cone_x2h_h2x_node=steps)
    return {**fields["b4"], **{f"b100_{k}": v for k, v in fields["b100"].items()}}


def bf16_kernel_entries(bf16: dict, dp: dict) -> list:
    """The kernels line's entries of the bf16 launches: launches from
    [bf16-sample] (block, edge weights, node: one a pass, x2h and h2x edge
    passes from its kNN run; the per-layer kernels from its hybrid run),
    errors, times and bounds (bf16 tensor-core rate) from [bf16-block] and
    [bf16-layers] (the x2h and h2x edge launches, `x2h_edge_mma_kernel` and
    `h2x_edge_mma_kernel`, also at kNN B=100 and alone at the hybrid K = 95);
    one PyTorch call computes only
    the node launch's projection (`torch.addmm` with bf16 operands)."""
    knn, hybrid = bf16["launches"]["knn"], bf16["launches"]["hybrid"]
    blk = "targetdiff_tpu_torch/csrc/block_denoiser.cu"
    rows = (
        ("block_denoiser_bf16", blk, "targetdiff_tpu/ops/pallas/block_denoiser.py:154",
         knn["block_bf16"], bf16["block"]["block"],
         {"launches_dp_sample_rank0": dp["block_bf16"]["sample"]}),
        ("block_denoiser.ew_bf16", blk, "targetdiff_tpu/ops/pallas/block_denoiser.py:319",
         knn["ew_bf16"], bf16["block"]["ew"], {}),
        ("block_denoiser.node_bf16", "targetdiff_tpu_torch/csrc/node_proj.cuh",
         "targetdiff_tpu/ops/pallas/block_denoiser.py:154", knn["node_bf16"],
         bf16["block"]["node"],
         {"kernel": "node_kernel<true>", "launches_hybrid": hybrid["node_bf16"],
          "chain_ms": bf16["block"]["node"]["chain_ms"],
          **{"h2x_pass_" + k: v for k, v in bf16["block"]["node_h2x"].items()},
          **{f"b100_{k}": v for k, v in bf16["block"]["node_b100"].items()}}),
        ("block_denoiser.x2h_edge_mma_bf16", "targetdiff_tpu_torch/csrc/x2h_edge_bf16.cuh",
         "targetdiff_tpu/ops/pallas/block_denoiser.py:154", knn["x2h_pass_bf16"],
         bf16["block"]["x2h_edge"],
         {"kernel": "x2h_edge_mma_kernel", "launches_hybrid_x2h_layer": hybrid["x2h_layer_bf16"],
          "also_replaces": "targetdiff_tpu/ops/pallas/edge_layer.py:189",
          **{f"b100_{k}": v for k, v in bf16["block"]["x2h_edge_b100"].items()},
          **{f"hybrid_{k}": v for k, v in bf16["layers"]["x2h_edge"].items()}}),
        ("block_denoiser.h2x_edge_bf16", "targetdiff_tpu_torch/csrc/h2x_edge_bf16.cuh",
         "targetdiff_tpu/ops/pallas/block_denoiser.py:154", knn["h2x_pass_bf16"],
         bf16["block"]["h2x_edge"],
         {"kernel": "h2x_edge_mma_kernel", "launches_hybrid_h2x_layer": hybrid["h2x_layer_bf16"],
          "also_replaces": "targetdiff_tpu/ops/pallas/edge_layer.py:235",
          **{f"b100_{k}": v for k, v in bf16["block"]["h2x_edge_b100"].items()},
          **{f"hybrid_{k}": v for k, v in bf16["layers"]["h2x_edge"].items()}}),
        ("x2h_layer_bf16", "targetdiff_tpu_torch/csrc/edge_layer.cu",
         "targetdiff_tpu/ops/pallas/edge_layer.py:189", hybrid["x2h_layer_bf16"],
         bf16["layers"]["x2h"], {}),
        ("h2x_layer_bf16", "targetdiff_tpu_torch/csrc/edge_layer.cu",
         "targetdiff_tpu/ops/pallas/edge_layer.py:235", hybrid["h2x_layer_bf16"],
         bf16["layers"]["h2x"], {}),
    )
    return [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, **{k: f[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                          "bound_ms", "bound_by", "device_ms")},
             "max_over_scale": f["margins"]["vs_bf16_plain"]["max"],
             "median_over_scale": f["margins"]["vs_bf16_plain"]["median"],
             "max_over_scale_vs_float64": f["margins"]["vs_float64"]["max"], **extra,
             "library_ms": f.get("library_ms")}
            for name, source, replaces, launches, f, extra in rows]


def eval_phase(res) -> None:
    """[eval]: [sample]'s molecules written to a result_0.pkl by the sampling
    CLI's writer and scored by the evaluation CLI's `evaluate_results` on
    the host (seeded random weights: the numbers say that the pipeline runs,
    not that the molecules are good)."""
    from targetdiff_tpu_torch.cli.evaluate_diffusion import evaluate_results
    from targetdiff_tpu_torch.cli.sample_diffusion import write_result

    out = REPO / "outputs" / "chip_smoke_eval"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "result_0.pkl"
    write_result(path, res["pos"], res["v"], "add_aromatic", res["time"])
    t0 = time.perf_counter()
    summary, results = evaluate_results([path], "add_aromatic")
    seconds = time.perf_counter() - t0
    validity = summary["validity"]
    n = len(res["pos"])
    if not (all(0.0 <= x <= 1.0 for x in validity.values())
            and np.isfinite(summary["atom_type_jsd"]) and len(results) <= n
            and sum(summary["atom_type_counts"].values()) == sum(len(v) for v in res["v"])):
        raise AssertionError(f"eval: inconsistent summary {validity}, {len(results)} results")
    phase("eval", molecules=n, **validity, atom_type_jsd=summary["atom_type_jsd"],
          pair_length_jsd=summary["pair_length_jsd"],
          bond_length_jsd={k: v for k, v in summary["bond_length_jsd"].items() if v is not None},
          num_results=summary["num_results"], host_seconds=seconds)


def ddim_jump_fields(torch, model, cbatch, pos, v, packed, sampler, t, s, eta, seed) -> dict:
    """One jump t -> s of `sample_step` on the kernels against impl='eager'
    with the same noise and uniforms: positions at POS_TOL, types equal at
    every slot where the sampled class leads the next by more than
    GUMBEL_MARGIN (counted, and no slot under it may differ from eager but
    for those)."""
    from targetdiff_tpu_torch.ops import diffusion as D

    gen = torch.Generator(device=pos.device).manual_seed(seed)
    noise = torch.randn(pos.shape, generator=gen, device=pos.device)
    uniform = torch.rand(v.shape + (NUM_CLASSES,), generator=gen, device=pos.device)
    coefs = D.ddim_pos_coefficients(model.pos_sched.betas.cpu().numpy(), [t], [s], eta)
    outs = {impl: model.sample_step(cbatch, pos, v, t, noise, uniform, packed=packed, s=s,
                                    sampler=sampler, coefs=[float(c[0]) for c in coefs],
                                    return_v_probs=True, impl=impl, dtype=torch.float32)
            for impl in ("fast", "eager")}
    torch.cuda.synchronize()
    lm = cbatch.ligand_mask
    err = check_close(f"ddim-sample {sampler} {t}->{s} positions", outs["fast"][0][lm],
                      outs["eager"][0][lm], **POS_TOL)
    gumbel = -torch.log(-torch.log(uniform + 1e-30) + 1e-30) + outs["eager"][3]
    top2 = gumbel.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = outs["fast"][1] != outs["eager"][1]
    if bool((differ & (margin > GUMBEL_MARGIN)).any()):
        raise AssertionError(f"ddim-sample {sampler} {t}->{s}: types differ from eager where "
                             f"the Gumbel margin exceeds {GUMBEL_MARGIN}")
    return {"max_abs_err_pos": err, "min_gumbel_margin": float(margin.min()),
            "slots_under_margin": int((margin <= GUMBEL_MARGIN).sum()),
            "types_differing": int(differ.sum()),
            "logits_max_abs_err": float((outs["fast"][2] - outs["eager"][2]).abs().max())}


def ddim_sample_phase(torch, dev, model, pocket, batch, ddpm_ms_per_step) -> dict:
    """[ddim-sample]: the strided samplers at [sample]'s shape (the example
    pocket, B = 4, kNN, the seeded flagship). Single jumps of `sample_step`
    on the kernels against eager (DDIM_JUMPS: ddim at eta 0 and 1, dpm2,
    the final s = -1 jump); the DDIM_RUNS through `sample_diffusion_ligand`,
    each with its launches counted exactly (one kNN-graph forward a jump,
    two a dpm2 jump but the final one), its molecules finite, in the
    vocabulary and near the pocket, the pos_only run's types the pocket
    ligand's in every frame of its trajectory; two ddim eta-0 pos_only runs
    from one initial state with different generators give the same
    positions. Times: seconds and ms per network evaluation (NFE) of each
    run, beside [sample]'s ddpm ms per step. Returns the runs' launches,
    summed."""
    from targetdiff_tpu_torch.chem.sdf import parse_sdf_file
    from targetdiff_tpu_torch.data.transforms import FeaturizeLigandAtom
    from targetdiff_tpu_torch.models.score_model import sampling_schedule
    from targetdiff_tpu_torch.ops import diffusion as D
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand
    from targetdiff_tpu_torch.tools.ddim_eval import nfe

    T = model.num_timesteps
    protein_pos, pos, _ = D.center_pos_protein(batch.protein_pos, batch.ligand_pos,
                                               batch.protein_mask)
    cbatch = batch._replace(protein_pos=protein_pos)
    pos = pos * batch.ligand_mask[..., None]
    packed = kblock.pack_block_params(model.net.refine_net)
    jumps = {f"{sampler}_{t}_{s}_eta{eta:g}": ddim_jump_fields(
        torch, model, cbatch, pos, batch.ligand_v, packed, sampler, t, s, eta, seed)
        for seed, (sampler, t, s, eta) in enumerate(DDIM_JUMPS)}

    lig = parse_sdf_file(str(POCKET_LIGAND_SDF))
    ref_v = FeaturizeLigandAtom("add_aromatic")({
        "ligand_element": lig["element"], "ligand_atom_feature": lig["atom_feature"],
        "ligand_hybridization": lig["hybridization"]})["ligand_atom_feature_full"]
    ref_ligand = {"ligand_pos": lig["pos"], "ligand_v": ref_v}
    centre = pocket["protein_pos"].mean(0)
    radius = float(np.linalg.norm(pocket["protein_pos"] - centre, axis=1).max())
    total = dict.fromkeys(path_want(0, 0), 0)
    runs = {}
    for i, (name, kw) in enumerate(DDIM_RUNS):
        n_eval = nfe(T, **{k: kw[k] for k in ("num_steps", "sampler", "ddim_spacing") if k in kw})
        reset_path_launches()
        t0 = time.perf_counter()
        res = sample_diffusion_ligand(
            model, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(20 + i),
            batch_size=B, max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND,
            rng=np.random.default_rng(20 + i), ref_ligand=ref_ligand,
            sample_num_atoms="ref" if kw.get("pos_only") else "prior", dtype=torch.float32,
            **kw)
        wall = time.perf_counter() - t0
        launches = path_launches()
        if launches != path_want(n_eval, n_eval):
            raise AssertionError(f"ddim-sample {name}: launches {launches}, expected "
                                 f"{path_want(n_eval, n_eval)}")
        total = {k: total[k] + launches[k] for k in total}
        for pos_i, v_i in zip(res["pos"], res["v"]):
            if pos_i.shape != (len(v_i), 3) or not np.isfinite(pos_i).all():
                raise AssertionError(f"ddim-sample {name}: a non-finite or misshaped molecule")
            if not ((v_i >= 0) & (v_i < NUM_CLASSES)).all():
                raise AssertionError(f"ddim-sample {name}: an atom type outside the vocabulary")
        dist = float(max(np.linalg.norm(p.mean(0) - centre) for p in res["pos"]))
        if dist >= radius:
            raise AssertionError(f"ddim-sample {name}: a molecule's centroid lies {dist} A from "
                                 f"the pocket's centre, outside its {radius} A radius")
        if kw.get("return_traj"):
            frames = len(sampling_schedule(T, kw["num_steps"], kw["sampler"])[0])
            for p_i, v_i, pt, vt in zip(res["pos"], res["v"], res["pos_traj"], res["v_traj"]):
                if (pt.shape != (frames, len(v_i), 3) or vt.shape != (frames, len(v_i))
                        or not np.array_equal(pt[-1], p_i) or not np.isfinite(pt).all()):
                    raise AssertionError(f"ddim-sample {name}: a misshaped trajectory")
        if kw.get("pos_only") and not all((np.asarray(v_i) == ref_v).all()
                                          for v_i in res["v"] + res["v_traj"]):
            raise AssertionError(f"ddim-sample {name}: pos_only changed the ligand's types")
        sample_s = res["time"][0]
        runs[name] = {"nfe": n_eval, "seconds": sample_s, "wall_seconds": wall,
                      "ms_per_nfe": 1e3 * sample_s / n_eval, "mol_per_s": B / sample_s,
                      "max_centroid_offset_A": dist, "launches": launches}

    # eta 0 with the types held: the noise does not reach the positions
    init = pos + torch.randn(pos.shape, generator=torch.Generator(device=dev).manual_seed(5),
                             device=dev)
    same = [model.sample_diffusion(batch, init, batch.ligand_v,
                                   torch.Generator(device=dev).manual_seed(seed), num_steps=20,
                                   sampler="ddim", eta=0.0, pos_only=True,
                                   dtype=torch.float32).pos
            for seed in (1, 2)]
    if not torch.equal(*same):
        raise AssertionError("ddim-sample: eta-0 positions depend on the generator")
    phase("ddim-sample", samples=B, jumps=jumps, runs=runs, ddpm_ms_per_step=ddpm_ms_per_step,
          pocket_radius_A=radius, eta0_positions_bitwise_equal=True)
    return total


def gate_short_phase(torch, dev) -> None:
    """[gate-short]: the port's quality gate at GATE_SHORT's size (1000 DDPM
    steps per model, one sampling chunk) on the kernel path, held by the
    launch counts of its training (float32) and sampling (bf16, the gate's
    default, as the JAX gate's); its report must be complete and finite,
    its checks need not pass."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.kernels import cone as kcone
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg
    from targetdiff_tpu_torch.tools import quality_gate as qg

    kknn.LAUNCHES = kblock.LAUNCHES = kblock.EW_LAUNCHES = kblock.TRAIN_LAUNCHES = 0
    kblock.BF16_LAUNCHES = kblock.BF16_EW_LAUNCHES = kcone.LAUNCHES = 0
    kvjp.LAUNCHES = kvjp.NODE_BWD_LAUNCHES = kvjp.ADJ_LAUNCHES = kvjp.STAGE_W2_LAUNCHES = 0
    kwg.LAUNCHES.update(dict.fromkeys(kwg.LAUNCHES, 0))
    node_since = kblock.node_launch_counts()
    t0 = time.perf_counter()
    report = qg.run_gate(GATE_SHORT["steps"], GATE_SHORT["n_mols"], dev,
                         n_pockets=GATE_SHORT["n_pockets"], log=lambda _: None)
    wall = time.perf_counter() - t0
    launches = {"knn": kknn.LAUNCHES, "block": kblock.LAUNCHES, "ew": kblock.EW_LAUNCHES,
                "block_bf16": kblock.BF16_LAUNCHES, "ew_bf16": kblock.BF16_EW_LAUNCHES,
                "cone": kcone.LAUNCHES, "train_fwd": kblock.TRAIN_LAUNCHES, "vjp": kvjp.LAUNCHES,
                "node_bwd": kvjp.NODE_BWD_LAUNCHES, "adj": kvjp.ADJ_LAUNCHES,
                "stage_w2": kvjp.STAGE_W2_LAUNCHES, "weight_grad": dict(kwg.LAUNCHES),
                **dict(zip(("node", "node_bf16"),
                           np.subtract(kblock.node_launch_counts(), node_since).tolist()))}
    steps, L = GATE_SHORT["steps"], FLAGSHIP["num_layers"]
    sampling = 2 * report["chunks"] * report["num_steps"]  # two models
    # node launches: training's forward and recompute, both passes (float32);
    # sampling's two passes a layer (bf16)
    want = {"knn": steps + sampling, "block": 0, "ew": 0, "block_bf16": sampling,
            "ew_bf16": sampling, "cone": sampling, "train_fwd": steps, "node": 4 * L * steps,
            "node_bf16": 2 * L * sampling,
            "vjp": steps, "node_bwd": 2 * L * steps, "adj": 2 * steps, "stage_w2": steps,
            "weight_grad": {"x2h_edge": 3 * L * steps, "h2x_edge": 3 * L * steps,
                            "node": 4 * L * steps, "alone": 0}}
    if launches != want:
        raise AssertionError(f"gate-short: launches {launches}, expected {want}")
    evs = {k: report[k] for k in ("corpus", "untrained", "trained")}
    keys = set(evs["corpus"])
    numbers = [x for ev in evs.values() for x in ev.values() if isinstance(x, (int, float))]
    numbers += report["loss_hist"] + list(report["timing"].values())
    if (any(set(ev) != keys for ev in evs.values()) or len(report["checks"]) != 12
            or not all(isinstance(ok, bool) for ok in report["checks"].values())
            or len(report["loss_hist"]) != 2 or not np.isfinite(numbers).all()
            or evs["trained"]["n"] != GATE_SHORT["n_mols"]):
        raise AssertionError(f"gate-short: incomplete or non-finite report {report}")
    t = report["timing"]
    phase("gate-short", train_steps=steps, molecules=GATE_SHORT["n_mols"],
          pockets=GATE_SHORT["n_pockets"], num_steps=report["num_steps"],
          loss=report["loss_hist"], checks_passed=sum(report["checks"].values()),
          trained={k: evs["trained"][k] for k in ("mol_stable", "atom_stable", "recon_success",
                                                   "atom_type_jsd_vs_train")},
          train_ms_per_step=t["train_ms_per_step"],
          sample_ms_per_step=[t["untrained_sample_ms_per_step"], t["trained_sample_ms_per_step"]],
          eval_seconds=[t["corpus_eval_seconds"], t["untrained_eval_seconds"],
                        t["trained_eval_seconds"]],
          wall_seconds=wall, launches=launches)


def path_launches() -> dict:
    """The counts of the kernels of the likelihood and embedding paths."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import cone as kcone
    from targetdiff_tpu_torch.ops.kernels import knn as kknn

    return {"knn": kknn.LAUNCHES, "block": kblock.LAUNCHES, "ew": kblock.EW_LAUNCHES,
            "x2h_pass": kblock.X2H_PASS_LAUNCHES, "h2x_pass": kblock.H2X_PASS_LAUNCHES,
            "cone": kcone.LAUNCHES}


def reset_path_launches() -> None:
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import cone as kcone
    from targetdiff_tpu_torch.ops.kernels import knn as kknn

    kknn.LAUNCHES = kblock.LAUNCHES = kblock.EW_LAUNCHES = kcone.LAUNCHES = 0
    kblock.X2H_PASS_LAUNCHES = kblock.H2X_PASS_LAUNCHES = 0


def path_want(calls: int, h2x_calls: int) -> dict:
    """The launches of `calls` kNN-graph forwards on the whole-block kernels
    (one block of L layers), `h2x_calls` of them with positions updated:
    those (sampling, likelihood: need_full_h=False) each run one cone."""
    L = FLAGSHIP["num_layers"]
    return {"knn": calls, "block": calls, "ew": calls, "x2h_pass": L * calls,
            "h2x_pass": L * h2x_calls, "cone": h2x_calls}


def likelihood_phase(torch, dev, model) -> dict:
    """[likelihood]: `batch_likelihood_estimation` at tools/likebench.py's
    shape (the flagship, LIKE_C synthetic complexes of 330 atoms in 384
    protein slots and 18-32 ligand atoms in 32 slots, T / LIKE_STRIDE
    timesteps), on the kernels against the eager path with the same draws
    at ELBO_TOL; the prior terms bitwise equal. One kNN and one block launch
    a call (the step terms' [C * n_t]-row forward), none for the prior.
    Timed by CUDA events (the kernels, eager) and torch.profiler (device)."""
    from targetdiff_tpu_torch.cli.likelihood_est_diffusion import batch_likelihood_estimation
    from targetdiff_tpu_torch.data.synth import synth_batch

    b = synth_batch(np.random.default_rng(0), LIKE_C, max_protein=LIKE_PROTEIN,
                    max_ligand=MAX_LIGAND, n_protein_range=(LIKE_VALID, LIKE_VALID + 1),
                    n_ligand_range=(18, MAX_LIGAND + 1), device=dev)
    T = model.num_timesteps
    ts = list(range(0, T, LIKE_STRIDE))
    gen = torch.Generator(device=dev).manual_seed(7)
    noise = torch.randn((LIKE_C * len(ts), MAX_LIGAND, 3), generator=gen, device=dev)
    uniform = torch.rand((LIKE_C * len(ts), MAX_LIGAND, NUM_CLASSES), generator=gen, device=dev)

    def run(impl):
        return batch_likelihood_estimation(model, b, ts, None, impl=impl, pos_noise=noise,
                                           v_uniform=uniform)

    reset_path_launches()
    fast = run("fast")
    launches = path_launches()
    if launches != path_want(1, 1):
        raise AssertionError(f"likelihood: launches {launches}, expected {path_want(1, 1)}")
    eager = run("eager")
    errs = {name: check_close(f"likelihood {name}", torch.from_numpy(f), torch.from_numpy(e),
                              **ELBO_TOL)
            for name, f, e in zip(("nll", "kl_pos", "kl_v"), fast, eager)}
    reset_path_launches()
    t_prior = torch.full((LIKE_C,), T, device=dev)
    prior = [model.likelihood_estimation(b, t_prior, impl=impl) for impl in ("fast", "eager")]
    if any(path_launches().values()) or not all(torch.equal(a, c) for a, c in zip(*prior)):
        raise AssertionError(f"likelihood: the prior terms launched {path_launches()} or "
                             "differ between the kernels and eager")
    ms = cuda_ms(torch, lambda: run("fast"), reps=5, warmup=1)
    plain_ms = cuda_ms(torch, lambda: run("eager"), reps=3, warmup=1)
    dev_ms = device_ms(torch, lambda: run("fast"), calls=3)
    phase("likelihood", shape=f"C={LIKE_C},t={len(ts)},NP={LIKE_PROTEIN},NL={MAX_LIGAND},K={K}",
          rows=LIKE_C * len(ts), max_abs_err=errs,
          max_rel_err_nll=float(np.abs(fast[0] - eager[0]).max() / np.abs(eager[0]).min()),
          nll=[float(v) for v in fast[0]], prior_bitwise_equal=True, launches=launches,
          ms=ms, device_ms=dev_ms, idle_share=1 - dev_ms / ms, plain_ms=plain_ms,
          complexes_per_s=LIKE_C * 1e3 / ms)
    return launches


def embedding_phase(torch, dev, model, pocket, feat_dim) -> dict:
    """[embedding]: `fetch_embedding` at the likelihood CLI's padding (the
    example pocket in 640 protein slots, EMBED_SIZES ligand atoms in 64
    slots) on the kernels against the eager path: positions bitwise the
    input, final_h (valid rows), final_ligand_h and the logits at H_TOL, L
    x2h and no h2x pass launched. Timed beside the same forward with the
    positions updated (fast_apply), the eager export and the weight packing
    (`pack_block_params`) that each call does first."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock

    batch = pocket_batch(torch, dev, pocket, feat_dim, CLI_LIGAND, EMBED_SIZES, 5,
                         max_protein=CLI_PROTEIN)
    reset_path_launches()
    fast = model.fetch_embedding(batch, impl="fast")
    torch.cuda.synchronize()
    launches = path_launches()
    if launches != path_want(1, 0):
        raise AssertionError(f"embedding: launches {launches}, expected {path_want(1, 0)}")
    eager = model.fetch_embedding(batch, impl="eager")
    if not (torch.equal(fast["pred_ligand_pos"], batch.ligand_pos)
            and torch.equal(eager["pred_ligand_pos"], batch.ligand_pos)):
        raise AssertionError("embedding: ligand positions moved under fix_x")
    rows = torch.cat([batch.protein_mask, batch.ligand_mask], 1)
    lm = batch.ligand_mask
    errs = {"final_h": check_close("embedding final_h", fast["final_h"][rows],
                                   eager["final_h"][rows], **H_TOL),
            "final_ligand_h": check_close("embedding final_ligand_h", fast["final_ligand_h"][lm],
                                          eager["final_ligand_h"][lm], **H_TOL),
            "logits": check_close("embedding logits", fast["pred_ligand_v"][lm],
                                  eager["pred_ligand_v"][lm], **H_TOL)}

    def moving():
        with torch.no_grad():
            return model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, dtype=torch.float32)

    def frozen():
        return model.fetch_embedding(batch, impl="fast")

    def pack():
        with torch.no_grad():
            return kblock.pack_block_params(model.net.refine_net)

    phase("embedding", shape=f"B={len(EMBED_SIZES)},N={CLI_PROTEIN + CLI_LIGAND},K={K}",
          max_abs_err=errs, positions_bitwise_input=True, launches=launches,
          ms=cuda_ms(torch, frozen, reps=10), device_ms=device_ms(torch, frozen, calls=5),
          unfrozen_ms=cuda_ms(torch, moving, reps=10),
          unfrozen_device_ms=device_ms(torch, moving, calls=5),
          plain_ms=cuda_ms(torch, lambda: model.fetch_embedding(batch, impl="eager"), reps=3,
                           warmup=1),
          pack_ms=cuda_ms(torch, pack, reps=10), pack_device_ms=device_ms(torch, pack, calls=5))
    return launches


def likelihood_cli_phase(torch, ckpt) -> dict:
    """[likelihood-cli]: the likelihood CLI's `run` on the card from
    [train-cli]'s checkpoint over its dataset's train split (four complexes,
    one padded batch of 8), then `analyze_affinity` on the pickle it wrote
    with a pK map made from a seed. Two kNN-graph forwards (the step terms,
    the embedding export) and one h2x pass a layer (the step terms only)."""
    import contextlib
    import io

    from targetdiff_tpu_torch.cli import analyze_affinity
    from targetdiff_tpu_torch.cli import likelihood_est_diffusion as like_cli
    from targetdiff_tpu_torch.config import Config

    out = REPO / "outputs" / "chip_smoke_likelihood"
    shutil.rmtree(out, ignore_errors=True)
    config = Config(model=dict(checkpoint=str(ckpt)), sample=dict(seed=0))
    args = like_cli.parser().parse_args(["in-code", "--split", "train", "--result_path",
                                         str(out), "--device", "cuda"])
    reset_path_launches()
    t0 = time.perf_counter()
    path = like_cli.run(config, args)
    wall = time.perf_counter() - t0
    launches = path_launches()
    if launches != path_want(2, 1):
        raise AssertionError(f"likelihood-cli: launches {launches}, expected {path_want(2, 1)}")
    with open(path, "rb") as f:
        entries = pickle.load(f)
    fields = {"ligand_filename", "protein_filename", "nll", "kl_pos", "kl_v", "final_h",
              "final_ligand_h", "pred_ligand_v"}
    n_t = -(-FLAGSHIP["num_diffusion_timesteps"] // args.t_stride)
    for e in entries:
        nl = len(e["final_ligand_h"])
        if (set(e) != fields or not np.isfinite([e["nll"], *e["kl_pos"], *e["kl_v"]]).all()
                or e["kl_pos"].shape != (n_t,) or e["final_h"].shape != (572 + nl, 128)
                or not np.isfinite(e["final_h"]).all()
                or not np.allclose(e["pred_ligand_v"].sum(-1), 1.0, atol=1e-5)):
            raise AssertionError(f"likelihood-cli: a malformed record {sorted(e)}")
    if len(entries) != 4 or len({e["ligand_filename"] for e in entries}) != 4:
        raise AssertionError(f"likelihood-cli: {len(entries)} records, expected 4 ligands")
    rng = np.random.default_rng(0)
    pk = {e["ligand_filename"]: float(rng.uniform(2, 11)) for e in entries}
    pk_path = out / "affinity_info.pkl"
    pk_path.write_bytes(pickle.dumps(pk))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        analyze_affinity.main([path, "--affinity_pkl", str(pk_path)])
    lines = buf.getvalue().splitlines()
    if (len(lines) != 4 or lines[0] != "4 complexes"
            or not np.isfinite([float(w) for w in lines[1].split()[2::2]]).all()):
        raise AssertionError(f"likelihood-cli: analyze_affinity printed {lines}")
    phase("likelihood-cli", records=len(entries), nll=[e["nll"] for e in entries],
          wall_seconds=wall, launches=launches, analyze_affinity=lines)
    return launches


def gate(torch, argv) -> int:
    """The `gate [STEPS] [N_MOLS]` mode (module docstring)."""
    if len(argv) > 2 or not all(a.isdigit() for a in argv):
        raise SystemExit("usage: chip_smoke.py gate [STEPS] [N_MOLS]")
    steps = int(argv[0]) if argv else 12000
    n_mols = int(argv[1]) if len(argv) > 1 else 256
    sys.path.insert(0, str(REPO))
    from targetdiff_tpu_torch.ops.kernels import build
    from targetdiff_tpu_torch.tools import quality_gate as qg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    report = qg.run_gate(steps, n_mols, torch.device("cuda:0"),
                         log=lambda line: print(line, flush=True))
    report["card"] = card
    report["device"] = {"kind": torch.cuda.get_device_name(0),
                        "count": torch.cuda.device_count()}
    report["timing"].update(build_seconds=build_s, card=card)  # the card beside its times
    (REPO / "quality_gate_torch.json").write_text(json.dumps(report, indent=1) + "\n")
    failed = [k for k, ok in report["checks"].items() if not ok]
    print(json.dumps({"card": card, "gate": {
        "checks": report["checks"], "timing": report["timing"],
        **{k: {m: report[k][m] for m in ("mol_stable", "atom_stable", "recon_success",
                                         "ring_recovery", "pair_jsd_vs_train",
                                         "atom_type_jsd_vs_train", "bond_jsd_vs_train",
                                         "n_classes")}
           for k in ("corpus", "untrained", "trained")}}}), flush=True)
    print("GATE", "FAIL: " + ", ".join(failed) if failed else "ok", flush=True)
    return 1 if failed else 0


def ddim(torch, argv) -> int:
    """The `ddim [STEPS] [N_MOLS]` mode (module docstring)."""
    if len(argv) > 2 or not all(a.isdigit() for a in argv):
        raise SystemExit("usage: chip_smoke.py ddim [STEPS] [N_MOLS]")
    steps = int(argv[0]) if argv else 4000
    n_mols = int(argv[1]) if len(argv) > 1 else 128
    sys.path.insert(0, str(REPO))
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import build
    from targetdiff_tpu_torch.tools import ddim_eval

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    kblock.LAUNCHES = kblock.BF16_LAUNCHES = kblock.TRAIN_LAUNCHES = 0
    report = ddim_eval.run(steps, n_mols, torch.device("cuda:0"),
                           log=lambda line: print(line, flush=True))
    rows = [name for name, _ in ddim_eval.ROWS]
    chunks = report[rows[0]]["chunks"]
    # its rows sample at the default precision, bf16, as the JAX script's
    launches = {"block": kblock.BF16_LAUNCHES, "train_fwd": kblock.TRAIN_LAUNCHES}
    if kblock.LAUNCHES:
        raise AssertionError(f"ddim: {kblock.LAUNCHES} float32 block launches in bf16 rows")
    want = {"block": chunks * sum(report[name]["nfe"] for name in rows), "train_fwd": steps}
    report["checks"] = ddim_eval.checks(report)
    report["checks"]["launches"] = launches == want
    report.update(card=card, build_seconds=build_s, launches=launches,
                  device={"kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    (REPO / "ddim_eval_torch.json").write_text(json.dumps(report, indent=1) + "\n")
    failed = [k for k, ok in report["checks"].items() if not ok]
    print(json.dumps({"card": card, "train_seconds": report["train"]["seconds"],
                      "launches": launches, "expected_launches": want,
                      "rows": {name: {k: report[name][k] for k in (
                          "mol_stable", "atom_stable", "recon_success", "pair_jsd_vs_train",
                          "sample_seconds", "mols_per_sec", "nfe", "ms_per_nfe")}
                          for name in rows},
                      "checks": report["checks"]}), flush=True)
    print("DDIM", "FAIL: " + ", ".join(failed) if failed else "ok", flush=True)
    return 1 if failed else 0


def knn_setup(torch, dev, pocket, feat_dim):
    """The kNN phases' inputs: a flagship model of seeded random weights, the
    example pocket with ligands of LIGAND_SIZES atoms, its embedding and its
    plain kNN graph: (model, batch, h, x, node_mask, mask_ligand, nbh)."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.ops import graph as G

    batch = pocket_batch(torch, dev, pocket, feat_dim, MAX_LIGAND, LIGAND_SIZES, 0)
    torch.manual_seed(0)
    model = DiffusionModel(Config(FLAGSHIP), feat_dim, NUM_CLASSES, device=dev,
                           max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND)
    with torch.no_grad():
        h, x, node_mask, mask_ligand = model.net.embed(*batch)
    return model, batch, h, x, node_mask, mask_ligand, G.knn_graph(x, node_mask, K)


def knn_bound(x, mask, nbh, k=K) -> dict:
    """The kNN kernel's bound: every pair's distance (8 FLOP) and a log2
    k-deep selection per candidate at the float32 rate; positions and mask
    read, idx and mask written."""
    nb, n = mask.shape
    return bound((0, nb * n * n * (8 + np.log2(k))), nbytes(x, mask, nbh.idx, nbh.mask))


def train_batch(dev):
    """[train]'s batch: B=32 synthetic complexes (data/synth.py, seed 3)."""
    from targetdiff_tpu_torch.data.synth import synth_batch

    return synth_batch(np.random.default_rng(3), TRAIN_B, max_protein=TRAIN_PROTEIN,
                       max_ligand=MAX_LIGAND, n_protein_range=(TRAIN_VALID, TRAIN_VALID + 1),
                       n_ligand_range=(18, 28), device=dev)


def train_positions(torch, dev):
    """Positions [32, 416, 3] and node mask of [train]'s batch, protein
    slots then ligand slots."""
    tb = train_batch(dev)
    return (torch.cat([tb.protein_pos, tb.ligand_pos], 1).float(),
            torch.cat([tb.protein_mask, tb.ligand_mask], 1))


def knn_fields(torch, x, mask, k=K) -> dict:
    """The kNN kernel at one shape: idx and mask bitwise equal to
    knn_graph_exact on every entry (raises otherwise); CUDA-event and device
    ms per launch beside its bound (`knn_bound`) and the plain version's
    (`ops.graph.knn_graph`) ms; and topk_ms, torch.topk of
    the k smallest over a precomputed masked d2 [B, N, N]: the library's
    selection alone, not the same function (it is handed the distances and
    promises no order on ties)."""
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import knn as kknn

    got = kknn.knn_graph_cuda(x, mask, k)
    want = G.knn_graph_exact(x, mask, k)
    torch.cuda.synchronize()
    differ = int((got.idx != want.idx).sum() + (got.mask != want.mask).sum())
    if differ:
        raise AssertionError(f"knn: {differ} entries differ from knn_graph_exact at "
                             f"{tuple(mask.shape)}")
    del want
    n = mask.shape[1]
    valid = mask[:, None, :] & mask[:, :, None] & ~torch.eye(n, dtype=torch.bool,
                                                             device=mask.device)
    d2 = torch.where(valid, G.pairwise_sq_dists(x), torch.full((), G.BIG, device=mask.device))
    return {"shape": f"B={mask.shape[0]},N={n},K={k}", "bitwise_equal": True,
            "ms": cuda_ms(torch, lambda: kknn.knn_graph_cuda(x, mask, k)),
            "device_ms": device_ms(torch, lambda: kknn.knn_graph_cuda(x, mask, k)),
            **knn_bound(x, mask, got, k), "plain_ms": cuda_ms(torch, lambda: G.knn_graph(
                x, mask, k), reps=5), "topk_ms": cuda_ms(torch, lambda: torch.topk(
                    d2, k, dim=-1, largest=False))}


def adjacency_phase(torch, dev) -> dict:
    """[train-block adj]: the backward's inverse adjacency (build_adjacency,
    three kernels) alone through adjacency_cuda on [train]'s kNN graph (B=32,
    N = 416, K = 32), for the x2h pass (row0 = 0) and the h2x pass (row0 =
    N - 32): off and every source's list bitwise equal to adjacency_plain,
    two builds equal (raises otherwise); CUDA-event and device ms per build
    beside its bound (bytes: idx and nmask of the pass's rows read once,
    off and the live edges' list entries written once), the plain version's
    ms, and sort_ms, the stable torch.sort by source that adjacency_plain
    runs, on its keys: the library's sort alone, not the same function."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.kernels import knn as kknn

    x, mask = train_positions(torch, dev)
    nbh = kknn.knn_graph_cuda(x, mask, K)
    nb, n = mask.shape
    out = {}
    for sub, row0 in (("x2h", 0), ("h2x", n - MAX_LIGAND)):
        got = [kvjp.adjacency_cuda(nbh.idx, nbh.mask, row0) for _ in range(2)]
        want_off, want_lst = kvjp.adjacency_plain(nbh.idx, nbh.mask, row0)
        torch.cuda.synchronize()
        live = torch.arange(want_lst.shape[1], device=dev)[None] < want_off[:, -1:]
        err = max(max(int((off - want_off).abs().max()),
                      int((lst[live] - want_lst[live]).abs().max())) for off, lst in got)
        if err:
            raise AssertionError(f"train-block adj: {sub} lists differ from adjacency_plain")
        edges, n_live = want_lst.numel(), int(want_off[:, -1].sum())
        key = torch.where(nbh.mask[:, row0:].reshape(nb, -1), nbh.idx[:, row0:].reshape(nb, -1),
                          n)

        def build():
            return kvjp.adjacency_cuda(nbh.idx, nbh.mask, row0)

        out[sub] = {"edges": edges, "live_edges": n_live, "max_abs_err": float(err),
                    "ms": cuda_ms(torch, build), "device_ms": device_ms(torch, build),
                    **bound((0, 0), edges * 9 + n_live * 4 + want_off.numel() * 4),
                    "plain_ms": cuda_ms(torch, lambda: kvjp.adjacency_plain(nbh.idx, nbh.mask,
                                                                            row0)),
                    "sort_ms": cuda_ms(torch, lambda: torch.sort(key, dim=-1, stable=True))}
    return out


def hybrid_setup(torch, dev, pocket, feat_dim):
    """[layers]' hybrid inputs: a hybrid flagship model of seeded random
    weights, the example pocket with 64 ligand slots (N = 640, K = 95), its
    embedding and hybrid graph: (model, batch, h, x, node_mask, mask_ligand,
    nbh)."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.models.score_model import DiffusionModel

    torch.manual_seed(6)
    model = DiffusionModel(Config(dict(FLAGSHIP, cutoff_mode="hybrid")), feat_dim, NUM_CLASSES,
                           device=dev, max_protein=MAX_PROTEIN, max_ligand=HYBRID_LIGAND)
    batch = pocket_batch(torch, dev, pocket, feat_dim, HYBRID_LIGAND, HYBRID_SIZES, 7)
    rn = model.net.refine_net
    with torch.no_grad():
        h, x, node_mask, mask_ligand = model.net.embed(*batch)
        nbh = rn.graph(x, node_mask, mask_ligand)
    return model, batch, h, x, node_mask, mask_ligand, nbh


def block_grads(torch, rn, h, x, nbh, mask_ligand, e_w, gh, gx, trainable, dtype=None):
    """Every parameter gradient of the block `rn` and dh0, dx0, de_w for the
    output cotangents (gh, gx): through the block-VJP kernel (`trainable`)
    or autograd of the plain block, in the dtype of rn and the inputs (a
    float64 copy gives the float64 reference); dtype=torch.bfloat16: the
    bf16 kernels or the bf16 plain block."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp

    kw = {} if dtype is None else {"dtype": dtype}
    leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
    rn.zero_grad(set_to_none=True)
    if trainable:
        ho, xo = kvjp.block_layers_trainable(rn, leaves[0], leaves[1], nbh, mask_ligand,
                                             leaves[2], MAX_LIGAND, **kw)
    else:
        ho, xo = rn.block_forward(leaves[0], leaves[1], nbh, mask_ligand, e_w=leaves[2], **kw)
    ((ho * gh).sum() + (xo * gx).sum()).backward()
    grads = {n: p.grad for n, p in rn.named_parameters() if p.grad is not None}
    grads.update(dh0=leaves[0].grad, dx0=leaves[1].grad, de_w=leaves[2].grad)
    return grads


def train_block_cotangents(torch, dev, rn, x, nbh, h):
    """[train-block]'s edge weights and output cotangents (seed 5)."""
    with torch.no_grad():
        e_w = rn.edge_weights(x, nbh)[..., 0]
    gen = torch.Generator(device=dev).manual_seed(5)
    return (e_w, gen, torch.randn(h.shape, generator=gen, device=dev),
            torch.randn(x.shape, generator=gen, device=dev))


def layer_grads(torch, net, sub, trainable, h, x, nbh, mask_ligand, e_w, cot, n_ligand,
                dtype=None):
    """Every parameter gradient of layer 0 of `net` and dh, dx, de_w for the
    cotangent `cot` of one sub-layer (`sub`: x2h or h2x): through its
    backward kernel (`trainable`) or autograd of the plain layer, in the
    dtype of net and the inputs; dtype=torch.bfloat16: the bf16 kernels or
    the bf16 plain layer."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kelv

    kw = {} if dtype is None else {"dtype": dtype}
    layer = net.base_block[0]
    leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
    net.zero_grad(set_to_none=True)
    if sub == "x2h":
        fn = kelv.x2h_layer_trainable if trainable else kel.x2h_layer_plain
        o = fn(layer, leaves[0], leaves[1], nbh, mask_ligand, leaves[2], **kw)
    elif trainable:
        o = kelv.h2x_layer_trainable(layer, leaves[0], leaves[1], nbh, mask_ligand, leaves[2],
                                     n_ligand, **kw)
    else:
        o = kel.h2x_layer_plain(layer, leaves[0], leaves[1], nbh, mask_ligand, leaves[2], **kw)
    (o * cot).sum().backward()
    r = {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}
    r.update(dh=leaves[0].grad, dx=leaves[1].grad, de_w=leaves[2].grad)
    return r


def tensor_errs(got: dict, want: dict) -> dict:
    """Per tensor |got - want| max over max|want|, the k biases (zero in
    exact arithmetic) left out."""
    return {n: float((got[n].double() - w.double()).abs().max())
            / max(float(w.abs().max()), 1e-30)
            for n, w in want.items() if not n.endswith("k_func.net.3.bias")}


def bwd64_fields(label, got, want32, plain32, want64, per_tensor=True, check=True,
                 floor=False) -> dict:
    """A backward's margins: against the plain float32 version `want32` (the
    bar of 5e-3 of scale) and against float64 `want64`, each with its worst
    tensor, and the median against float64; `plain32` is the float64
    reference's function in float32, whose own error is reported beside and,
    with `floor`, floors each tensor's bar (BWD64_F32 times it). Raises
    (with `check`) if the median misses BWD64_MEDIAN or, with `per_tensor`,
    a tensor misses its bar (BWD64_BAR)."""
    vs32, vs64, p64 = (tensor_errs(got, want32), tensor_errs(got, want64),
                       tensor_errs(plain32, want64))
    bar = {n: max(BWD64_BAR, BWD64_F32 * p64[n]) if floor else BWD64_BAR for n in vs64}
    w32, w64, wp = (max(e, key=e.get) for e in (vs32, vs64, p64))
    tight = max(vs64, key=lambda n: vs64[n] / bar[n])
    median = float(np.median(list(vs64.values())))
    if check and not median < BWD64_MEDIAN:
        raise AssertionError(f"{label}: the median tensor is {median} of its scale from float64 "
                             f"(bar {BWD64_MEDIAN})")
    if check and per_tensor and not vs64[tight] < bar[tight]:
        raise AssertionError(f"{label}: {tight} is {vs64[tight]} of its scale from float64 "
                             f"(bar {bar[tight]}; plain float32 {p64[tight]})")
    return {"over_scale": vs32[w32], "worst_tensor": w32,
            "f64_over_scale": vs64[w64], "f64_worst_tensor": w64,
            "f64_median": median,
            "f64_over_bar": vs64[tight] / bar[tight], "f64_tightest_tensor": tight,
            "plain_f64_over_scale": p64[wp], "plain_f64_worst_tensor": wp,
            "plain_f64_median": float(np.median(list(p64.values()))),
            "f64_floored_tensors": sum(b > BWD64_BAR for b in bar.values())}


def block_vjp_chain(torch, rn, hck, xck, nbh, mask_ligand, e_w, gh, gx):
    """The block's VJP as the block-VJP kernel composes it, by autograd of
    the plain sub-layers of `rn` at the checkpoints hck [L+1,B,N,H] and
    xck [L+1,B,N,3] (layer l: h_{l+1} = x2h(hck[l], xck[l]), x_{l+1} =
    h2x(hck[l+1], xck[l])), layers L-1 .. 0, in the dtype of rn and the
    inputs: every parameter gradient and dh0, dx0, de_w."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    rn.zero_grad(set_to_none=True)
    ew = e_w.clone().requires_grad_()
    dh, dx = gh, gx
    for l in reversed(range(len(rn.base_block))):
        layer = rn.base_block[l]
        h1, x0 = (t.clone().requires_grad_() for t in (hck[l + 1], xck[l]))
        (kel.h2x_layer_plain(layer, h1, x0, nbh, mask_ligand, ew) * dx).sum().backward()
        h0, x0b = (t.clone().requires_grad_() for t in (hck[l], xck[l]))
        (kel.x2h_layer_plain(layer, h0, x0b, nbh, mask_ligand, ew) * (dh + h1.grad)).sum() \
            .backward()
        dh, dx = h0.grad, x0.grad + x0b.grad
    grads = {n: p.grad for n, p in rn.named_parameters() if p.grad is not None}
    grads.update(dh0=dh, dx0=dx, de_w=ew.grad)
    return grads


def block_f64_refs(torch, rn, h, x, nbh, mask_ligand, e_w, gh, gx):
    """(plain32, want64): `block_vjp_chain` in float32 and in float64 at the
    checkpoints of the train-mode block kernel, as the block-VJP kernel
    gets them."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock

    with torch.no_grad():
        x2h, h2x = kblock.pack_pass_params(rn)
        hck, xck = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mask_ligand, e_w, MAX_LIGAND,
                                                    x2h, h2x)
    plain32 = block_vjp_chain(torch, rn, hck, xck, nbh, mask_ligand, e_w, gh, gx)
    want64 = block_vjp_chain(torch, copy.deepcopy(rn).double(), hck.double(), xck.double(), nbh,
                             mask_ligand, e_w.double(), gh.double(), gx.double())
    return plain32, want64


def margins(torch, dev, pocket, feat_dim, check=True) -> dict:
    """`bwd64_fields` of [train-block]'s block backward (B=4, N=608, K=32,
    L=9) and of [layers]' per-layer x2h and h2x backwards at the hybrid
    shape (N = 640, K = 95), on the inputs those phases make."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    out = {}
    model, _, h, x, _, mlig, nbh = knn_setup(torch, dev, pocket, feat_dim)
    rn = model.net.refine_net
    e_w, _, gh, gx = train_block_cotangents(torch, dev, rn, x, nbh, h)
    got, want = (block_grads(torch, rn, h, x, nbh, mlig, e_w, gh, gx, tr) for tr in (True, False))
    plain32, want64 = block_f64_refs(torch, rn, h, x, nbh, mlig, e_w, gh, gx)
    out["train_block"] = bwd64_fields("train-block backward", got, want, plain32, want64,
                                      per_tensor=False, check=check)
    del model, got, want, plain32, want64
    hmodel, _, hh, hx, hnode, hmlig, hnbh = hybrid_setup(torch, dev, pocket, feat_dim)
    net = hmodel.net.refine_net
    net64 = copy.deepcopy(net).double()
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():  # as layer_phases: its e_w, cotangents and the h2x pass's input
        e_w = net.edge_weights(hx, hnbh)[..., 0]
        h_ref = kel.x2h_layer_plain(net.base_block[0], hh, hx, hnbh, hmlig, e_w)
    cot = {"x2h": torch.randn(hh.shape, generator=gen, device=dev) * hnode[..., None],
           "h2x": torch.randn(hx.shape, generator=gen, device=dev)}
    for sub in ("x2h", "h2x"):
        args = (hh if sub == "x2h" else h_ref, hx, hnbh, hmlig, e_w, cot[sub], HYBRID_LIGAND)
        got, want = (layer_grads(torch, net, sub, tr, *args) for tr in (True, False))
        want64 = layer_grads(torch, net64, sub, False,
                             *[a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                               for a in args])
        out[f"layers_hybrid_{sub}_bwd"] = bwd64_fields(f"hybrid {sub} backward", got, want,
                                                       want, want64, check=check)
    torch.cuda.synchronize()
    return out


def pocket_batch(torch, dev, pocket, feat_dim, n_ligand_slots, sizes, seed,
                 max_protein=MAX_PROTEIN):
    """len(sizes) copies of the example pocket (572 atoms padded to
    max_protein, centred) with ligands of `sizes` atoms at the centre plus
    unit noise."""
    from targetdiff_tpu_torch.data.batch import ComplexBatch

    B = len(sizes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_prot = len(pocket["protein_pos"])
    ppos = torch.zeros((B, max_protein, 3), device=dev)
    pfeat = torch.zeros((B, max_protein, feat_dim), device=dev)
    ppos[:, :n_prot] = torch.as_tensor(pocket["protein_pos"], dtype=torch.float32, device=dev)
    pfeat[:, :n_prot] = torch.as_tensor(pocket["protein_feat"], device=dev)
    pmask = torch.zeros((B, max_protein), dtype=torch.bool, device=dev)
    pmask[:, :n_prot] = True
    ppos = torch.where(pmask[..., None], ppos - ppos[:, :n_prot].mean(1, keepdim=True), 0.0)
    lpos = torch.randn((B, n_ligand_slots, 3), generator=gen, device=dev)
    lmask = (torch.arange(n_ligand_slots, device=dev)[None]
             < torch.tensor(sizes, device=dev)[:, None])
    lv = torch.randint(0, NUM_CLASSES, (B, n_ligand_slots), generator=gen, device=dev)
    return ComplexBatch(ppos, pfeat, pmask, lpos, lv, lmask)


def layer_phases(torch, dev, feat, pocket, rn, h, x, nbh, mask_ligand, node_mask):
    """[layers]: the per-layer kernels against their plain versions, forward
    and backward (with two backward runs bitwise equal), on the hybrid graph
    of a hybrid flagship model (the example pocket with 64 ligand slots,
    N = 640, K = 95) and on the kNN graph of the sampling phases (N = 608,
    K = 32); times at the hybrid shape. Returns the four kernels' JSON fields
    and the hybrid model and batch."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kelv

    hmodel, hbatch, hh, hx, hnode, hmlig, hnbh = hybrid_setup(torch, dev, pocket,
                                                              feat.feature_dim)
    hrn = hmodel.net.refine_net
    gen = torch.Generator(device=dev).manual_seed(8)
    out, fields = {}, {}
    for shape, (net, h0, x0, g, mlig, nmask_rows, n_lig) in (
            ("hybrid", (hrn, hh, hx, hnbh, hmlig, hnode, HYBRID_LIGAND)),
            ("knn", (rn, h, x, nbh, mask_ligand, node_mask, MAX_LIGAND))):
        layer = net.base_block[0]
        with torch.no_grad():
            e_w = net.edge_weights(x0, g)[..., 0]
            px, ph = kel.pack_layer_params(layer)
            h_ref = kel.x2h_layer_plain(layer, h0, x0, g, mlig, e_w)
            h_k = kel.x2h_layer_cuda(h0, x0, g, mlig, e_w, px)
            x_ref = kel.h2x_layer_plain(layer, h_ref, x0, g, mlig, e_w)
            x_k = kel.h2x_layer_cuda(h_ref, x0, g, mlig, e_w, n_lig, ph)
        torch.cuda.synchronize()
        check_close(f"{shape} x2h layer", h_k, h_ref, **H_TOL)
        check_close(f"{shape} h2x layer", x_k, x_ref, **POS_TOL)
        errs = {"x2h": check_close(f"{shape} x2h layer (float32-grade)", h_k, h_ref, **X2H_TOL),
                "h2x": check_close(f"{shape} h2x layer (float32-grade)", x_k, x_ref, **H2X_TOL)}
        cot = {"x2h": torch.randn(h0.shape, generator=gen, device=dev) * nmask_rows[..., None],
               "h2x": torch.randn(x0.shape, generator=gen, device=dev)}
        net64 = copy.deepcopy(net).double()

        for sub in ("x2h", "h2x"):
            args = (h0 if sub == "x2h" else h_ref, x0, g, mlig, e_w, cot[sub], n_lig)
            got, again, want = (layer_grads(torch, net, sub, tr, *args)
                                for tr in (True, True, False))
            want64 = layer_grads(torch, net64, sub, False,
                                 *[a.double() if torch.is_tensor(a) and a.is_floating_point()
                                   else a for a in args])
            torch.cuda.synchronize()
            if sorted(got) != sorted(want) or not all(torch.equal(got[n], again[n]) for n in got):
                raise AssertionError(f"{shape} {sub} backward: other parameters reached, or two "
                                     "runs differ")
            rel = check_grads(got, want)
            errs[f"{sub}_bwd"] = max(float((got[n] - want[n]).abs().max())
                                     for n in ("dh", "dx", "de_w"))
            errs[f"{sub}_bwd_over_scale"] = rel
            errs[f"{sub}_bwd_margins"] = bwd64_fields(
                f"{shape} {sub} backward", got, want, want, want64,
                floor=shape == "knn")
            del want64
        out[shape] = errs
        if shape != "hybrid":
            continue
        # times at the hybrid shape; bounds from this graph's live edges
        nodes, lig_nodes, edges, lig_edges = layer_work(g, mlig, nmask_rows)
        inputs = (h0, x0, g.idx, g.mask, mlig, e_w)
        pieces, xl, hl = piece_fields(torch, kblock, kel, layer, h0, x0, g, mlig, e_w, px, ph,
                                      n_lig, (nodes, lig_nodes, edges, lig_edges), "hybrid")
        with torch.no_grad():
            # the launches alone give the layer kernels' outputs, bit for bit
            if not torch.equal(xl.out, h_k) or not torch.equal(hl.xout, x_k):
                raise AssertionError("hybrid edge launches alone differ from the layer kernels")
            f_ms = {"x2h": cuda_ms(torch, lambda: kel.x2h_layer_cuda(h0, x0, g, mlig, e_w, px)),
                    "h2x": cuda_ms(torch, lambda: kel.h2x_layer_cuda(h_ref, x0, g, mlig, e_w,
                                                                     n_lig, ph))}
            f_plain = {"x2h": cuda_ms(torch, lambda: kel.x2h_layer_plain(layer, h0, x0, g, mlig,
                                                                         e_w)),
                       "h2x": cuda_ms(torch, lambda: kel.h2x_layer_plain(layer, h_ref, x0, g,
                                                                         mlig, e_w))}
            b_ms = {"x2h": cuda_ms(torch, lambda: kelv.x2h_layer_bwd_cuda(
                        h0, x0, g, mlig, e_w, px, cot["x2h"]), reps=10),
                    "h2x": cuda_ms(torch, lambda: kelv.h2x_layer_bwd_cuda(
                        h_ref, x0, g, mlig, e_w, n_lig, ph, cot["h2x"]), reps=10)}
        b_plain = {}
        for sub, fn, hin in (("x2h", kel.x2h_layer_plain, h0),
                             ("h2x", kel.h2x_layer_plain, h_ref)):
            leaves = [t.clone().requires_grad_() for t in (hin, x0, e_w)]
            o = fn(layer, leaves[0], leaves[1], g, mlig, leaves[2])
            wrt = leaves + [p for n, p in layer.named_parameters() if f"{sub}_layers" in n]
            b_plain[sub] = cuda_ms(torch, lambda: torch.autograd.grad(o, wrt, cot[sub],
                                                                      retain_graph=True), reps=10)
            del o
        e = {"x2h": edges, "h2x": lig_edges}
        # h2x reads the graph of its destination rows, and h, x and the
        # ligand flag of those rows and of their valid edges' sources
        lig, _, either = h2x_rows(torch, g, h0.shape[1] - n_lig)
        fwd_bytes = {"x2h": nbytes(*inputs, px, h_k),
                     "h2x": nbytes(ph, x_k) + lig * g.idx.shape[-1] * (8 + 1 + 4)
                     + either * (h0.shape[-1] * 4 + 3 * 4 + 1)}
        shares = {}
        for sub, params in (("x2h", px), ("h2x", ph)):
            fwd = node_flops(sub, nodes, lig_nodes) + e[sub] * FLOP_EDGE[sub]
            bwd = node_flops(sub, nodes, lig_nodes, bwd=True) + e[sub] * FLOP_EDGE_BWD[sub]
            shares.update({sub: tc_share(fwd), f"{sub}_bwd": tc_share(bwd)})
            fields[sub] = dict(max_abs_err=errs[sub], ms=f_ms[sub], plain_ms=f_plain[sub],
                               **bound(fwd, fwd_bytes[sub]))
            fields[f"{sub}_bwd"] = dict(
                max_abs_err=errs[f"{sub}_bwd"], ms=b_ms[sub], plain_ms=b_plain[sub],
                **bound(bwd, nbytes(*inputs, params, cot[sub], h0, x0, e_w, params)))
        shape_str = f"B={B},N={h0.shape[1]},K={g.idx.shape[-1]}"
        live = dict(live_edges_x2h=edges, live_edges_h2x=lig_edges,
                    slots=int(g.mask.numel()), ms=f_ms, plain_ms=f_plain, bwd_ms=b_ms,
                    bwd_plain_ms=b_plain, **pieces)
    phase("layers", hybrid_shape=shape_str, hybrid=out["hybrid"],
          knn_shape=f"B={B},N={h.shape[1]},K={nbh.idx.shape[-1]}", knn=out["knn"], **live,
          bound_ms={k: v["bound_ms"] for k, v in fields.items()},
          bound_by={k: v["bound_by"] for k, v in fields.items()}, tensor_core_share=shares)
    return dict(fields, model=hmodel, batch=hbatch)


def hybrid_sample_phase(torch, dev, pocket, hmodel, failures):
    """[hybrid-sample]: 1000 DDPM steps of the hybrid model (64 ligand slots,
    K = 95) through `sample_diffusion_ligand`, on the per-layer kernels
    only, in float32. Returns the forward kernels' launches and the ms per
    step; a check that fails after the run is added to `failures`."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    steps = hmodel.num_timesteps
    kknn.LAUNCHES = kblock.LAUNCHES = kel.X2H_LAUNCHES = kel.H2X_LAUNCHES = 0
    t0 = time.perf_counter()
    res = sample_diffusion_ligand(
        hmodel, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(9),
        batch_size=B, num_steps=steps, max_protein=MAX_PROTEIN, max_ligand=HYBRID_LIGAND,
        rng=np.random.default_rng(9), dtype=torch.float32)
    wall = time.perf_counter() - t0
    launches = {"x2h": kel.X2H_LAUNCHES, "h2x": kel.H2X_LAUNCHES, "block": kblock.LAUNCHES,
                "knn": kknn.LAUNCHES}
    per_run = steps * FLAGSHIP["num_layers"]
    if launches["x2h"] != per_run or launches["h2x"] != per_run or launches["block"] or \
            launches["knn"]:
        raise AssertionError(f"hybrid-sample: expected the per-layer kernels once per layer and "
                             f"step and no block or kNN kernel, {launches}")
    for pos, v in zip(res["pos"], res["v"]):
        if pos.shape != (len(v), 3) or not np.isfinite(pos).all():
            raise AssertionError("hybrid-sample: a non-finite or misshaped molecule")
        if not ((v >= 0) & (v < NUM_CLASSES)).all():
            raise AssertionError("hybrid-sample: an atom type outside the vocabulary")
    centre = pocket["protein_pos"].mean(0)
    radius = float(np.linalg.norm(pocket["protein_pos"] - centre, axis=1).max())
    dist = float(max(np.linalg.norm(p.mean(0) - centre) for p in res["pos"]))
    near = dist < radius
    sample_s = res["time"][0]
    phase("hybrid-sample", samples=B, steps=steps, ligand_atoms=[len(v) for v in res["v"]],
          K=hmodel.net.refine_net.num_neighbors(), seconds=sample_s, wall_seconds=wall,
          ms_per_step=1e3 * sample_s / steps, mol_per_s=B / sample_s, launches=launches,
          max_centroid_offset_A=dist, pocket_radius_A=radius, near_pocket=near)
    if not near:  # raised after the remaining phases have run and printed
        failures.append(f"hybrid-sample: a molecule's centroid lies {dist} A from the "
                        f"pocket's centre, outside its {radius} A radius")
    return launches, 1e3 * sample_s / steps


# The bf16 kernels (dtype=torch.bfloat16, the sampling path's default, as the
# JAX package's): every output held within BF16_BAR of its scale (the JAX
# package's own bf16 bar, tools/kparity.py:91: max |a - b| / max |b|) of
# the bf16 plain version and of float64 (the float32 semantics computed in
# float64), with the median of each printed beside the max.
BF16_BAR = 2e-2


def bf16_margins(label, got, want16, want64) -> dict:
    """Max and median |got - want| over max |want| against the bf16 plain
    version and against float64; raises if a max reaches BF16_BAR."""
    out = {}
    for name, want in (("vs_bf16_plain", want16), ("vs_float64", want64)):
        d = (got.double() - want.double()).abs() / float(want.double().abs().max())
        out[name] = {"max": float(d.max()), "median": float(d.median())}
        if not out[name]["max"] < BF16_BAR:
            raise AssertionError(f"{label}: {out[name]['max']} of scale {name} "
                                 f"(bar {BF16_BAR})")
    return out


def knn_b100(torch, dev, model, pocket, feat_dim):
    """The bench's batch of 100 at the kNN shape (the example pocket 100
    times with ligands of LIGAND_SIZES atoms: N = 608, K = 32) embedded by
    `model`: (h, x, node_mask, mask_ligand, plain kNN graph)."""
    from targetdiff_tpu_torch.ops import graph as G

    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(*pocket_batch(
            torch, dev, pocket, feat_dim, MAX_LIGAND, LIGAND_SIZES * 25, 0))
    return h, x, node_mask, mlig, G.knn_graph(x, node_mask, K)


def bf16_x2h_launch(torch, run, out, h, h16, h64, nbh, rows, label) -> dict:
    """The bf16 x2h edge launch alone (`run()` writes `out` from the node
    launch's projections): two launches bitwise equal, rows without a valid
    edge keep h bitwise, the real rows within BF16_BAR of the bf16 plain
    layer (h16) and of float64 (h64). Returns its error fields."""
    run()
    first = out.clone()
    run()
    torch.cuda.synchronize()
    if not torch.equal(first, out):
        raise AssertionError(f"{label}: two launches differ")
    empty = ~nbh.mask.any(-1)
    if not torch.equal(first[empty], h[empty]):
        raise AssertionError(f"{label}: a row without a valid edge does not keep h bitwise")
    return dict(max_abs_err=float((first - h16)[rows].abs().max()),
                margins=bf16_margins(label, first[rows], h16[rows], h64[rows]),
                rows_without_edge=int(empty.sum()), live_edges=int(nbh.mask.sum()))


def bf16_x2h_b100(torch, kblock, kel, rn, rn64, b100, px) -> dict:
    """The bf16 x2h edge launch alone at kNN B=100 (`knn_b100`) on layer
    0's inputs, held as `bf16_x2h_launch`, timed (CUDA events and device
    time) beside its bound at the bf16 tensor-core rate and its plain
    version."""
    bf16 = torch.bfloat16
    h, x, node_mask, mlig, nbh = b100
    layer, layer64 = rn.base_block[0], rn64.base_block[0]
    with torch.no_grad():
        e_w = rn.edge_weights(x, nbh, bf16)[..., 0]
        xl = pass_launcher(torch, kblock, h, x, nbh, mlig, e_w, px, MAX_LIGAND, bf16=True)
        xl.node()
        h16 = kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w, bf16)
        h64 = kel.x2h_layer_plain(layer64, h.double(), x.double(), nbh, mlig, e_w.double())
        f = bf16_x2h_launch(torch, xl.x2h, xl.out, h, h16, h64, nbh, node_mask,
                            "bf16-block x2h edge launch B=100")
        del h64
        f.update(ms=cuda_ms(torch, xl.x2h), device_ms=device_ms(torch, xl.x2h),
                 plain_ms=cuda_ms(torch, lambda: kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w,
                                                                      bf16), reps=5))
    f.update(bound(f["live_edges"] * FLOP_EDGE["x2h"], xl.bytes["x2h"], PEAK_BF16_FLOPS))
    return f


def bf16_h2x_launch(torch, run, out, x, x16, x64, nbh, mask_ligand, n_ligand, label) -> dict:
    """The bf16 h2x edge launch alone (`run()` writes `out`, the rows [N -
    n_ligand, N), from the node launch's projections): two launches bitwise
    equal, rows of the ligand tail without a valid edge keep x bitwise, the
    ligand rows within BF16_BAR of the bf16 plain layer (x16) and of float64
    (x64). Returns its error fields."""
    run()
    first = out.clone()
    run()
    torch.cuda.synchronize()
    if not torch.equal(first, out):
        raise AssertionError(f"{label}: two launches differ")
    N = x.shape[1]
    empty = (torch.arange(N, device=x.device) >= N - n_ligand) & ~nbh.mask.any(-1)
    if not (bool(empty.any()) and torch.equal(first[empty], x[empty])):
        raise AssertionError(f"{label}: a row without a valid edge does not keep x bitwise")
    lig = mask_ligand
    return dict(max_abs_err=float((first - x16)[lig].abs().max()),
                margins=bf16_margins(label, first[lig], x16[lig], x64[lig]),
                rows_without_edge=int(empty.sum()), live_edges=int(nbh.mask[lig].sum()))


def bf16_h2x_b100(torch, kblock, kel, rn, rn64, b100, ph) -> dict:
    """The bf16 h2x edge launch alone at kNN B=100 (`knn_b100`) on layer
    0's inputs, held as `bf16_h2x_launch`, timed (CUDA events and device
    time) beside its bound at the bf16 tensor-core rate and its plain
    version."""
    bf16 = torch.bfloat16
    h, x, node_mask, mlig, nbh = b100
    layer, layer64 = rn.base_block[0], rn64.base_block[0]
    with torch.no_grad():
        e_w = rn.edge_weights(x, nbh, bf16)[..., 0]
        hl = pass_launcher(torch, kblock, h, x, nbh, mlig, e_w, ph, MAX_LIGAND, bf16=True)
        hl.node_rows()
        x16 = kel.h2x_layer_plain(layer, h, x, nbh, mlig, e_w, bf16)
        x64 = kel.h2x_layer_plain(layer64, h.double(), x.double(), nbh, mlig, e_w.double())
        f = bf16_h2x_launch(torch, hl.h2x, hl.xout, x, x16, x64, nbh, mlig, MAX_LIGAND,
                            "bf16-block h2x edge launch B=100")
        del x64
        f.update(ms=cuda_ms(torch, hl.h2x), device_ms=device_ms(torch, hl.h2x),
                 plain_ms=cuda_ms(torch, lambda: kel.h2x_layer_plain(layer, h, x, nbh, mlig, e_w,
                                                                      bf16), reps=5))
    f.update(bound(f["live_edges"] * FLOP_EDGE["h2x"], hl.bytes["h2x"], PEAK_BF16_FLOPS))
    return f


def bf16_block_phase(torch, kblock, kel, rn, h, x, nbh, mask_ligand, node_mask, work,
                     b100) -> dict:
    """[bf16-block]: the bf16 block kernels (`block_denoiser_cuda(dtype=
    torch.bfloat16)`) against the bf16 plain block (`block_forward(dtype=
    torch.bfloat16)`) and float64 at [block]'s shape (kNN B=4, N=608, K=32,
    L=9, flagship width), x and h of the ligand rows at BF16_BAR, two calls
    bitwise equal; then each bf16 launch alone on layer 0's inputs (node,
    the h2x pass's node launch, x2h edge, h2x edge, edge weights), held the
    same way (the node launch's ni and nj at NODE_REL against float64 of
    the same bf16 operands; the x2h edge launch on every real row, two
    launches bitwise equal, rows without a valid edge h bitwise:
    `bf16_x2h_launch`; the h2x edge launch on the ligand rows, the same with
    x: `bf16_h2x_launch`), and the x2h and h2x edge launches again at kNN
    B=100 (`b100`: `bf16_x2h_b100`, `bf16_h2x_b100`). Each timed (CUDA events and device time) beside its
    bound at the bf16 tensor-core rate and its plain version; the node
    launch also beside `torch.addmm` of its projection with bf16 operands.
    Returns the kernels' JSON fields."""
    bf16 = torch.bfloat16
    H = h.shape[-1]
    lig = mask_ligand
    with torch.no_grad():
        packed = kblock.pack_block_params(rn, bf16)
        runs = [kblock.block_denoiser_cuda(rn, h, x, nbh, mask_ligand, MAX_LIGAND, packed,
                                           dtype=bf16) for _ in range(2)]
        want16 = rn.block_forward(h, x, nbh, mask_ligand, dtype=bf16)
        rn64 = copy.deepcopy(rn).double()
        want64 = rn64.block_forward(h.double(), x.double(), nbh, mask_ligand)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("bf16-block: two calls differ")
    h_k, x_k = runs[0]
    block = {"x": bf16_margins("bf16-block x", x_k[lig], want16[1][lig], want64[1][lig]),
             "h": bf16_margins("bf16-block h", h_k[lig], want16[0][lig], want64[0][lig])}
    del want64
    with torch.no_grad():
        block_ms = cuda_ms(torch, lambda: kblock.block_denoiser_cuda(
            rn, h, x, nbh, mask_ligand, MAX_LIGAND, packed, dtype=bf16), reps=10)
        block_device_ms = device_ms(torch, lambda: kblock.block_denoiser_cuda(
            rn, h, x, nbh, mask_ligand, MAX_LIGAND, packed, dtype=bf16), calls=5)
        block_plain_ms = cuda_ms(torch, lambda: rn.block_forward(h, x, nbh, mask_ligand,
                                                                 dtype=bf16), reps=10)
    L = FLAGSHIP["num_layers"]
    block_work = L * block_flops(*work) + work[2] * FLOP_EW_EDGE
    worst = {ref: {stat: max(block[out][ref][stat] for out in block) for stat in ("max", "median")}
             for ref in ("vs_bf16_plain", "vs_float64")}
    fields = {"block": dict(max_abs_err=max(float((x_k - want16[1])[lig].abs().max()),
                                            float((h_k - want16[0])[lig].abs().max())),
                            margins=worst, margins_by_output=block, ms=block_ms,
                            device_ms=block_device_ms,
                            plain_ms=block_plain_ms, **bound(block_work, nbytes(
                                h, x, nbh.idx, nbh.mask, mask_ligand, packed.x2h, packed.h2x,
                                *packed.ew, h_k, x_k), PEAK_BF16_FLOPS))}

    # the launches alone on layer 0's inputs
    nodes, lig_nodes, edges, lig_edges = work
    layer, layer64 = rn.base_block[0], rn64.base_block[0]
    px, ph = ({k: v[:1] for k, v in st.items()} for st in (packed.x2h, packed.h2x))
    with torch.no_grad():
        e_w = rn.edge_weights(x, nbh, bf16)[..., 0]
        xl = pass_launcher(torch, kblock, h, x, nbh, mask_ligand, e_w, px, MAX_LIGAND, bf16=True)
        xl.node()
        node = (xl.ni.clone(), xl.nj.clone(), xl.q.clone())
        h16 = kel.x2h_layer_plain(layer, h, x, nbh, mask_ligand, e_w, bf16)
        h64 = kel.x2h_layer_plain(layer64, h.double(), x.double(), nbh, mask_ligand, e_w.double())
        x2h_edge = bf16_x2h_launch(torch, xl.x2h, xl.out, h, h16, h64, nbh, node_mask,
                                   "bf16-block x2h edge launch")
        hl = pass_launcher(torch, kblock, h16, x, nbh, mask_ligand, e_w, ph, MAX_LIGAND,
                           bf16=True)
        hl.node_rows()
        x16 = kel.h2x_layer_plain(layer, h16, x, nbh, mask_ligand, e_w, bf16)
        x64 = kel.h2x_layer_plain(layer64, h16.double(), x.double(), nbh, mask_ligand,
                                  e_w.double())
        node16 = kblock.node_projections_plain(h.double().reshape(-1, H), px)
        node64 = kblock.node_projections_plain(h.double().reshape(-1, H), {
            k: v.double() for k, v in kblock.pack_pass_params(rn)[0].items()})
        torch.cuda.synchronize()
        rel = max(float((g.double() - w).abs().max() / w.abs().max())
                  for g, w in zip(node[:2], node16[:2]))
        if not rel < NODE_REL:
            raise AssertionError(f"bf16-block node launch: ni|nj {rel} of scale from float64 "
                                 f"of its bf16 operands (bar {NODE_REL})")
        rows = node_mask
        pieces = {
            "node": dict(max_abs_err=float((node[2].double() - node16[2]).abs().max()),
                         ni_nj_max_rel_err=rel,
                         margins=bf16_margins("bf16-block node launch q", node[2], node16[2],
                                              node64[2])),
            "x2h_edge": x2h_edge,
            "h2x_edge": bf16_h2x_launch(torch, hl.h2x, hl.xout, x, x16, x64, nbh, mask_ligand,
                                        MAX_LIGAND, "bf16-block h2x edge launch"),
        }
        del h64, x64, node64
        plain = {"node": lambda: kblock.node_projections_plain(h.reshape(-1, H), px),
                 "x2h_edge": lambda: kel.x2h_layer_plain(layer, h, x, nbh, mask_ligand, e_w,
                                                         bf16),
                 "h2x_edge": lambda: kel.h2x_layer_plain(layer, h16, x, nbh, mask_ligand, e_w,
                                                         bf16)}
        # the library yardstick of the node launch: torch.addmm of its
        # projection [rows, 128] @ [128, 640] with bf16 operands (a bf16 result)
        hb, w_node, b_node = h.reshape(-1, H).to(bf16), px["w_node"][0], px["b_node"][0].to(bf16)
        runs = {"node": xl.node, "node_h2x": hl.node_rows, "x2h_edge": xl.x2h,
                "h2x_edge": hl.h2x, "node_addmm_bf16": lambda: torch.addmm(b_node, hb, w_node),
                "node_chain_bf16": node_chain(torch, h.reshape(-1, H), px, bf16=True)}
        for name, fn in runs.items():
            f = pieces.setdefault(name, {})
            f.update(ms=cuda_ms(torch, fn), device_ms=device_ms(torch, fn))
            if name in plain:
                f["plain_ms"] = cuda_ms(torch, plain[name])
        pieces["node"]["library_ms"] = pieces["node_addmm_bf16"]["ms"]
        pieces["node"]["library_device_ms"] = pieces.pop("node_addmm_bf16")["device_ms"]
        chain = pieces.pop("node_chain_bf16")
        pieces["node"].update(chain_ms=chain["ms"], chain_device_ms=chain["device_ms"])
    for name, flops, nb in (("x2h_edge", edges * FLOP_EDGE["x2h"], xl.bytes["x2h"]),
                            ("h2x_edge", lig_edges * FLOP_EDGE["h2x"], hl.bytes["h2x"]),
                            ("node", node_flops("x2h", nodes, lig_nodes), xl.bytes["node"]),
                            ("node_h2x", node_flops("h2x", nodes, lig_nodes),
                             hl.bytes["node_rows"])):
        pieces[name].update(bound(flops, nb, PEAK_BF16_FLOPS))
    fields.update(pieces)

    # the edge-weight launch alone
    with torch.no_grad():
        got = kblock.edge_weights_cuda(x, nbh, packed)
        again = kblock.edge_weights_cuda(x, nbh, packed)
        ew16 = rn.edge_weights(x, nbh, bf16)[..., 0]
        ew64 = rn64.edge_weights(x.double(), nbh)[..., 0]
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("bf16-block edge-weight launch: two launches differ")
        m = nbh.mask
        fields["ew"] = dict(
            max_abs_err=float((got - ew16)[m].abs().max()),
            margins=bf16_margins("bf16-block edge-weight launch", got[m], ew16[m], ew64[m]),
            ms=cuda_ms(torch, lambda: kblock.edge_weights_cuda(x, nbh, packed)),
            device_ms=device_ms(torch, lambda: kblock.edge_weights_cuda(x, nbh, packed)),
            plain_ms=cuda_ms(torch, lambda: rn.edge_weights(x, nbh, bf16)),
            **bound(work[2] * FLOP_EW_EDGE, nbytes(x, nbh.idx, got, *packed.ew),
                    PEAK_BF16_FLOPS))
    fields["x2h_edge_b100"] = bf16_x2h_b100(torch, kblock, kel, rn, rn64, b100, px)
    fields["h2x_edge_b100"] = bf16_h2x_b100(torch, kblock, kel, rn, rn64, b100, ph)
    fields["node_b100"] = node_b100_fields(torch, kblock, b100, px, ph, bf16=True)
    del rn64
    phase("bf16-block", shape=f"B={B},N={h.shape[1]},K={nbh.idx.shape[-1]},L={L},H=128,"
          "heads=16", bar=BF16_BAR, **fields)
    return fields


def bf16_layers_phase(torch, dev, kel, pocket, feat_dim) -> dict:
    """[bf16-layers]: the bf16 per-layer kernels (`x2h_layer_cuda` /
    `h2x_layer_cuda` with dtype=torch.bfloat16) against their bf16 plain
    layers and float64 at [layers]' hybrid shape (the example pocket with 64
    ligand slots: N = 640, K = 95): h of the valid rows and x of the ligand
    rows at BF16_BAR, two launches bitwise equal; each timed beside its
    bound at the bf16 tensor-core rate and its plain version; the x2h edge
    and h2x edge launches alone too (`bf16_x2h_launch`, `bf16_h2x_launch`:
    td_block_x2h_bf16, td_block_h2x_bf16 at K = 95), timed beside their
    bounds. Returns the two kernels' JSON fields."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock

    bf16 = torch.bfloat16
    hmodel, _, h, x, node_mask, mlig, nbh = hybrid_setup(torch, dev, pocket, feat_dim)
    layer = hmodel.net.refine_net.base_block[0]
    layer64 = copy.deepcopy(layer).double()
    with torch.no_grad():
        e_w = hmodel.net.refine_net.edge_weights(x, nbh)[..., 0]
        px, ph = kel.pack_layer_params(layer, bf16)
        h_k = [kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, px, bf16) for _ in range(2)]
        h16 = kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w, bf16)
        h64 = kel.x2h_layer_plain(layer64, h.double(), x.double(), nbh, mlig, e_w.double())
        x_k = [kel.h2x_layer_cuda(h16, x, nbh, mlig, e_w, HYBRID_LIGAND, ph, bf16)
               for _ in range(2)]
        x16 = kel.h2x_layer_plain(layer, h16, x, nbh, mlig, e_w, bf16)
        x64 = kel.h2x_layer_plain(layer64, h16.double(), x.double(), nbh, mlig, e_w.double())
    torch.cuda.synchronize()
    if not (torch.equal(*h_k) and torch.equal(*x_k)):
        raise AssertionError("bf16-layers: two launches differ")
    nodes, lig_nodes, edges, lig_edges = layer_work(nbh, mlig, node_mask)
    lig, _, either = h2x_rows(torch, nbh, h.shape[1] - HYBRID_LIGAND)
    K_ = nbh.idx.shape[-1]
    fields = {
        "x2h": dict(max_abs_err=float((h_k[0] - h16)[node_mask].abs().max()),
                    margins=bf16_margins("bf16-layers x2h", h_k[0][node_mask], h16[node_mask],
                                         h64[node_mask]),
                    **bound(node_flops("x2h", nodes, lig_nodes) + edges * FLOP_EDGE["x2h"],
                            nbytes(h, x, nbh.idx, nbh.mask, mlig, e_w, px, h_k[0]),
                            PEAK_BF16_FLOPS)),
        "h2x": dict(max_abs_err=float((x_k[0] - x16)[mlig].abs().max()),
                    margins=bf16_margins("bf16-layers h2x", x_k[0][mlig], x16[mlig], x64[mlig]),
                    **bound(node_flops("h2x", nodes, lig_nodes) + lig_edges * FLOP_EDGE["h2x"],
                            nbytes(ph, x_k[0]) + lig * K_ * (8 + 1 + 4)
                            + either * (h.shape[-1] * 4 + 3 * 4 + 1), PEAK_BF16_FLOPS)),
    }
    with torch.no_grad():
        xl = pass_launcher(torch, kblock, h, x, nbh, mlig, e_w, px, HYBRID_LIGAND, bf16=True)
        xl.node()
        edge = bf16_x2h_launch(torch, xl.x2h, xl.out, h, h16, h64, nbh, node_mask,
                               "bf16-layers x2h edge launch")
        edge.update(ms=cuda_ms(torch, xl.x2h), device_ms=device_ms(torch, xl.x2h),
                    **bound(edges * FLOP_EDGE["x2h"], xl.bytes["x2h"], PEAK_BF16_FLOPS))
        fields["x2h_edge"] = edge
        hl = pass_launcher(torch, kblock, h16, x, nbh, mlig, e_w, ph, HYBRID_LIGAND, bf16=True)
        hl.node_rows()
        edge = bf16_h2x_launch(torch, hl.h2x, hl.xout, x, x16, x64, nbh, mlig, HYBRID_LIGAND,
                               "bf16-layers h2x edge launch")
        edge.update(ms=cuda_ms(torch, hl.h2x), device_ms=device_ms(torch, hl.h2x),
                    **bound(lig_edges * FLOP_EDGE["h2x"], hl.bytes["h2x"], PEAK_BF16_FLOPS))
        fields["h2x_edge"] = edge
    del h64, x64
    with torch.no_grad():
        runs = {"x2h": (lambda: kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, px, bf16),
                        lambda: kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w, bf16)),
                "h2x": (lambda: kel.h2x_layer_cuda(h16, x, nbh, mlig, e_w, HYBRID_LIGAND, ph,
                                                   bf16),
                        lambda: kel.h2x_layer_plain(layer, h16, x, nbh, mlig, e_w, bf16))}
        for sub, (fn, plain) in runs.items():
            fields[sub].update(ms=cuda_ms(torch, fn), device_ms=device_ms(torch, fn),
                               plain_ms=cuda_ms(torch, plain))
    phase("bf16-layers", shape=f"B={B},N={h.shape[1]},K={K_}", bar=BF16_BAR,
          live_edges_x2h=edges, live_edges_h2x=lig_edges, **fields)
    return fields


def bf16_sample_phase(torch, dev, model, hmodel, pocket, f32_ms, hybrid_f32_ms,
                      failures) -> dict:
    """[bf16-sample]: 1000 DDPM steps of B=4 molecules through
    `sample_diffusion_ligand` at its default precision (bf16), as [sample]
    (kNN: the bf16 kNN-graph forward's block and edge-weight kernels, one a
    step, and their passes, L a step each) and as [hybrid-sample] (the bf16
    per-layer kernels, L a step each), with every float32 launch count
    zero; molecules finite, in the vocabulary and near the pocket; ms per
    step beside the float32 runs' of the same call. Returns the launches."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import cone as kcone
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    names = {"knn": (kknn, "LAUNCHES"), "cone": (kcone, "LAUNCHES"),
             "block": (kblock, "LAUNCHES"),
             "ew": (kblock, "EW_LAUNCHES"), "x2h_pass": (kblock, "X2H_PASS_LAUNCHES"),
             "h2x_pass": (kblock, "H2X_PASS_LAUNCHES"), "x2h_layer": (kel, "X2H_LAUNCHES"),
             "h2x_layer": (kel, "H2X_LAUNCHES"), "block_bf16": (kblock, "BF16_LAUNCHES"),
             "ew_bf16": (kblock, "BF16_EW_LAUNCHES"),
             "x2h_pass_bf16": (kblock, "BF16_X2H_PASS_LAUNCHES"),
             "h2x_pass_bf16": (kblock, "BF16_H2X_PASS_LAUNCHES"),
             "x2h_layer_bf16": (kel, "BF16_X2H_LAUNCHES"),
             "h2x_layer_bf16": (kel, "BF16_H2X_LAUNCHES")}
    L = FLAGSHIP["num_layers"]
    centre = pocket["protein_pos"].mean(0)
    radius = float(np.linalg.norm(pocket["protein_pos"] - centre, axis=1).max())
    out = {}
    for cutoff, m, n_ligand, seed, ref_ms in (("knn", model, MAX_LIGAND, 2, f32_ms),
                                              ("hybrid", hmodel, HYBRID_LIGAND, 9, hybrid_f32_ms)):
        steps = m.num_timesteps
        for mod, attr in names.values():
            setattr(mod, attr, 0)
        node_since = kblock.node_launch_counts()
        t0 = time.perf_counter()
        res = sample_diffusion_ligand(
            m, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(seed),
            batch_size=B, num_steps=steps, max_protein=MAX_PROTEIN, max_ligand=n_ligand,
            rng=np.random.default_rng(seed))
        wall = time.perf_counter() - t0
        launches = {k: getattr(mod, attr) for k, (mod, attr) in names.items()}
        launches.update(zip(("node", "node_bf16"),
                            np.subtract(kblock.node_launch_counts(), node_since).tolist()))
        want = dict.fromkeys(launches, 0)
        want["node_bf16"] = 2 * L * steps  # one a pass: x2h and h2x, each layer
        if cutoff == "knn":
            want.update(knn=steps, cone=steps, block_bf16=steps, ew_bf16=steps,
                        x2h_pass_bf16=L * steps, h2x_pass_bf16=L * steps)
        else:
            want.update(x2h_layer_bf16=L * steps, h2x_layer_bf16=L * steps)
        if launches != want:
            raise AssertionError(f"bf16-sample {cutoff}: launches {launches}, expected {want}")
        for pos, v in zip(res["pos"], res["v"]):
            if pos.shape != (len(v), 3) or not np.isfinite(pos).all():
                raise AssertionError(f"bf16-sample {cutoff}: a non-finite or misshaped molecule")
            if not ((v >= 0) & (v < NUM_CLASSES)).all():
                raise AssertionError(f"bf16-sample {cutoff}: an atom type outside the "
                                     "vocabulary")
        dist = float(max(np.linalg.norm(p.mean(0) - centre) for p in res["pos"]))
        if not dist < radius:  # raised after the remaining phases have run and printed
            failures.append(f"bf16-sample {cutoff}: a molecule's centroid lies {dist} A from "
                            f"the pocket's centre, outside its {radius} A radius")
        ms = 1e3 * res["time"][0] / steps
        out[cutoff] = {k: v for k, v in launches.items() if v}
        phase(f"bf16-sample {cutoff}", samples=B, steps=steps,
              ligand_atoms=[len(v) for v in res["v"]], seconds=res["time"][0],
              wall_seconds=wall, ms_per_step=ms, float32_ms_per_step=ref_ms,
              float32_over_bf16=ref_ms / ms, mol_per_s=B / res["time"][0], launches=out[cutoff],
              max_centroid_offset_A=dist, pocket_radius_A=radius)
    return out


def weight_grad_products():
    """The weight-gradient products of the timed B=32 `fast` step's passes
    (csrc/pass_bwd.cuh run_pass; N = 416, K = 32, 32 ligand slots), and one
    M that is not a whole number of 32-row stages: (class, name, M, P, Q, X's
    row length, its first column, Y's row length, its first column). Row
    lengths and offsets are run_pass's: k|v activations and their gradients
    [2H] (h2x: [H + 16]), edge features [84], node rows [H], the row buffer
    [1792] (h2x: [1680]) whose dq starts at 1408 (1296)."""
    n = TRAIN_PROTEIN + MAX_LIGAND
    ex, eh, bn = TRAIN_B * n * K, TRAIN_B * MAX_LIGAND * K, TRAIN_B * n
    fe = 4 * RK + 4
    return [("x2h_edge", "w2k", ex, HW, HW, 2 * HW, 0, 2 * HW, 0),
            ("x2h_edge", "w2v", ex, HW, HW, 2 * HW, HW, 2 * HW, HW),
            ("x2h_edge", "table", ex, fe, 2 * HW, fe, 0, 2 * HW, 0),
            ("h2x_edge", "w2k", eh, HW, HW, 2 * HW, 0, HW + NHEADS, 0),
            ("h2x_edge", "w2v", eh, HW, NHEADS, 2 * HW, HW, HW + NHEADS, HW),
            ("h2x_edge", "table", eh, fe, 2 * HW, fe, 0, 2 * HW, 0),
            ("node", "w_node x2h", bn, HW, 5 * HW, HW, 0, 1792, 0),
            ("node", "w_q2 x2h", bn, HW, HW, HW, 0, 1792, 1408),
            ("node", "w_node h2x", bn, HW, 5 * HW, HW, 0, 1680, 0),
            ("node", "w_q2 h2x", bn, HW, HW, HW, 0, 1680, 1296),
            ("odd", "w2k", ex + 7, HW, HW, 2 * HW, 0, 2 * HW, 0)]


def weight_grad_operands(torch, dev):
    """(class, name, M, P, Q, X, Y) of each of `weight_grad_products`, one at a
    time: zero-mean operands from one seeded generator whose columns span
    1e-9 to 1e5 in a seeded order, X and Y column slices of wider rows as
    run_pass passes them."""
    gen = torch.Generator(device=dev).manual_seed(11)

    def operand(M, ld, off, n):
        order = torch.randperm(n, generator=gen, device=dev)
        rows = torch.randn((M, ld), generator=gen, device=dev)
        rows[:, off:off + n] *= 10.0 ** torch.linspace(-9, 5, n, device=dev)[order]
        return rows[:, off:off + n]

    for cls, name, M, P, Q, ldx, ox, ldy, oy in weight_grad_products():
        yield cls, name, M, P, Q, operand(M, ldx, ox, P), operand(M, ldy, oy, Q)


# edge_bwd_kernel's transposed second layers alone (transposed_layers in
# tprod_kernel) against the float64 product of their operands: every entry
# within TPROD_BAR of the root-sum-square of its terms (three-term TF32, and
# bf16 against its rounded operands, sit ~1e-6 from it;
# tests/test_torch_edge_bwd_tc.py holds the arithmetic, one TF32 term misses).
TPROD_BAR = 1e-5


def tprod_phase(torch, dev, dtype=None) -> dict:
    """[train-block tprod] ([bf16-train-block tprod]): the backward's
    transposed second layers alone (block_vjp.transposed_product_cuda) at
    the B=32 step's edges (Ep = 32 x 416 x 32), both passes' shapes (x2h:
    d [Ep, 256], h2x: d [Ep, 144]), on seeded d rows of 1e-3 .. 1e3 and
    weights of the flagship's scale: its error against float64 over the
    terms' root-sum-square, two launches bitwise equal, its device ms beside
    its bound (the product at the TF32 or bf16 tensor-core rate, d read and
    da written once) and `torch.mm` of the same product per half ([Ep, C] x
    [C, 128], bf16 operands for bf16: this part's library call)."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.precision import round_bf16

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    H, E = FLAGSHIP["hidden_dim"], TRAIN_B * (TRAIN_PROTEIN + MAX_LIGAND) * K
    out = {}
    for sub, V in (("x2h", H), ("h2x", FLAGSHIP["n_heads"])):
        gen = torch.Generator(device=dev).manual_seed(V)
        d = torch.randn((E, H + V), generator=gen, device=dev)
        d *= 10.0 ** (torch.rand((E, 1), generator=gen, device=dev) * 6 - 3)
        w2k = torch.randn((H, H), generator=gen, device=dev) * H ** -0.5
        w2v = torch.randn((H, V), generator=gen, device=dev) * H ** -0.5
        w2k, w2v = w2k.to(dtype), w2v.to(dtype)
        got = kvjp.transposed_product_cuda(d, w2k, w2v, dtype)
        again = kvjp.transposed_product_cuda(d, w2k, w2v, dtype)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"tprod {sub}: two launches differ")
        dr = (round_bf16(d) if bf16 else d).double()
        err = 0.0
        for half, (c0, c1, w) in enumerate(((0, H, w2k), (H, H + V, w2v))):
            dh, w64 = dr[:, c0:c1], w.double()
            exact, rss = dh @ w64.T, ((dh * dh) @ (w64 * w64).T).sqrt()
            gh = got[:, half * H:(half + 1) * H].double()
            err = max(err, float(((gh - exact).abs() / rss.clamp(min=1e-300)).max()))
            del exact, rss, gh
        if not err < TPROD_BAR:
            raise AssertionError(f"tprod {sub}: {err} of the terms' root-sum-square "
                                 f"(bar {TPROD_BAR})")
        ms = kernel_device_ms(torch, lambda: kvjp.transposed_product_cuda(d, w2k, w2v, dtype),
                              "tprod_kernel", calls=5)
        dm = d.to(dtype)
        wkT, wvT = w2k.T.contiguous(), w2v.T.contiguous()
        mm_ms = device_ms(torch, lambda: (torch.mm(dm[:, :H], wkT), torch.mm(dm[:, H:], wvT)),
                          calls=5)
        b = bound((2 * E * (H + V) * H, 0), E * (H + V) * 4 + E * 2 * H * 4 + nbytes(w2k, w2v),
                  PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS)
        out[sub] = {"edges": E, "max_err_over_rss": err, "device_ms": ms, **b,
                    "mm_device_ms": mm_ms}
        del d, dr, got, again, dm
        torch.cuda.empty_cache()
    return out


def stage_w2_phase(torch, dev, dtype=None) -> dict:
    """[train-block stage-w2] ([bf16-train-block stage-w2]): the second-layer
    staging alone (block_vjp.stage_w2) as a whole-block backward runs it, one
    launch for the flagship's 2L passes (x2h V = H and h2x V = heads
    alternating, seeded weights of the flagship's scale, a pack of `dtype`):
    bitwise equal to its plain version (`block_vjp.pass_words`, run on the
    same card tensors) and to one launch a pass, two launches bitwise equal;
    its CUDA-event and device ms beside its bound (`stage_w2_bytes`: bytes)
    and the plain version's ms."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    H, L, heads = FLAGSHIP["hidden_dim"], FLAGSHIP["num_layers"], FLAGSHIP["n_heads"]
    gen = torch.Generator(device=dev).manual_seed(13)
    widths = [heads if i % 2 else H for i in range(2 * L)]
    w2k = [(torch.randn((H, H), generator=gen, device=dev) * H ** -0.5).to(dtype)
           for _ in widths]
    w2v = [(torch.randn((H, V), generator=gen, device=dev) * H ** -0.5).to(dtype)
           for V in widths]
    counter = "BF16_STAGE_W2_LAUNCHES" if bf16 else "STAGE_W2_LAUNCHES"
    before = getattr(kvjp, counter)
    got = kvjp.stage_w2(w2k, w2v, dtype)
    again = kvjp.stage_w2(w2k, w2v, dtype)
    torch.cuda.synchronize()
    if getattr(kvjp, counter) - before != 2:
        raise AssertionError(f"stage-w2: {getattr(kvjp, counter) - before} launches for two "
                             f"stagings of {len(widths)} passes (want 2)")

    def plain():
        return torch.stack([kvjp.pass_words(k, v, dtype) for k, v in zip(w2k, w2v)])

    want = plain()
    one = torch.cat([kvjp.stage_w2([k], [v], dtype) for k, v in zip(w2k, w2v)])
    label = "bf16 stage-w2" if bf16 else "stage-w2"
    for name, other in (("a second launch", again), ("the plain layouts", want),
                        ("one launch a pass", one)):
        if not torch.equal(got, other):
            raise AssertionError(f"{label}: the staged words differ from {name}")
    frags = torch.zeros_like(got)
    b = bound((0, 0), sum(stage_w2_bytes(V, 2 if bf16 else 4) for V in widths))
    out = {"passes": len(widths), "launches_per_staging": 1, "max_abs_err": 0.0,
           "bitwise_equal_plain": True, "bitwise_equal_one_launch_a_pass": True,
           "ms": cuda_ms(torch, lambda: kvjp.stage_w2(w2k, w2v, dtype, frags)),
           "device_ms": kernel_device_ms(torch, lambda: kvjp.stage_w2(w2k, w2v, dtype, frags),
                                         "stage_w2_kernel", calls=20),
           "plain_ms": cuda_ms(torch, plain, reps=5), **b}
    del got, again, want, one, frags
    torch.cuda.empty_cache()
    return out


def tprod_entry(tprod: dict) -> dict:
    """The kernels line's fields of the transposed product alone (tprod_phase)
    in the backward's entry: x2h's, and h2x's under tprod_h2x_."""
    return {f"tprod{'' if sub == 'x2h' else '_h2x'}_{k}": f[k] for sub, f in tprod.items()
            for k in ("device_ms", "bound_ms", "bound_by", "mm_device_ms", "max_err_over_rss")}


def weight_grad_phase(torch, dev, dtype=None) -> dict:
    """The weight-gradient kernel alone (`weight_grad_cuda`) at each of
    `weight_grad_products`, on `weight_grad_operands`: within WG_BAR of
    float64 (the plain version's error beside it), two launches bitwise
    equal; each timed by CUDA events and by profiler device time beside its
    bound (2MPQ FLOP at the TF32 rate; X's P and Y's Q columns read once, the
    output written once) and the library call `torch.mm(X.T, Y)` (float32,
    TF32 off). dtype=torch.bfloat16: the bf16 instantiation, within WG16_BAR
    of float64 of the bf16-rounded operands and at least ten times that from
    float64 of the unrounded ones (the operands were rounded), its bound at
    the bf16 rate, the library call on the rounded operands, the float32
    kernel timed beside. Returns the products' fields and, per class, the
    mean per launch of ms, plain_ms, bound_ms, library_ms and device_ms."""
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg
    from targetdiff_tpu_torch.ops.precision import round_bf16

    bf16 = dtype == torch.bfloat16
    kw, bar = ({"dtype": dtype}, WG16_BAR) if bf16 else ({}, WG_BAR)
    products = {}
    for cls, name, M, P, Q, X, Y in weight_grad_operands(torch, dev):
        with torch.no_grad():
            got, again = [kwg.weight_grad_cuda(X, Y, **kw) for _ in range(2)]
            plain = kwg.weight_grad_plain(X, Y, **kw)
            Xr, Yr = (round_bf16(X), round_bf16(Y)) if bf16 else (X, Y)
            x, y = Xr.double(), Yr.double()
            want, scale = x.T @ y, ((x * x).T @ (y * y)).sqrt()
            if bf16:
                x, y = X.double(), Y.double()
                exact, s_exact = x.T @ y, ((x * x).T @ (y * y)).sqrt()
            del x, y
        torch.cuda.synchronize()
        label = f"{'bf16 ' if bf16 else ''}weight-grad {cls} {name} M={M} P={P} Q={Q}"
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two launches differ")
        err = (got.double() - want).abs()
        over = float((err / scale).max())
        if not over <= bar or not bool(got.isfinite().all()):
            raise AssertionError(f"{label}: error {over} of s (bar {bar})")
        f = {"class": cls, "M": M, "P": P, "Q": Q, "max_err_over_s": over,
             "plain_max_err_over_s": float(((plain.double() - want).abs() / scale).max()),
             "max_abs_err": float(err.max())}
        if bf16:
            unrounded = float(((got.double() - exact).abs() / s_exact).max())
            if not unrounded > 10 * over:
                raise AssertionError(f"{label}: {unrounded} of s from the unrounded operands' "
                                     f"product, not ten times its {over}")
            f["max_err_over_s_vs_unrounded"] = unrounded
            del exact, s_exact
        del want, scale, err, plain
        runs = {"": lambda: kwg.weight_grad_cuda(X, Y, got, **kw),
                "plain_": lambda: kwg.weight_grad_plain(X, Y, **kw),
                "library_": lambda: torch.mm(Xr.T, Yr)}
        if bf16:
            runs["float32_"] = lambda: kwg.weight_grad_cuda(X, Y, got)
        for key, fn in runs.items():
            f[f"{key}ms"] = cuda_ms(torch, fn)
            f[f"{key}device_ms"] = device_ms(torch, fn)
        # the call's two kernels apart (the profiler counts the reduction's
        # wait for the product, a programmatic dependent, as its time) and the
        # split: row chunks, clusters, the partials reduce_kernel sums
        for part, piece in (("weight_grad", "weight_grad_kernel"), ("reduce", "::reduce_kernel")):
            f[f"{part}_device_ms"] = kernel_device_ms(torch, runs[""], piece)
        f.update({f"split_{k}": v for k, v in kwg.plan(M, P, Q, **kw).items()})
        f.update(bound((2 * M * P * Q, 0), 4 * (M * P + M * Q + P * Q),
                       PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS))
        products[f"{cls} {name}"] = f
        del X, Y, Xr, Yr, got, again
        torch.cuda.empty_cache()
    classes = {}
    for cls in ("x2h_edge", "h2x_edge", "node"):
        rows = [f for f in products.values() if f["class"] == cls]
        keys = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "weight_grad_device_ms",
                "reduce_device_ms") + (("float32_ms",) if bf16 else ())
        mean = {k: float(np.mean([f[k] for f in rows])) for k in keys}
        classes[cls] = dict(max_abs_err=max(f["max_abs_err"] for f in rows), **mean,
                            bound_by="bytes" if all(f["bound_by"] == "bytes" for f in rows)
                            else "operations")
    return {"products": products, "classes": classes}


def node_bwd_operands(torch, dev, rows, V, seed=0):
    """The backward's node kernel's operands (`node_bwd_cuda` order: rowbuf,
    q1, dh, q_ln, w_q2T, w_nodeT) for `rows` rows of a pass of value width V,
    seeded: gradient rows spanning two decades, q1 with a shifted mean."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    rowbuf = randn(rows, kvjp.row_layout(HW, V)["width"])
    rowbuf *= 10.0 ** (torch.rand((rows, 1), generator=gen, device=dev) * 2 - 1)
    q1 = randn(rows, HW, scale=2.0) + 0.3
    q_ln = torch.stack([1.0 + randn(HW, scale=0.2), randn(HW, scale=0.3)])
    return (rowbuf, q1, randn(rows, HW), q_ln, randn(HW, HW, scale=HW ** -0.5),
            randn(5 * HW, HW, scale=(5 * HW) ** -0.5))


def node_bwd_errs(got, want) -> dict:
    """The largest |got - want| of each output of the node kernel (dq1, the
    query LayerNorm's partials, qa, dh; `node_bwd_cuda` / `node_bwd_plain`
    tuples), over that output's largest |want| (`_over_scale`) and alone
    (`_abs`)."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp

    lay = kvjp.row_layout(HW, got[0].shape[1] - 13 * HW)
    pieces = {"dq1": lambda r: r[0][:, 4 * HW:5 * HW],
              "qln": lambda r: r[0][:, lay["qln"]:lay["qln"] + 2 * HW],
              "qa": lambda r: r[1], "dh": lambda r: r[2]}
    out = {}
    for k, f in pieces.items():
        err = float((f(got).double() - f(want).double()).abs().max())
        out[f"{k}_abs"], out[f"{k}_over_scale"] = err, err / float(f(want).abs().max())
    return out


def node_bwd_phase(torch, dev, dtype=None) -> dict:
    """[train-block node-bwd]: the backward's node kernel alone
    (`node_bwd_cuda`) at the B=32 step's rows (N = 416: 13,312, 64-row tiles)
    for both passes' row buffers (x2h V = 128, h2x V = 16) and at the B=4
    block backward's (2,432, 32-row tiles), on `node_bwd_operands`: every
    output within NODE_BWD_BAR of its scale from float64 (`node_bwd_plain`
    on float64 copies, with the kernel's ReLU mask; the plain float32
    version's error beside it), two launches bitwise equal; CUDA-event,
    device and plain ms beside its bound (each row's dq, dproj[:, :4H], q1
    and dh read and dq1, the partials, qa and dh written once, the weights
    read once; the products at the TF32 rate) and `torch.mm` of its dh
    product [rows, 5H] [5H, H] (float32, TF32 off), no single PyTorch call
    computing the whole kernel; `node_bwd_info`. dtype=torch.bfloat16
    ([bf16-train-block node-bwd]): the bf16 instantiation against its plain
    version (`node_bwd_plain(dtype=bf16)` on float64 copies) within
    NODE16_BAR and more than ten times that from the unrounded float64
    version, the products at the bf16 rate, `torch.mm` on the rounded
    operands, the float32 kernel timed beside."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.precision import round_bf16

    bf16 = dtype == torch.bfloat16
    kw, bar = ({"dtype": dtype}, NODE16_BAR) if bf16 else ({}, NODE_BWD_BAR)
    rnd = round_bf16 if bf16 else (lambda t: t)
    train_rows = TRAIN_B * (TRAIN_PROTEIN + MAX_LIGAND)
    out = {}
    for label, rows, V in (("x2h", train_rows, HW), ("h2x", train_rows, NHEADS),
                           ("block_h2x", B * (MAX_PROTEIN + MAX_LIGAND), NHEADS)):
        ops = node_bwd_operands(torch, dev, rows, V)
        rowbuf, q1, dh, q_ln, w_q2T, w_nodeT = ops
        with torch.no_grad():
            got, again = [kvjp.node_bwd_cuda(rowbuf.clone(), q1, dh.clone(), q_ln, w_q2T,
                                             w_nodeT, **kw) for _ in range(2)]
            mask = got[1] > 0
            want = kvjp.node_bwd_plain(*[t.double() for t in ops], relu_mask=mask, **kw)
            plain = kvjp.node_bwd_plain(*ops, relu_mask=mask, **kw)
            torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"node-bwd {label}: two launches differ")
        errs, plain_errs = node_bwd_errs(got, want), node_bwd_errs(plain, want)
        worst = max(v for k, v in errs.items() if k.endswith("_over_scale"))
        if not worst < bar or not all(bool(t.isfinite().all()) for t in got):
            raise AssertionError(f"node-bwd {label}: error {worst} of scale (bar {bar}): "
                                 f"{errs}")
        f = {"rows": rows, "V": V, "max_err_over_scale": worst,
             "plain_max_err_over_scale": max(v for k, v in plain_errs.items()
                                             if k.endswith("_over_scale")),
             "max_abs_err": max(v for k, v in errs.items() if k.endswith("_abs"))}
        if bf16:  # the operands were rounded: far from the unrounded float64 version
            with torch.no_grad():
                exact = kvjp.node_bwd_plain(*[t.double() for t in ops], relu_mask=mask)
            f["max_err_over_scale_vs_unrounded"] = max(
                v for k, v in node_bwd_errs(got, exact).items() if k.endswith("_over_scale"))
            if not f["max_err_over_scale_vs_unrounded"] > 10 * bar:
                raise AssertionError(f"node-bwd {label}: {f} not ten times the bar {bar} from "
                                     "the unrounded version")
            del exact
        del want, plain, again
        rb, qa, dhc = got
        dproj, wT = rnd(rb[:, :5 * HW]).contiguous(), rnd(w_nodeT)
        runs = {"": lambda: kvjp.node_bwd_cuda(rb, q1, dhc, q_ln, w_q2T, w_nodeT, qa, **kw),
                "plain_": lambda: kvjp.node_bwd_plain(*ops, **kw),
                "dh_mm_": lambda: torch.mm(dproj, wT)}
        if bf16:
            runs["float32_"] = lambda: kvjp.node_bwd_cuda(rb, q1, dhc, q_ln, w_q2T, w_nodeT, qa)
        with torch.no_grad():
            for key, fn in runs.items():
                f[f"{key}ms"] = cuda_ms(torch, fn)
                f[f"{key}device_ms"] = device_ms(torch, fn)
        f.update(bound((2 * rows * 6 * HW * HW, rows * 10 * HW),
                       4 * (rows * 12 * HW + 6 * HW * HW + 2 * HW),
                       PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS))
        f.update(kvjp.node_bwd_info(rows, **kw))
        out[label] = f
        del ops, rowbuf, q1, dh, got, rb, dhc, qa, dproj, wT
        torch.cuda.empty_cache()
    return out


def train_setup(torch, dev, feat_dim):
    """The `fast` train step at the bench's train shape: [train]'s batch (B=32
    synthetic complexes, data/synth.py, seed 3), a flagship model of seeded
    random weights, its Adam state, the step and the step's generator."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.trainer import create_train_state, make_train_step
    from targetdiff_tpu_torch.utils import train as train_utils

    tb = train_batch(dev)
    torch.manual_seed(1)
    tmodel = DiffusionModel(Config(FLAGSHIP), feat_dim, NUM_CLASSES, device=dev,
                            max_protein=TRAIN_PROTEIN, max_ligand=MAX_LIGAND)
    state = create_train_state(tmodel, train_utils.get_optimizer(Config(OPTIMIZER),
                                                                 tmodel.parameters()))
    step = make_train_step(tmodel, pos_noise_std=0.1, time_sampling="importance")
    return tb, tmodel, state, step, torch.Generator(device=dev).manual_seed(0)


def train_phases(torch, dev, model, rn, h, x, nbh, mask_ligand, node_mask, batch, pocket, feat,
                 hmodel, hbatch):
    """[train-block], [train-loss], [train], [train-pl], [train-cli]. Returns
    the two whole-block training kernels' JSON fields and the per-layer
    backwards' launches in the [train-pl] steps."""
    from targetdiff_tpu_torch.cli import train_diffusion
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.datasets import PaddedLoader, get_dataset
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kelv
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand
    from targetdiff_tpu_torch.trainer import create_train_state, make_eval_step, make_train_step
    from targetdiff_tpu_torch.utils import train as train_utils
    from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict, load_npz_params

    # ---- [train-block]: train-mode forward and backward kernels vs the plain block ----
    e_w, gen, gh, gx = train_block_cotangents(torch, dev, rn, x, nbh, h)
    with torch.no_grad():
        x2h, h2x = kblock.pack_pass_params(rn)
    # checkpoints [L+1,B,N,.]: slot 0 the input, slot L the block's output
    want = kblock.block_denoiser_train_plain(rn, h, x, nbh, mask_ligand, e_w)
    with torch.no_grad():
        hck_k, xck_k = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mask_ligand, e_w,
                                                        MAX_LIGAND, x2h, h2x)
    torch.cuda.synchronize()
    ck = node_mask[None, :, :, None]
    fwd_err = max(check_close("train fwd hck", hck_k * ck, want[0] * ck, **H_TOL),
                  check_close("train fwd xck", xck_k * ck, want[1] * ck, **POS_TOL))

    def fwd_bwd(trainable):
        return block_grads(torch, rn, h, x, nbh, mask_ligand, e_w, gh, gx, trainable)

    g_k, g_again, g_p = fwd_bwd(True), fwd_bwd(True), fwd_bwd(False)
    g_32, g_64 = block_f64_refs(torch, rn, h, x, nbh, mask_ligand, e_w, gh, gx)
    torch.cuda.synchronize()
    if sorted(g_k) != sorted(g_p):
        raise AssertionError("train-block: the kernel path reached other parameters")
    if not all(torch.equal(g_k[n], g_again[n]) for n in g_k):
        raise AssertionError("train-block: two backward runs differ")
    bwd_rel = check_grads(g_k, g_p)
    bwd_margins = bwd64_fields("train-block backward", g_k, g_p, g_32, g_64, per_tensor=False)
    del g_again, g_32, g_64
    bwd_err = max(float((g_k[n] - g_p[n]).abs().max()) for n in ("dh0", "dx0", "de_w"))
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: kblock.block_denoiser_train_cuda(
            rn, h, x, nbh, mask_ligand, e_w, MAX_LIGAND, x2h, h2x), reps=10)
        fwd_plain_ms = cuda_ms(torch, lambda: kblock.block_denoiser_train_plain(
            rn, h, x, nbh, mask_ligand, e_w), reps=10)
        bwd_ms = cuda_ms(torch, lambda: kvjp.block_bwd_cuda(
            hck_k, xck_k, nbh.idx, nbh.mask, mask_ligand, e_w, MAX_LIGAND, x2h, h2x, gh, gx),
            reps=10)
    # the plain backward alone: autograd through one recorded graph of the
    # plain block, to h, x, e_w and the parameters the block uses
    leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
    outs = rn.block_forward(leaves[0], leaves[1], nbh, mask_ligand, e_w=leaves[2])
    wrt = leaves + [p for n, p in rn.named_parameters() if n in g_p]
    bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(outs, wrt, (gh, gx),
                                                              retain_graph=True), reps=10)
    del outs
    step_ms = cuda_ms(torch, lambda: fwd_bwd(True), reps=10)
    step_plain_ms = cuda_ms(torch, lambda: fwd_bwd(False), reps=10)
    work = layer_work(nbh, mask_ligand, node_mask)
    L = FLAGSHIP["num_layers"]
    fwd_work, bwd_work = L * block_flops(*work), L * block_flops(*work, bwd=True)
    fwd_bound = bound(
        fwd_work, nbytes(h, x, nbh.idx, nbh.mask, mask_ligand, e_w, x2h, h2x, hck_k, xck_k))
    bwd_bound = bound(
        bwd_work,
        nbytes(hck_k, xck_k, nbh.idx, nbh.mask, mask_ligand, e_w, x2h, h2x, gh, gx)
        + nbytes(h, x, e_w, x2h, h2x))  # outputs: dh0, dx0, de_w and the weight gradients
    phase("train-block", shape=f"B={B},N={h.shape[1]},K={K},L={L}",
          max_abs_err_fwd=fwd_err, max_abs_err_dh_dx_dew=bwd_err, max_grad_err_over_scale=bwd_rel,
          bwd_margins=bwd_margins,
          edge_bwd_kernel={sub: kvjp.edge_bwd_info(K, sub == "h2x") for sub in ("x2h", "h2x")},
          fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
          fwd_bwd_ms=step_ms, fwd_bwd_plain_ms=step_plain_ms, fwd_bound_ms=fwd_bound["bound_ms"],
          bwd_bound_ms=bwd_bound["bound_ms"], fwd_bound_by=fwd_bound["bound_by"],
          bwd_bound_by=bwd_bound["bound_by"], fwd_tensor_core_share=tc_share(fwd_work),
          bwd_tensor_core_share=tc_share(bwd_work))
    wgrad = weight_grad_phase(torch, dev)
    phase("train-block weight-grad", bar_over_s=WG_BAR,
          worst_err_over_s=max(f["max_err_over_s"] for f in wgrad["products"].values()),
          products=wgrad["products"])
    node_bwd = node_bwd_phase(torch, dev)
    phase("train-block node-bwd", bar_over_scale=NODE_BWD_BAR, **node_bwd)
    adjacency = adjacency_phase(torch, dev)
    phase("train-block adj", shape=f"B={TRAIN_B},N={TRAIN_PROTEIN + MAX_LIGAND},K={K}",
          **adjacency)
    tprod = tprod_phase(torch, dev)
    phase("train-block tprod", bar_over_rss=TPROD_BAR, **tprod)
    stage = stage_w2_phase(torch, dev)
    phase("train-block stage-w2", **stage)

    # ---- [train-loss]: the whole loss, kernel path vs eager path, injected draws ----
    # (the per-layer path's parity on the same draws is reported in [train-pl])
    t, eps, u = loss_draws(torch, model, batch, gen)
    loss_parity = loss_vs_eager(torch, model, batch, t, eps, u, "train-loss",
                                impls=("fast", "fast_pl"))
    phase("train-loss", **loss_parity["fast"])

    # ---- [train]: make_train_step at the bench's train shape ----
    tb, tmodel, state, step, tgen = train_setup(torch, dev, feat.feature_dim)
    # the loss and every gradient at this shape, both kernel paths against eager
    torch.cuda.reset_peak_memory_stats()
    step_parity = loss_vs_eager(torch, tmodel, tb, *loss_draws(torch, tmodel, tb, gen), "train",
                                impls=("fast", "fast_pl"))
    parity = step_parity["fast"]
    parity_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    before = [p.detach().clone() for p in tmodel.parameters()]
    kknn.LAUNCHES = kblock.LAUNCHES = kblock.TRAIN_LAUNCHES = kvjp.LAUNCHES = 0
    kvjp.NODE_BWD_LAUNCHES = kvjp.ADJ_LAUNCHES = kvjp.STAGE_W2_LAUNCHES = 0
    kwg.LAUNCHES.update(dict.fromkeys(kwg.LAUNCHES, 0))
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, tb, tgen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, tb, tgen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"knn": kknn.LAUNCHES, "train_fwd": kblock.TRAIN_LAUNCHES, "vjp": kvjp.LAUNCHES,
                "node_bwd": kvjp.NODE_BWD_LAUNCHES, "adj": kvjp.ADJ_LAUNCHES,
                "stage_w2": kvjp.STAGE_W2_LAUNCHES, "weight_grad": dict(kwg.LAUNCHES)}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    m = {k: float(v) for k, v in metrics.items()}
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    if not all(np.isfinite(v) for v in m.values()) or not (m["loss"] > 0 and m["grad_norm"] > 0):
        raise AssertionError(f"train: bad metrics {m}")
    if launches["vjp"] != n_steps or launches["train_fwd"] != n_steps or launches["knn"] != n_steps:
        raise AssertionError(f"train: expected one launch of each kernel per step, {launches}")
    if launches["node_bwd"] != 2 * L * n_steps:
        raise AssertionError(f"train: expected a node_bwd_kernel launch per pass, {launches}")
    if launches["adj"] != 2 * n_steps:
        raise AssertionError(f"train: expected two adjacency builds per step, {launches}")
    if launches["stage_w2"] != n_steps:
        raise AssertionError(f"train: expected one second-layer staging launch per step (all "
                             f"2L passes), {launches}")
    # per step and layer: three edge products in each pass, two node products in each
    if launches["weight_grad"] != {"x2h_edge": 3 * L * n_steps, "h2x_edge": 3 * L * n_steps,
                                   "node": 4 * L * n_steps, "alone": 0}:
        raise AssertionError(f"train: expected ten weight-gradient products per layer and step, "
                             f"{launches['weight_grad']}")
    moved = max(float((p.detach() - b).abs().max()) for p, b in zip(tmodel.parameters(), before))
    if not moved > 0:
        raise AssertionError("train: the parameters did not move")
    ms_step = 1e3 * train_s / TRAIN_STEPS
    # a 10-step fit of one fixed batch with fixed draws must lower its loss
    fit_losses = []
    for _ in range(10):
        state, fm = step(state, batch, None, time_step=t, pos_noise=eps, v_uniform=u)
        fit_losses.append(float(fm["loss"]))
    if not fit_losses[-1] < fit_losses[0]:
        raise AssertionError(f"train: a 10-step fit did not lower the loss {fit_losses}")
    phase("train", shape=f"B={TRAIN_B},N={TRAIN_PROTEIN + MAX_LIGAND},K={K},valid={TRAIN_VALID}",
          steps=TRAIN_STEPS, ms_per_step=ms_step, complexes_per_s=TRAIN_B * 1e3 / ms_step,
          peak_mem_gib=peak_gib, loss=m["loss"], grad_norm=m["grad_norm"], launches=launches,
          fit_first=fit_losses[0], fit_last=fit_losses[-1], parity_loss_rel_err=parity["rel_err"],
          parity_max_grad_err_over_scale=parity["max_grad_err_over_scale"],
          parity_peak_mem_gib=parity_peak_gib)
    train_launches = dict(launches)

    # ---- [train-pl]: the per-layer training path ----
    # the loss and every gradient against eager: the kNN graph at B=4 ([train-loss]'s
    # run), the hybrid graph at B=4, and the B=32 step's batch ([train]'s run)
    knn_parity, pl_parity = loss_parity["fast_pl"], step_parity["fast_pl"]
    ht, heps, hu = loss_draws(torch, hmodel, hbatch, gen)
    hybrid_parity = loss_vs_eager(torch, hmodel, hbatch, ht, heps, hu, "train-pl hybrid",
                                  impls=("fast_pl",))["fast_pl"]
    # the per-layer train step at the [train] shape, beside the whole-block one
    pl_state = create_train_state(tmodel, train_utils.get_optimizer(Config(OPTIMIZER),
                                                                    tmodel.parameters()))
    pl_step = make_train_step(tmodel, pos_noise_std=0.1, time_sampling="importance",
                              impl="fast_pl")
    before = [p.detach().clone() for p in tmodel.parameters()]
    for _ in range(TRAIN_WARMUP):
        pl_state, _ = pl_step(pl_state, tb, tgen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kknn.LAUNCHES = kblock.TRAIN_LAUNCHES = kvjp.LAUNCHES = kvjp.NODE_BWD_LAUNCHES = 0
    kvjp.ADJ_LAUNCHES = kvjp.STAGE_W2_LAUNCHES = 0
    kel.X2H_LAUNCHES = kel.H2X_LAUNCHES = kelv.X2H_BWD_LAUNCHES = kelv.H2X_BWD_LAUNCHES = 0
    kwg.LAUNCHES.update(dict.fromkeys(kwg.LAUNCHES, 0))
    t0 = time.perf_counter()
    for _ in range(TRAIN_PL_STEPS):
        pl_state, pl_metrics = pl_step(pl_state, tb, tgen)
    torch.cuda.synchronize()
    pl_s = time.perf_counter() - t0
    pl_launches = {"knn": kknn.LAUNCHES, "x2h": kel.X2H_LAUNCHES, "h2x": kel.H2X_LAUNCHES,
                   "x2h_bwd": kelv.X2H_BWD_LAUNCHES, "h2x_bwd": kelv.H2X_BWD_LAUNCHES,
                   "block_fwd": kblock.TRAIN_LAUNCHES, "block_vjp": kvjp.LAUNCHES,
                   "node_bwd": kvjp.NODE_BWD_LAUNCHES, "adj": kvjp.ADJ_LAUNCHES,
                   "stage_w2": kvjp.STAGE_W2_LAUNCHES, "weight_grad": dict(kwg.LAUNCHES)}
    pl_peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = TRAIN_PL_STEPS * FLAGSHIP["num_layers"]
    if (any(pl_launches[k] != per_step for k in ("x2h", "h2x", "x2h_bwd", "h2x_bwd"))
            or pl_launches["block_fwd"] or pl_launches["block_vjp"]
            or pl_launches["knn"] != TRAIN_PL_STEPS or pl_launches["node_bwd"] != 2 * per_step
            or pl_launches["adj"] != 2 * per_step or pl_launches["stage_w2"] != 2 * per_step
            or pl_launches["weight_grad"] != {"x2h_edge": 3 * per_step, "h2x_edge": 3 * per_step,
                                              "node": 4 * per_step, "alone": 0}):
        raise AssertionError(f"train-pl: expected each per-layer kernel once per layer and "
                             f"step, its weight-gradient products, and no block kernel, "
                             f"{pl_launches}")
    if not all(np.isfinite(float(v)) for v in pl_metrics.values()):
        raise AssertionError(f"train-pl: bad metrics {pl_metrics}")
    moved = max(float((p.detach() - b).abs().max()) for p, b in zip(tmodel.parameters(), before))
    if not moved > 0:
        raise AssertionError("train-pl: the parameters did not move")
    pl_ms = 1e3 * pl_s / TRAIN_PL_STEPS
    phase("train-pl", knn_loss_rel_err=knn_parity["rel_err"],
          knn_max_grad_err_over_scale=knn_parity["max_grad_err_over_scale"],
          hybrid_shape=f"B={B},N={hbatch.protein_pos.shape[1] + HYBRID_LIGAND},"
                       f"K={hmodel.net.refine_net.num_neighbors()}",
          hybrid_loss_rel_err=hybrid_parity["rel_err"],
          hybrid_max_grad_err_over_scale=hybrid_parity["max_grad_err_over_scale"],
          step_shape=f"B={TRAIN_B},N={TRAIN_PROTEIN + MAX_LIGAND},K={K}",
          step_loss_rel_err=pl_parity["rel_err"],
          step_max_grad_err_over_scale=pl_parity["max_grad_err_over_scale"], steps=TRAIN_PL_STEPS,
          ms_per_step=pl_ms, complexes_per_s=TRAIN_B * 1e3 / pl_ms, peak_mem_gib=pl_peak,
          fast_ms_per_step=ms_step, fast_peak_mem_gib=peak_gib, launches=pl_launches,
          loss=float(pl_metrics["loss"]))

    # ---- [train-cli]: the train CLI's run on a six-entry dataset, reload, sample ----
    root = REPO / "outputs" / "chip_smoke_train"
    cli_dataset(torch, root)
    config = cli_config(root, 4)
    args = train_diffusion.parser().parse_args(
        ["in-code", "--device", "cuda", "--logdir", str(root / "logs"), "--max_protein",
         str(MAX_PROTEIN), "--max_ligand", "40", "--train_report_iter", "1"])
    # the CLI's checkpoint writer, wrapped to keep the params it was handed
    written = {}
    save_checkpoint = train_diffusion.save_checkpoint

    def save_and_keep(path, cfg, net, *rest):
        written[path] = {k: v.detach().clone() for k, v in net.state_dict().items()}
        return save_checkpoint(path, cfg, net, *rest)

    kknn.LAUNCHES = kblock.LAUNCHES = kblock.TRAIN_LAUNCHES = kvjp.LAUNCHES = 0
    train_diffusion.save_checkpoint = save_and_keep
    try:
        res = train_diffusion.run(config, args)
    finally:
        train_diffusion.save_checkpoint = save_checkpoint
    cli_launches = {"train_fwd": kblock.TRAIN_LAUNCHES, "vjp": kvjp.LAUNCHES}
    if (not res["checkpoints"] or sorted(written) != sorted(res["checkpoints"])
            or cli_launches["vjp"] != config.train.max_iters):
        raise AssertionError(f"train-cli: checkpoints {res['checkpoints']}, "
                             f"launches {cli_launches}")
    # every checkpoint reloads equal to the params it was written from
    for ckpt in res["checkpoints"]:
        reloaded = DiffusionModel(Config(FLAGSHIP), feat.feature_dim, NUM_CLASSES, device=dev,
                                  max_protein=MAX_PROTEIN, max_ligand=40)
        reloaded.net.load_state_dict(flax_params_to_state_dict(load_npz_params(ckpt)))
        state_dict = reloaded.net.state_dict()
        if sorted(state_dict) != sorted(written[ckpt]) or not all(
                torch.equal(v, written[ckpt][k]) for k, v in state_dict.items()):
            raise AssertionError(f"train-cli: {ckpt} does not reload to the params it saved")
    ck_iter = int(Path(ckpt).stem.split("_")[-1])
    # the reloaded params give exactly the best validation loss the run logged
    transform = train_diffusion.build_transform(config.data, 1)[0]
    val_set = get_dataset(config.data, transform)[1]["test"]
    val_loader = PaddedLoader(val_set, 4, MAX_PROTEIN, 40, shuffle=False, drop_last=False,
                              device=dev)
    val = train_diffusion.validate(reloaded, make_eval_step(reloaded), val_loader, 1,
                                   logging.getLogger("chip_smoke"), ck_iter)
    if abs(val - res["best_val"]) > 1e-6 * abs(res["best_val"]):
        raise AssertionError(f"train-cli: reloaded val loss {val} != logged {res['best_val']}")
    kknn.LAUNCHES = kblock.LAUNCHES = 0
    sres = sample_diffusion_ligand(
        reloaded, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(4),
        batch_size=B, num_steps=10, max_protein=MAX_PROTEIN, max_ligand=40,
        rng=np.random.default_rng(4), dtype=torch.float32)
    if kknn.LAUNCHES < 10 or kblock.LAUNCHES < 10:
        raise AssertionError("train-cli: sampling from the checkpoint did not launch the kernels")
    if not all(np.isfinite(p).all() for p in sres["pos"]):
        raise AssertionError("train-cli: sampling from the checkpoint gave non-finite positions")
    phase("train-cli", checkpoints=[Path(c).name for c in res["checkpoints"]],
          best_val=res["best_val"], reloaded_val=val,
          reloaded_equal_saved=f"{len(written)}/{len(res['checkpoints'])}",
          launches=cli_launches, sample_launches=kblock.LAUNCHES)

    return {"fwd": {"launches": train_launches["train_fwd"], "max_abs_err": fwd_err,
                    "ms": fwd_ms, "plain_ms": fwd_plain_ms, **fwd_bound},
            "bwd": {"launches": train_launches["vjp"], "max_abs_err": bwd_err, "ms": bwd_ms,
                    "plain_ms": bwd_plain_ms, **bwd_bound, **tprod_entry(tprod)},
            "weight_grad": {cls: {"launches": train_launches["weight_grad"][cls], **fields}
                            for cls, fields in wgrad["classes"].items()},
            "stage_w2": {"launches": train_launches["stage_w2"], **{
                k: stage[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "device_ms", "passes")}},
            "node_bwd": {"launches": train_launches["node_bwd"],
                         "max_abs_err": max(f["max_abs_err"] for f in node_bwd.values()),
                         **{k: node_bwd["x2h"][k]
                            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "dh_mm_ms")},
                         "timed_case": f"x2h, {node_bwd['x2h']['rows']} rows"},
            "adjacency": {"launches": train_launches["adj"],
                          "max_abs_err": max(f["max_abs_err"] for f in adjacency.values()),
                          **{k: adjacency["x2h"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by", "sort_ms")},
                          "timed_case": "x2h pass"},
            "pl_launches": pl_launches, "checkpoint": ckpt}


BF16_F64_BAR = 0.08  # a bf16 backward's median tensor against float64, of its scale: the JAX
# package's bf16 training bar (tests/test_fast_train.py)
REPLAY16_BAR = 1e-2  # the bf16 block backward against replay_block_bwd(bf16=True) (its own
# rounding points in PyTorch, ops/kernels/block_vjp_replay.py), each tensor of its scale
NODE16_BAR = 2e-4  # the bf16 node_bwd_kernel against its plain version on float64 copies (the
# same rounded operands), of each output's scale; ten times that from the unrounded version
WG16_BAR = 1e-4  # the bf16 weight-gradient kernel against float64 of its rounded operands, of s
BF16_TRAIN_STEPS, BF16_TAIL = 100, 20  # [bf16-train]: steps of each precision from one init and
# one set of draws; the mean loss of the last BF16_TAIL below that of the first BF16_TAIL
BF16_LOSS_REL = 0.05  # [bf16-train]: the two tail means agree within this, relative
BF16_STEP_SHARE = 0.25  # [bf16-train]: |dp_bf16 - dp_f32| within this share of a float32
# control's |dp_other_draws - dp_f32| (dp: the parameters' change over the steps)
BF16_LAYER_STEPS = 3  # [bf16-layers-bwd]: fast_bf16 steps of the hybrid model, its main path
BF16_CLI_STEPS = 2  # [bf16-train]: steps of the train CLI with --dtype bf16


def bf16_grad_margins(label, got, want16, want64, replay=None) -> dict:
    """A bf16 backward's margins, each tensor's largest |got - want| over its
    scale (`tensor_errs`; the k biases, zero in exact arithmetic, over the
    largest gradient) against the bf16 plain version `want16`, float64
    `want64` and, given it, `replay` (`replay_block_bwd(bf16=True)`: the
    kernel's own rounding points). Raises unless every tensor lies within
    BF16_BAR of the bf16 plain version, the median tensor within
    BF16_F64_BAR of float64 and the k biases within BF16_BAR; with
    `replay`, every tensor within REPLAY16_BAR of it, and a tensor on which
    the replay itself lies further than BF16_BAR - REPLAY16_BAR from the
    bf16 plain version is held by the replay alone, counted in
    `held_by_replay` with its readings (the kernel forward's checkpoints
    differ from the plain forward's by up to ~1e-3 of scale, and gradients
    formed by cancellation, as the h2x query MLP's, amplify that). Returns
    max, median and the worst tensor of each comparison."""
    vs16, vs64, p64 = (tensor_errs(got, want16), tensor_errs(got, want64),
                       tensor_errs(want16, want64))
    top = max(float(w.abs().max()) for w in want64.values())
    kbias = max(float((got[n].double() - w.double()).abs().max()) / top
                for n, w in want64.items() if n.endswith("k_func.net.3.bias"))

    def summary(errs, bar=None):
        worst = max(errs, key=errs.get)
        out = {"max": errs[worst], "median": float(np.median(list(errs.values()))),
               "worst_tensor": worst}
        if bar is not None:
            out["over_bar"] = sum(e > bar for e in errs.values())
        return out

    out = {"vs_bf16_plain": summary(vs16, BF16_BAR), "vs_float64": summary(vs64, BF16_F64_BAR),
           "plain_vs_float64": summary(p64, BF16_F64_BAR), "k_bias_over_top": kbias,
           "tensors": len(vs16)}
    held = {}
    if replay is not None:
        vsr, r16 = tensor_errs(got, replay), tensor_errs(replay, want16)
        held = {n: {"vs_bf16_plain": vs16[n], "replay_vs_bf16_plain": r16[n],
                    "vs_replay": vsr[n]} for n in vs16 if r16[n] > BF16_BAR - REPLAY16_BAR}
        out.update(vs_replay=summary(vsr), replay_vs_bf16_plain=summary(r16, BF16_BAR),
                   replay_vs_float64=summary(tensor_errs(replay, want64), BF16_F64_BAR),
                   held_by_replay=len(held),
                   held_worst=dict(sorted(held.items(), key=lambda kv: -kv[1]["vs_bf16_plain"])
                                   [:8]))
        if not out["vs_replay"]["max"] < REPLAY16_BAR:
            raise AssertionError(f"{label}: {out['vs_replay']} of scale from the replay of its "
                                 f"rounding points (bar {REPLAY16_BAR})")
    over = {n: e for n, e in vs16.items() if e >= BF16_BAR and n not in held}
    if over or not (out["vs_float64"]["median"] < BF16_F64_BAR and kbias < BF16_BAR):
        raise AssertionError(
            f"{label}: tensors {over} of their scale from the bf16 plain version (bar "
            f"{BF16_BAR}); median tensor {out['vs_float64']['median']} from float64 (bar "
            f"{BF16_F64_BAR}); k biases {kbias} of the largest gradient")
    return out


def unpacked_grads(torch, rn, backward) -> dict:
    """dh0, dx0, de_w and every parameter gradient of the block `rn` from a
    backward on its packed stacks: `backward(x2h, h2x)` (the float32 stacks,
    detached) returns (dh0, dx0, de_w, x2h grads, h2x grads), as
    `block_bwd_cuda` and `replay_block_bwd` do; the packing's backward
    carries the stacks' gradients to the parameters."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels.block_vjp import FIELDS

    packs = kblock.pack_pass_params(rn)
    with torch.no_grad():
        dh0, dx0, dew, *packed = backward(*[{f: t.detach() for f, t in p.items()}
                                            for p in packs])
    rn.zero_grad(set_to_none=True)
    torch.autograd.backward([p[f] for p in packs for f in FIELDS],
                            [g[f] for g in packed for f in FIELDS])
    grads = {n: p.grad.detach().clone() for n, p in rn.named_parameters() if p.grad is not None}
    grads.update(dh0=dh0, dx0=dx0, de_w=dew)
    return grads


def replay_grads(torch, rn, hck, xck, nbh, mask_ligand, e_w, gh, gx, n_ligand=MAX_LIGAND,
                 n_heads=NHEADS) -> dict:
    """`unpacked_grads` of `replay_block_bwd(bf16=True)` (the bf16 backward
    kernel's algorithm and rounding points in PyTorch, on the device of its
    inputs) on the checkpoints hck, xck for the output cotangents (gh, gx)."""
    from targetdiff_tpu_torch.ops.kernels.block_vjp_replay import replay_block_bwd

    return unpacked_grads(torch, rn, lambda x2h, h2x: replay_block_bwd(
        x2h, h2x, hck, xck, nbh, mask_ligand, e_w, n_ligand, gh, gx, n_heads, bf16=True))


def bf16_train_block_phase(torch, dev, rn, h, x, nbh, mask_ligand, node_mask) -> dict:
    """[bf16-train-block]: the bf16 train-mode forward (td_block_train_fwd_bf16)
    and the bf16 block backward (td_block_bwd_bf16) at [train-block]'s shape
    and inputs (kNN B=4, N=608, K=32, L=9, flagship width): the float32
    checkpoints against the bf16 plain train-mode forward and float64 at
    BF16_BAR; dh0, dx0, de_w and every parameter gradient of the two
    kernels against autograd of the bf16 plain block (BF16_BAR), of the
    float64 block (BF16_F64_BAR) and against the replay of the backward's
    rounding points on its own checkpoints (`replay_grads`, REPLAY16_BAR;
    `bf16_grad_margins`), every one float32; the backward kernel alone on
    the bf16 plain forward's checkpoints against autograd of the bf16 plain
    block, every tensor within BF16_BAR (its `max_abs_err`: dh0, dx0, de_w);
    two runs bitwise equal; a float32 pack
    refused. Timed beside the plain versions, the bounds at the bf16 rate and
    the float32 kernels in the same call, with the backward's kernels' device
    ms (`bwd_device_ms`) and `edge_bwd_info`. Returns the kernels' fields."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp

    bf16 = torch.bfloat16
    e_w, _, gh, gx = train_block_cotangents(torch, dev, rn, x, nbh, h)
    rn64 = copy.deepcopy(rn).double()
    with torch.no_grad():
        x2h32, h2x32 = kblock.pack_pass_params(rn)
        x2h, h2x = kblock.cast_pack(x2h32, bf16), kblock.cast_pack(h2x32, bf16)
        runs = [kblock.block_denoiser_train_cuda(rn, h, x, nbh, mask_ligand, e_w, MAX_LIGAND,
                                                 x2h, h2x, bf16) for _ in range(2)]
        want16 = kblock.block_denoiser_train_plain(rn, h, x, nbh, mask_ligand, e_w, bf16)
        want64 = kblock.block_denoiser_train_plain(rn64, h.double(), x.double(), nbh,
                                                   mask_ligand, e_w.double())
        try:
            kblock.block_denoiser_train_cuda(rn, h, x, nbh, mask_ligand, e_w, MAX_LIGAND, x2h32,
                                             h2x32, bf16)
            raise AssertionError("bf16-train-block: the bf16 entry took a float32 pack")
        except ValueError:
            pass
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("bf16-train-block: two forward calls differ")
    hck, xck = runs[0]
    L = hck.shape[0] - 1
    rows = node_mask[None].expand(L, -1, -1)
    lig = mask_ligand[None].expand(L, -1, -1)
    ck = {"hck": bf16_margins("bf16-train-block hck", hck[1:][rows], want16[0][1:][rows],
                              want64[0][1:][rows]),
          "xck": bf16_margins("bf16-train-block xck", xck[1:][lig], want16[1][1:][lig],
                              want64[1][1:][lig])}
    fwd_err = max(float((hck - want16[0])[:, node_mask].abs().max()),
                  float((xck - want16[1])[:, node_mask].abs().max()))
    ck16 = want16  # the bf16 plain forward's checkpoints, for the backward alone
    del want64

    def grads(trainable, net=rn, dtype=bf16, cast=lambda t: t):
        g = block_grads(torch, net, *[cast(t) for t in (h, x)], nbh, mask_ligand,
                        *[cast(t) for t in (e_w, gh, gx)], trainable, dtype)
        return {n: t.detach().clone() for n, t in g.items()}

    g_k, g_again = grads(True), grads(True)
    g16 = grads(False)
    g64 = grads(False, rn64, None, lambda t: t.double())
    g_rep = replay_grads(torch, rn, hck, xck, nbh, mask_ligand, e_w, gh, gx)
    torch.cuda.synchronize()
    if sorted(g_k) != sorted(g16) or not all(torch.equal(g_k[n], g_again[n]) for n in g_k):
        raise AssertionError("bf16-train-block: other parameters reached, or two backward "
                             "runs differ")
    if not all(g.dtype == torch.float32 and bool(g.isfinite().all()) for g in g_k.values()):
        raise AssertionError("bf16-train-block: a gradient is not finite float32")
    bwd = bf16_grad_margins("bf16-train-block backward", g_k, g16, g64, g_rep)
    del g_again, g64, g_rep
    # the backward kernel alone, on the bf16 plain forward's checkpoints: every
    # tensor within BF16_BAR of autograd of the bf16 plain block
    g_alone = unpacked_grads(torch, rn, lambda x2h, h2x: kvjp.block_bwd_cuda(
        *ck16, nbh.idx, nbh.mask, mask_ligand, e_w, MAX_LIGAND, kblock.cast_pack(x2h, bf16),
        kblock.cast_pack(h2x, bf16), gh, gx, bf16))
    alone = tensor_errs(g_alone, g16)
    worst = max(alone, key=alone.get)
    bwd["alone_vs_bf16_plain"] = {"max": alone[worst], "median": float(np.median(
        list(alone.values()))), "worst_tensor": worst}
    if not alone[worst] < BF16_BAR:
        raise AssertionError(f"bf16-train-block: the backward alone {bwd['alone_vs_bf16_plain']}"
                             f" of scale from the bf16 plain block (bar {BF16_BAR})")
    bwd_err = max(float((g_alone[n] - g16[n]).abs().max()) for n in ("dh0", "dx0", "de_w"))
    del g_alone, ck16
    with torch.no_grad():
        try:
            kvjp.block_bwd_cuda(hck, xck, nbh.idx, nbh.mask, mask_ligand, e_w, MAX_LIGAND,
                                x2h32, h2x32, gh, gx, bf16)
            raise AssertionError("bf16-train-block: the bf16 backward took a float32 pack")
        except ValueError:
            pass
        hck32, xck32 = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mask_ligand, e_w,
                                                        MAX_LIGAND, x2h32, h2x32)
        fwd = {"": (lambda: kblock.block_denoiser_train_cuda(
                   rn, h, x, nbh, mask_ligand, e_w, MAX_LIGAND, x2h, h2x, bf16)),
               "float32_": (lambda: kblock.block_denoiser_train_cuda(
                   rn, h, x, nbh, mask_ligand, e_w, MAX_LIGAND, x2h32, h2x32)),
               "plain_": (lambda: kblock.block_denoiser_train_plain(rn, h, x, nbh, mask_ligand,
                                                                   e_w, bf16))}
        bwd_fns = {"": (lambda: kvjp.block_bwd_cuda(hck, xck, nbh.idx, nbh.mask, mask_ligand,
                                                     e_w, MAX_LIGAND, x2h, h2x, gh, gx, bf16)),
                   "float32_": (lambda: kvjp.block_bwd_cuda(
                       hck32, xck32, nbh.idx, nbh.mask, mask_ligand, e_w, MAX_LIGAND, x2h32,
                       h2x32, gh, gx))}
        times = {f"fwd_{k}ms": cuda_ms(torch, fn, reps=10) for k, fn in fwd.items()}
        times.update({f"bwd_{k}ms": cuda_ms(torch, fn, reps=10) for k, fn in bwd_fns.items()})
        times.update({f"bwd_{k}device_ms": device_ms(torch, fn, calls=5)
                      for k, fn in bwd_fns.items()})
    leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
    outs = rn.block_forward(leaves[0], leaves[1], nbh, mask_ligand, e_w=leaves[2], dtype=bf16)
    wrt = leaves + [p for n, p in rn.named_parameters() if n in g16]
    times["bwd_plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        outs, wrt, (gh, gx), retain_graph=True), reps=10)
    del outs, wrt, leaves
    pieces = {**bwd_device_ms(torch, "bf16", bwd_fns[""], calls=5),
              **bwd_device_ms(torch, "float32", bwd_fns["float32_"], calls=5)}
    work = layer_work(nbh, mask_ligand, node_mask)
    fwd_bound = bound(L * block_flops(*work), nbytes(h, x, nbh.idx, nbh.mask, mask_ligand,
                                                     e_w, x2h, h2x, hck, xck), PEAK_BF16_FLOPS)
    bwd_bound = bound(L * block_flops(*work, bwd=True),
                      nbytes(hck, xck, nbh.idx, nbh.mask, mask_ligand, e_w, x2h, h2x, gh, gx)
                      + nbytes(h, x, e_w, x2h32, h2x32), PEAK_BF16_FLOPS)
    info = {sub: kvjp.edge_bwd_info(K, sub == "h2x", bf16) for sub in ("x2h", "h2x")}
    phase("bf16-train-block", shape=f"B={B},N={h.shape[1]},K={K},L={L}", bar=BF16_BAR,
          f64_bar=BF16_F64_BAR, checkpoints=ck, backward=bwd, **times, **pieces,
          fwd_bound_ms=fwd_bound["bound_ms"], bwd_bound_ms=bwd_bound["bound_ms"],
          fwd_bound_by=fwd_bound["bound_by"], bwd_bound_by=bwd_bound["bound_by"],
          edge_bwd_kernel=info)
    del rn64
    torch.cuda.empty_cache()
    return {"fwd": dict(max_abs_err=fwd_err, ms=times["fwd_ms"], plain_ms=times["fwd_plain_ms"],
                        float32_ms=times["fwd_float32_ms"], **fwd_bound,
                        max_over_scale=max(v["vs_bf16_plain"]["max"] for v in ck.values()),
                        max_over_scale_vs_float64=max(v["vs_float64"]["max"]
                                                      for v in ck.values())),
            "bwd": dict(max_abs_err=bwd_err, ms=times["bwd_ms"], plain_ms=times["bwd_plain_ms"],
                        float32_ms=times["bwd_float32_ms"],
                        device_ms=times["bwd_device_ms"],
                        float32_device_ms=times["bwd_float32_device_ms"], **bwd_bound,
                        max_over_scale=bwd["vs_bf16_plain"]["max"],
                        median_over_scale=bwd["vs_bf16_plain"]["median"],
                        max_over_scale_vs_float64=bwd["vs_float64"]["max"],
                        median_over_scale_vs_float64=bwd["vs_float64"]["median"], **pieces)}


def bf16_layers_bwd_phase(torch, dev, pocket, feat_dim) -> dict:
    """[bf16-layers-bwd]: the bf16 per-layer backwards (td_{x2h,h2x}_layer_bwd_bf16
    through the trainables at dtype=torch.bfloat16) at [layers]' hybrid shape
    (the example pocket with 64 ligand slots: B=4, N=640, K=95) and inputs:
    dh, dx, de_w and layer 0's parameter gradients against autograd of the
    bf16 plain sub-layer (BF16_BAR) and of its float64 copy (BF16_F64_BAR),
    two runs bitwise equal; each timed beside the plain version, the float32
    kernel and its bound at the bf16 rate, with its kernels' device ms. Then
    its main path: BF16_LAYER_STEPS `fast_bf16` train steps of the hybrid
    model (K = 95 takes the per-layer route), every count set to 0 just
    before and read just after: the bf16 per-layer forwards and backwards
    once per layer and step, no float32 training kernel. Returns both
    backwards' fields."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kelv
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg
    from targetdiff_tpu_torch.trainer import create_train_state, make_train_step
    from targetdiff_tpu_torch.utils import train as train_utils

    bf16 = torch.bfloat16
    hmodel, hbatch, hh, hx, hnode, hmlig, hnbh = hybrid_setup(torch, dev, pocket, feat_dim)
    net = hmodel.net.refine_net
    layer = net.base_block[0]
    net64 = copy.deepcopy(net).double()
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        e_w = net.edge_weights(hx, hnbh)[..., 0]
        h_mid = kel.x2h_layer_plain(layer, hh, hx, hnbh, hmlig, e_w, bf16)
        p32 = dict(zip(("x2h", "h2x"), kel.pack_layer_params(layer)))
        p16 = {k: kblock.cast_pack(v, bf16) for k, v in p32.items()}
    cot = {"x2h": torch.randn(hh.shape, generator=gen, device=dev) * hnode[..., None],
           "h2x": torch.randn(hx.shape, generator=gen, device=dev)}
    nodes, lig_nodes, edges, lig_edges = layer_work(hnbh, hmlig, hnode)
    fields = {}
    for sub in ("x2h", "h2x"):
        hin = hh if sub == "x2h" else h_mid
        args = (hin, hx, hnbh, hmlig, e_w, cot[sub], HYBRID_LIGAND)
        got, again, want16 = (layer_grads(torch, net, sub, tr, *args, dtype=bf16)
                              for tr in (True, True, False))
        want64 = layer_grads(torch, net64, sub, False,
                             *[a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                               for a in args])
        torch.cuda.synchronize()
        if sorted(got) != sorted(want16) or not all(torch.equal(got[n], again[n]) for n in got):
            raise AssertionError(f"bf16-layers-bwd {sub}: other parameters reached, or two "
                                 "runs differ")
        if not all(g.dtype == torch.float32 and bool(g.isfinite().all()) for g in got.values()):
            raise AssertionError(f"bf16-layers-bwd {sub}: a gradient is not finite float32")
        m = bf16_grad_margins(f"bf16-layers-bwd {sub}", got, want16, want64)
        err = max(float((got[n] - want16[n]).abs().max()) for n in ("dh", "dx", "de_w"))
        del again, want64
        bwd_fn = kelv.x2h_layer_bwd_cuda if sub == "x2h" else kelv.h2x_layer_bwd_cuda
        extra = () if sub == "x2h" else (HYBRID_LIGAND,)
        runs = {"": lambda: bwd_fn(hin, hx, hnbh, hmlig, e_w, *extra, p16[sub], cot[sub], bf16),
                "float32_": lambda: bwd_fn(hin, hx, hnbh, hmlig, e_w, *extra, p32[sub],
                                           cot[sub])}
        with torch.no_grad():
            f = {f"{k}ms": cuda_ms(torch, fn, reps=10) for k, fn in runs.items()}
            f.update({f"{k}device_ms": device_ms(torch, fn, calls=5) for k, fn in runs.items()})
        f.update(bwd_device_ms(torch, "bf16", runs[""], calls=5))
        leaves = [t.clone().requires_grad_() for t in (hin, hx, e_w)]
        plain = kel.x2h_layer_plain if sub == "x2h" else kel.h2x_layer_plain
        o = plain(layer, leaves[0], leaves[1], hnbh, hmlig, leaves[2], bf16)
        wrt = leaves + [p for n, p in layer.named_parameters() if f"{sub}_layers" in n]
        f["plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(o, wrt, cot[sub],
                                                                   retain_graph=True), reps=10)
        del o, wrt, leaves
        e = edges if sub == "x2h" else lig_edges
        flops = node_flops(sub, nodes, lig_nodes, bwd=True) + e * FLOP_EDGE_BWD[sub]
        f.update(bound(flops, nbytes(hin, hx, hnbh.idx, hnbh.mask, hmlig, e_w, p16[sub],
                                     cot[sub], hin, hx, e_w, p32[sub]), PEAK_BF16_FLOPS))
        fields[f"{sub}_bwd"] = dict(max_abs_err=err, margins=m, **f,
                                    max_over_scale=m["vs_bf16_plain"]["max"],
                                    median_over_scale=m["vs_bf16_plain"]["median"],
                                    max_over_scale_vs_float64=m["vs_float64"]["max"])
    del net64
    # the main path: fast_bf16 train steps of the hybrid model
    state = create_train_state(hmodel, train_utils.get_optimizer(Config(OPTIMIZER),
                                                                  hmodel.parameters()))
    step = make_train_step(hmodel, pos_noise_std=0.1, impl="fast_bf16")
    reset_train_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # K = 95: the per-layer route's warning
        for _ in range(BF16_LAYER_STEPS):
            state, metrics = step(state, hbatch, gen)
    torch.cuda.synchronize()
    launches = train_counts()
    L = FLAGSHIP["num_layers"]
    per = BF16_LAYER_STEPS * L
    want = {"knn": 0, "x2h_bf16": per, "h2x_bf16": per, "x2h_bwd_bf16": per,
            "h2x_bwd_bf16": per, "node_bwd_bf16": 2 * per, "adj": 2 * per,
            "stage_w2_bf16": 2 * per,  # one staging launch a per-layer backward
            "node_bf16": 4 * per}  # both passes' forwards and the backward's recomputes
    if any(launches[k] != v for k, v in want.items()) or any(
            launches[k] for k in FLOAT32_TRAIN_COUNTS) or launches["weight_grad_bf16"] != {
            "x2h_edge": 3 * per, "h2x_edge": 3 * per, "node": 4 * per, "alone": 0}:
        raise AssertionError(f"bf16-layers-bwd: expected the bf16 per-layer kernels once per "
                             f"layer and step and no float32 training kernel, {launches}")
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"bf16-layers-bwd: bad metrics {metrics}")
    phase("bf16-layers-bwd", shape=f"B={B},N={hh.shape[1]},K={hnbh.idx.shape[-1]}",
          bar=BF16_BAR, f64_bar=BF16_F64_BAR, live_edges_x2h=edges, live_edges_h2x=lig_edges,
          **fields, steps=BF16_LAYER_STEPS, launches=launches, loss=float(metrics["loss"]))
    fields["launches"] = launches
    return fields


# the training kernels' launch counts: float32 ones, which the bf16 path never
# launches, and the bf16 ones
FLOAT32_TRAIN_COUNTS = ("train_fwd", "vjp", "node_bwd", "x2h", "h2x", "x2h_bwd", "h2x_bwd",
                        "node", "stage_w2")


_NODE_SINCE = [0, 0]  # the library's node launch counts at the last reset_train_counts


def reset_train_counts() -> None:
    """Every launch count of the kernel wrappers to 0 (each module's
    `*LAUNCHES`, float32 and bf16; the node kernel's, counted in C, from
    here on)."""
    import importlib

    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock

    _NODE_SINCE[:] = kblock.node_launch_counts()
    for name in ("block_denoiser", "block_vjp", "edge_layer", "edge_layer_vjp", "knn",
                 "weight_grad"):
        mod = importlib.import_module(f"targetdiff_tpu_torch.ops.kernels.{name}")
        for attr, count in list(vars(mod).items()):
            if attr.endswith("LAUNCHES"):
                if isinstance(count, dict):
                    count.update(dict.fromkeys(count, 0))
                else:
                    setattr(mod, attr, 0)


def train_counts() -> dict:
    """The counts `reset_train_counts` zeroes."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kelv
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    return {"knn": kknn.LAUNCHES, "train_fwd": kblock.TRAIN_LAUNCHES,
            "train_fwd_bf16": kblock.BF16_TRAIN_LAUNCHES, "vjp": kvjp.LAUNCHES,
            "vjp_bf16": kvjp.BF16_LAUNCHES, "node_bwd": kvjp.NODE_BWD_LAUNCHES,
            "node_bwd_bf16": kvjp.BF16_NODE_BWD_LAUNCHES, "adj": kvjp.ADJ_LAUNCHES,
            "stage_w2": kvjp.STAGE_W2_LAUNCHES, "stage_w2_bf16": kvjp.BF16_STAGE_W2_LAUNCHES,
            "x2h": kel.X2H_LAUNCHES, "h2x": kel.H2X_LAUNCHES, "x2h_bf16": kel.BF16_X2H_LAUNCHES,
            "h2x_bf16": kel.BF16_H2X_LAUNCHES, "x2h_bwd": kelv.X2H_BWD_LAUNCHES,
            "h2x_bwd": kelv.H2X_BWD_LAUNCHES, "x2h_bwd_bf16": kelv.BF16_X2H_BWD_LAUNCHES,
            "h2x_bwd_bf16": kelv.BF16_H2X_BWD_LAUNCHES, "weight_grad": dict(kwg.LAUNCHES),
            "weight_grad_bf16": dict(kwg.BF16_LAUNCHES),
            **dict(zip(("node", "node_bf16"), np.subtract(kblock.node_launch_counts(),
                                                          _NODE_SINCE).tolist()))}


def cli_dataset(torch, root: Path) -> None:
    """The train CLI's six-entry dataset under root (the example pocket, six
    copies of the example ligand under their own file names: [likelihood-cli]'s
    pK map keys on them; a 4 / 2 split)."""
    shutil.rmtree(root, ignore_errors=True)
    (root / "raw").mkdir(parents=True)
    shutil.copyfile(POCKET_PDB, root / "raw" / "pocket.pdb")
    for i in range(6):
        shutil.copyfile(LIGAND_SDF, root / "raw" / f"ligand_{i}.sdf")
    with open(root / "raw" / "index.pkl", "wb") as f:
        pickle.dump([("pocket.pdb", f"ligand_{i}.sdf", 0.5) for i in range(6)], f)
    torch.save({"train": [0, 1, 2, 3], "test": [4, 5]}, root / "split.pt")


def cli_config(root: Path, max_iters: int, model=FLAGSHIP):
    """The train CLI's config on `cli_dataset`'s root for `model` (the
    flagship by default)."""
    from targetdiff_tpu_torch.config import Config

    return Config(
        data=dict(name="pl", path=str(root / "raw"), split=str(root / "split.pt"),
                  transform=dict(ligand_atom_mode="add_aromatic", random_rot=False)),
        model=model,
        train=dict(seed=1, batch_size=4, max_iters=max_iters, val_freq=2, pos_noise_std=0.1,
                   max_grad_norm=8.0, optimizer={k: v for k, v in OPTIMIZER.items()
                                                 if k != "max_grad_norm"},
                   scheduler=dict(type="plateau", factor=0.6, patience=10, min_lr=1e-6)))


def bf16_train_phase(torch, dev, pocket, feat_dim) -> dict:
    """[bf16-train]: the `fast_bf16` train step at [train]'s shape (B=32 synthetic
    complexes, N=416, K=32) beside `fast`. Two flagship models from one seed
    take BF16_TRAIN_STEPS steps each (symmetric timesteps, one generator seed:
    the same draws), bf16 first as its main path, every count set to 0 just
    before and read just after: the bf16 train-mode forward and backward once
    a step, their node and weight-gradient kernels per pass, no float32
    training kernel. Both losses stay finite and fall (the mean of the last
    BF16_TAIL steps below that of the first), the two tail means agree within
    BF16_LOSS_REL, and the parameters' change over the steps lies within
    BF16_STEP_SHARE of a control's distance from float32's (a third model,
    float32 on other draws). Then host ms per step of
    each, in turns (bf16, float32, float32, bf16), and the device time by
    kernel (`kernel_split`) with the backward's pieces (`bwd_device_ms`).
    Then BF16_CLI_STEPS steps of the train CLI with --dtype bf16: the bf16
    kernels train, the checkpoint is float32 and loads into the sampler,
    which samples 10 steps at its default bf16. Returns the kernels' launches
    and the step's fields."""
    from targetdiff_tpu_torch.cli import train_diffusion
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand
    from targetdiff_tpu_torch.trainer import create_train_state, make_train_step
    from targetdiff_tpu_torch.utils import train as train_utils
    from targetdiff_tpu_torch.utils.checkpoint import load_checkpoint

    tb = train_batch(dev)
    runs, init = {}, None
    # the control: float32 from the same init on other draws
    for impl, seed in (("fast_bf16", 12), ("fast", 12), ("control", 13)):
        torch.manual_seed(1)
        m = DiffusionModel(Config(FLAGSHIP), feat_dim, NUM_CLASSES, device=dev,
                           max_protein=TRAIN_PROTEIN, max_ligand=MAX_LIGAND)
        p0 = {n: p.detach().clone() for n, p in m.net.named_parameters()}
        init = p0 if init is None else init
        if not all(torch.equal(init[n], p) for n, p in p0.items()):
            raise AssertionError("bf16-train: the runs start from other parameters")
        state = create_train_state(m, train_utils.get_optimizer(Config(OPTIMIZER),
                                                                 m.parameters()))
        step = make_train_step(m, pos_noise_std=0.1, impl="fast" if impl == "control" else impl)
        gen = torch.Generator(device=dev).manual_seed(seed)
        losses = []
        torch.cuda.synchronize()
        reset_train_counts()
        t0 = time.perf_counter()
        for _ in range(BF16_TRAIN_STEPS):
            state, metrics = step(state, tb, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        runs[impl] = dict(model=m, state=state, step=step, gen=gen,
                          seconds=time.perf_counter() - t0, launches=train_counts(),
                          losses=[float(v) for v in losses],
                          # the parameters' change, the k biases (zero gradients in exact
                          # arithmetic, moved by Adam on rounding noise) left out
                          delta=torch.cat([(p.detach() - init[n]).flatten()
                                           for n, p in m.net.named_parameters()
                                           if not n.endswith("k_func.net.3.bias")]))
    control = runs.pop("control")
    launches = runs["fast_bf16"]["launches"]
    L, n = FLAGSHIP["num_layers"], BF16_TRAIN_STEPS
    want = {"knn": n, "train_fwd_bf16": n, "vjp_bf16": n, "node_bwd_bf16": 2 * L * n,
            "adj": 2 * n, "stage_w2_bf16": n,  # one staging launch a backward
            "node_bf16": 4 * L * n}  # forward and recompute, both passes
    if any(launches[k] != v for k, v in want.items()) or any(
            launches[k] for k in FLOAT32_TRAIN_COUNTS) or launches["weight_grad_bf16"] != {
            "x2h_edge": 3 * L * n, "h2x_edge": 3 * L * n, "node": 4 * L * n, "alone": 0} or any(
            launches["weight_grad"].values()):
        raise AssertionError(f"bf16-train: expected the bf16 training kernels once per step "
                             f"(and pass) and no float32 training kernel, {launches}")
    heads = {impl: float(np.mean(r["losses"][:BF16_TAIL])) for impl, r in runs.items()}
    tails = {impl: float(np.mean(r["losses"][-BF16_TAIL:])) for impl, r in runs.items()}
    rel = abs(tails["fast_bf16"] - tails["fast"]) / abs(tails["fast"])
    step_rel = np.abs(np.subtract(runs["fast_bf16"]["losses"], runs["fast"]["losses"])) / np.abs(
        runs["fast"]["losses"])
    d32 = runs["fast"]["delta"]
    moved = {"bf16": float((runs["fast_bf16"]["delta"] - d32).norm() / d32.norm()),
             "control": float((control["delta"] - d32).norm() / d32.norm())}
    del control
    if (not all(np.isfinite(r["losses"]).all() for r in runs.values()) or not rel < BF16_LOSS_REL
            or not all(tails[k] < heads[k] for k in runs)
            or not moved["bf16"] < BF16_STEP_SHARE * moved["control"]):
        raise AssertionError(
            f"bf16-train: mean loss of the first and the last {BF16_TAIL} steps {heads} {tails} "
            f"(bar {BF16_LOSS_REL} relative), or a loss not finite; the parameters' change "
            f"{moved} from float32's (bar {BF16_STEP_SHARE} of the control's)")
    # host ms per step, in turns; device time by kernel
    ms = {impl: [] for impl in runs}
    for impl in ("fast_bf16", "fast", "fast", "fast_bf16"):
        r = runs[impl]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            r["state"], _ = r["step"](r["state"], tb, r["gen"])
        torch.cuda.synchronize()
        ms[impl].append(1e3 * (time.perf_counter() - t0) / 10)
    split, pieces = {}, {}
    for impl, r in runs.items():
        def one_step(r=r):
            r["state"], _ = r["step"](r["state"], tb, r["gen"])

        split[impl] = kernel_split(torch, one_step, calls=3, top=8)
        pieces.update(bwd_device_ms(torch, impl, one_step, calls=3))
    step_fields = {"bf16_ms_per_step": float(np.mean(ms["fast_bf16"])),
                   "float32_ms_per_step": float(np.mean(ms["fast"])),
                   "bf16_device_ms_per_step": split["fast_bf16"]["device_ms"],
                   "float32_device_ms_per_step": split["fast"]["device_ms"]}
    phase("bf16-train", shape=f"B={TRAIN_B},N={TRAIN_PROTEIN + MAX_LIGAND},K={K}",
          steps=BF16_TRAIN_STEPS, launches=launches,
          first_loss={k: r["losses"][0] for k, r in runs.items()}, head_mean_loss=heads,
          tail_mean_loss=tails, tail_rel=rel, bar=BF16_LOSS_REL,
          param_change_vs_float32=moved, param_change_bar=BF16_STEP_SHARE,
          step_rel_max=float(step_rel.max()), step_rel_median=float(np.median(step_rel)),
          step_rel_last=float(step_rel[-1]),
          ms_per_step_in_turns=ms, **step_fields, kernel_split=split, **pieces,
          run_seconds={k: r["seconds"] for k, r in runs.items()})
    del runs
    torch.cuda.empty_cache()

    # the train CLI with --dtype bf16
    root = REPO / "outputs" / "chip_smoke_train_bf16"
    cli_dataset(torch, root)
    config = cli_config(root, BF16_CLI_STEPS)
    args = train_diffusion.parser().parse_args(
        ["in-code", "--device", "cuda", "--logdir", str(root / "logs"), "--max_protein",
         str(MAX_PROTEIN), "--max_ligand", "40", "--train_report_iter", "1", "--dtype", "bf16"])
    reset_train_counts()
    res = train_diffusion.run(config, args)
    cli_launches = train_counts()
    # training: the bf16 forward and backward once a step; validation runs the
    # float32 forward (make_eval_step stays float32) and no backward
    if (cli_launches["train_fwd_bf16"] != BF16_CLI_STEPS
            or cli_launches["vjp_bf16"] != BF16_CLI_STEPS or cli_launches["vjp"]
            or not res["checkpoints"]):
        raise AssertionError(f"bf16 train-cli: launches {cli_launches}, checkpoints "
                             f"{res['checkpoints']}")
    ckpt = res["checkpoints"][-1]
    with np.load(ckpt) as z:
        dtypes = sorted({str(z[k].dtype) for k in z.files if z[k].dtype.kind == "f"})
    if dtypes != ["float32"]:
        raise AssertionError(f"bf16 train-cli: checkpoint arrays of {dtypes}")
    sampler = DiffusionModel(Config(FLAGSHIP), feat_dim, NUM_CLASSES, device=dev,
                             max_protein=MAX_PROTEIN, max_ligand=40)
    sampler.net.load_state_dict(load_checkpoint(ckpt, device=dev)["state_dict"])
    kblock.BF16_LAUNCHES = 0
    sres = sample_diffusion_ligand(
        sampler, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(4),
        batch_size=B, num_steps=10, max_protein=MAX_PROTEIN, max_ligand=40,
        rng=np.random.default_rng(4))
    if kblock.BF16_LAUNCHES != 10 or not all(np.isfinite(p).all() for p in sres["pos"]):
        raise AssertionError(f"bf16 train-cli: sampling from the checkpoint launched "
                             f"{kblock.BF16_LAUNCHES} bf16 blocks, or gave non-finite positions")
    phase("bf16-train-cli", steps=BF16_CLI_STEPS, checkpoint=Path(ckpt).name,
          checkpoint_dtypes=dtypes, launches={k: v for k, v in cli_launches.items()
                                              if not isinstance(v, dict) and v},
          best_val=res["best_val"], sample_launches_bf16=kblock.BF16_LAUNCHES)
    return {"launches": launches, "step": step_fields}


def bf16_train_phases(torch, dev, rn, h, x, nbh, mask_ligand, node_mask, pocket, feat_dim):
    """[bf16-train-block] (with its weight-grad and node-bwd parts),
    [bf16-layers-bwd], [bf16-train] and [bf16-train-cli]: the bf16 training
    slice. Returns the kernels' JSON entries."""
    block = bf16_train_block_phase(torch, dev, rn, h, x, nbh, mask_ligand, node_mask)
    wgrad = weight_grad_phase(torch, dev, torch.bfloat16)
    phase("bf16-train-block weight-grad", bar_over_s=WG16_BAR,
          worst_err_over_s=max(f["max_err_over_s"] for f in wgrad["products"].values()),
          products=wgrad["products"])
    node = node_bwd_phase(torch, dev, torch.bfloat16)
    phase("bf16-train-block node-bwd", bar_over_scale=NODE16_BAR, **node)
    tprod = tprod_phase(torch, dev, torch.bfloat16)
    phase("bf16-train-block tprod", bar_over_rss=TPROD_BAR, **tprod)
    stage = stage_w2_phase(torch, dev, torch.bfloat16)
    phase("bf16-train-block stage-w2", **stage)
    layers = bf16_layers_bwd_phase(torch, dev, pocket, feat_dim)
    train = bf16_train_phase(torch, dev, pocket, feat_dim)
    launches, pl = train["launches"], layers["launches"]
    no_library = {"library_ms": None}  # no single PyTorch call computes these functions
    entries = [
        ("block_denoiser_train_bf16", "targetdiff_tpu_torch/csrc/block_denoiser.cu",
         "targetdiff_tpu/ops/pallas/block_denoiser.py:154", launches["train_fwd_bf16"],
         block["fwd"], no_library),
        ("block_vjp_bf16", "targetdiff_tpu_torch/csrc/block_vjp.cu",
         "targetdiff_tpu/ops/pallas/block_vjp.py:113", launches["vjp_bf16"], block["bwd"],
         {**no_library, **tprod_entry(tprod)}),
        *[(f"block_vjp.weight_grad_bf16_{cls}", "targetdiff_tpu_torch/csrc/weight_grad.cuh",
           "targetdiff_tpu/ops/pallas/block_vjp.py:113", launches["weight_grad_bf16"][cls], f,
           {}) for cls, f in wgrad["classes"].items()],
        ("block_vjp.stage_w2_bf16", "targetdiff_tpu_torch/csrc/pass_bwd.cuh",
         "targetdiff_tpu/ops/pallas/block_vjp.py:113", launches["stage_w2_bf16"], stage,
         no_library),
        ("block_vjp.node_bwd_bf16", "targetdiff_tpu_torch/csrc/node_bwd.cuh",
         "targetdiff_tpu/ops/pallas/edge_layer_vjp.py:153", launches["node_bwd_bf16"],
         dict(node["x2h"], max_abs_err=max(f["max_abs_err"] for f in node.values()),
              timed_case=f"x2h, {node['x2h']['rows']} rows"), no_library),
        ("x2h_layer_bwd_bf16", "targetdiff_tpu_torch/csrc/edge_layer_vjp.cu",
         "targetdiff_tpu/ops/pallas/edge_layer_vjp.py:231", pl["x2h_bwd_bf16"],
         layers["x2h_bwd"], no_library),
        ("h2x_layer_bwd_bf16", "targetdiff_tpu_torch/csrc/edge_layer_vjp.cu",
         "targetdiff_tpu/ops/pallas/edge_layer_vjp.py:351", pl["h2x_bwd_bf16"],
         layers["h2x_bwd"], no_library),
    ]
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "float32_ms",
            "device_ms", "float32_device_ms", "weight_grad_device_ms", "reduce_device_ms",
            "passes", "max_over_scale", "median_over_scale",
            "max_over_scale_vs_float64", "dh_mm_ms", "timed_case")
    return [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": n, **{k: v for k, v in f.items() if k in keep}, **extra}
            for name, source, replaces, n, f, extra in entries]


def measure(torch, argv) -> int:
    """The `profile`, `duel`, `margins`, `cone` and `host` modes (module docstring)."""
    bf16 = argv[0] == "profile" and argv[-1] == "bf16"
    if bf16:
        argv = argv[:-1]
    what, arg = argv[0], (argv[1:] or [None])[0]
    sized = what == "profile" and arg in ("hybrid", "knn") and len(argv) == 3
    if what not in ("profile", "duel", "margins", "cone", "host") or len(argv) > (
            3 if sized or what == "host" else 2) or (what == "cone" and len(argv) > 1) or (
            what == "host" and len(argv) == 3 and not argv[2].isdigit()) or (
            what == "profile" and arg not in (None, "hybrid", "knn", "block", "train")) or (
            sized and not argv[2].isdigit()) or (bf16 and arg not in (None, "hybrid", "knn")):
        raise SystemExit("usage: chip_smoke.py [profile [hybrid|knn|block|train] [BATCH] "
                         "[bf16] | duel [CHECKOUT] | margins [CHECKOUT] | cone | "
                         "host [CHECKOUT] [STEPS]]")
    batch = int(argv[2]) if sized else B
    checkout = Path(arg).resolve() if what in ("duel", "margins") and arg else REPO
    sys.path.insert(0, str(checkout))
    from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    feat = FeaturizeProteinAtom()
    data = pdb_to_pocket_data(str(POCKET_PDB), feat)
    pocket = {"protein_pos": data["protein_pos"], "protein_feat": data["protein_atom_feature"]}

    # the sampling precision: float32 unless `profile ... bf16` asks for bf16;
    # a checkout from before the bf16 path samples in float32 and takes no dtype
    precision = {}
    if "dtype" in inspect.signature(sample_diffusion_ligand).parameters:
        precision["dtype"] = torch.bfloat16 if bf16 else torch.float32

    def setup(cutoff, n=None, dtype=None):
        """A flagship model of `cutoff` with seeded weights, and sample(steps,
        seed): ms per step of `batch` molecules (n, if given; dtype, if given,
        as their precision) for the pocket over `steps` DDPM steps, host clock
        ending in a synchronise."""
        n_ligand = HYBRID_LIGAND if cutoff == "hybrid" else MAX_LIGAND
        torch.manual_seed(0)
        model = DiffusionModel(Config(dict(FLAGSHIP, cutoff_mode=cutoff)), feat.feature_dim,
                               NUM_CLASSES, device=dev, max_protein=MAX_PROTEIN,
                               max_ligand=n_ligand)

        def sample(steps, seed):
            t0 = time.perf_counter()
            sample_diffusion_ligand(model, pocket, num_samples=n or batch,
                                    generator=torch.Generator(device=dev).manual_seed(seed),
                                    batch_size=n or batch, num_steps=steps,
                                    max_protein=MAX_PROTEIN, max_ligand=n_ligand,
                                    rng=np.random.default_rng(seed),
                                    **(dict(precision, dtype=dtype) if dtype else precision))
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / steps

        return model, sample

    if what == "duel":
        out = duel(torch, dev, setup, pocket, feat.feature_dim)
    elif what == "cone":
        out = cone_phase(torch, dev, setup("knn")[0], pocket, feat.feature_dim)
    elif what == "host":
        steps = int(argv[2]) if len(argv) == 3 else 1000
        model, sample16 = setup("knn", B, torch.bfloat16)
        sample16(3, 1)  # warm up
        variants = {"cone": sample16, "cone_off": without_cone(sample16)}
        if arg:  # the parent's port beside this one, in this process
            variants["parent"] = port_sampler(torch, dev, import_port(Path(arg).resolve()),
                                              pocket)
            variants["parent"](3, 1)
        out = {"batch": B, "steps": steps, "bf16_ms_per_step": sample16(steps, 1),
               **forward_host_ms(torch, dev, model, pocket, feat.feature_dim),
               **host_rounds(torch, variants, steps)}
    elif what == "margins":
        out = margins(torch, dev, pocket, feat.feature_dim, check=False)
    elif arg == "block":
        out = profile_block(torch, dev, setup("knn")[0], pocket, feat.feature_dim)
    elif arg == "train":
        out = profile_train(torch, dev, feat.feature_dim)
    else:
        out = profile(torch, setup(arg or "hybrid")[1], arg or "hybrid", batch)
        out["dtype"] = str(precision.get("dtype", torch.float32))
    print(json.dumps({"card": card_name(), "checkout": str(checkout), what: out}), flush=True)
    return 0


def forward_host_ms(torch, dev, model, pocket, feat_dim, calls=200, rounds=5) -> dict:
    """ms per call of the bf16 kNN B=4 forward (`fast_apply`, as sampling
    calls it) with every row (need_full_h=True, the default) and, where the
    checkout has the option, on the dependency cone, in turns within this
    process: `rounds` rounds of `calls` calls each, a synchronisation after
    each round; the median round of each. At B=4 the forward is host-bound,
    so this is its host cost."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock

    batch = pocket_batch(torch, dev, pocket, feat_dim, MAX_LIGAND, LIGAND_SIZES, 0)
    packed = kblock.pack_block_params(model.net.refine_net, torch.bfloat16)
    variants = {"every_row": {}}
    if "need_full_h" in inspect.signature(model.fast_apply).parameters:
        variants["cone"] = {"need_full_h": False}
    rounds_ms = {k: [] for k in variants}
    with torch.no_grad():
        for _ in range(rounds):
            for name, kw in variants.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, packed=packed,
                                     dtype=torch.bfloat16, **kw)
                torch.cuda.synchronize()
                rounds_ms[name].append(1e3 * (time.perf_counter() - t0) / calls)
    return {**{f"forward_{k}_ms": float(np.median(v)) for k, v in rounds_ms.items()},
            "forward_rounds_ms": rounds_ms}


def without_cone(sample):
    """`sample` with this checkout's `block_cone` replaced by one that
    returns no cone: every forward computes every row."""
    from targetdiff_tpu_torch.models import fast_forward as ff

    def run(steps, seed):
        real = ff.block_cone
        ff.block_cone = lambda *a, **k: None
        try:
            return sample(steps, seed)
        finally:
            ff.block_cone = real

    return run


def import_port(checkout: Path, alias: str = "parent_port"):
    """The port of another checkout imported as package `alias`, beside this
    checkout's (its relative imports resolve within it; it builds its own
    kernels from its own sources)."""
    import importlib
    import importlib.util

    pkg = checkout / "targetdiff_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    root = importlib.util.module_from_spec(spec)
    sys.modules[alias] = root
    spec.loader.exec_module(root)
    return {name: importlib.import_module(f"{alias}.{name}")
            for name in ("config", "models.score_model", "sampling")}


def port_sampler(torch, dev, mods, pocket):
    """sample(steps, seed) of the port in `mods` (import_port): ms per step of
    B kNN molecules for the pocket in bf16 (host clock ending in a
    synchronise), the flagship with seed-0 weights, as `setup` builds it."""
    torch.manual_seed(0)
    feat_dim = pocket["protein_feat"].shape[-1]
    model = mods["models.score_model"].DiffusionModel(
        mods["config"].Config(dict(FLAGSHIP, cutoff_mode="knn")), feat_dim, NUM_CLASSES,
        device=dev, max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND)

    def sample(steps, seed):
        t0 = time.perf_counter()
        mods["sampling"].sample_diffusion_ligand(
            model, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(seed),
            batch_size=B, num_steps=steps, max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND,
            rng=np.random.default_rng(seed), dtype=torch.bfloat16)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    return sample


def host_rounds(torch, variants, steps, rounds=10) -> dict:
    """ms per DDPM step (host clock) of each of `variants` (name: sample(steps,
    seed)) in `rounds` rounds within this process, the order rotating each
    round; the median, each round's times, the rounds each variant was
    faster than each other, the garbage collector's full collections in
    each run, and 20 steps of each under torch.profiler (`traced_steps`:
    host operators' self time a step) with the operators whose time a step
    differs most from the first variant's."""
    import gc

    names = list(variants)
    runs = {n: [] for n in names}
    full = {n: [] for n in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            gen2 = gc.get_stats()[2]["collections"]
            runs[name].append(variants[name](steps, 1))
            full[name].append(gc.get_stats()[2]["collections"] - gen2)
    traced = {n: traced_steps(torch, variants[n]) for n in names}
    faster = {f"{a}_faster_than_{b}": sum(x < y for x, y in zip(runs[a], runs[b]))
              for a in names for b in names if a != b}
    base = dict((op, ms) for op, ms, _ in traced[names[0]]["host_ops"])
    diffs = {}
    for n in names[1:]:
        other = dict((op, ms) for op, ms, _ in traced[n]["host_ops"])
        d = {op: base.get(op, 0.0) - other.get(op, 0.0) for op in set(base) | set(other)}
        diffs[f"{names[0]}_minus_{n}_ms"] = sorted(d.items(), key=lambda kv: -abs(kv[1]))[:10]
    for t in traced.values():
        del t["host_ops"]
    return {**{f"step_{n}_ms": float(np.median(v)) for n, v in runs.items()}, "rounds": rounds,
            "step_rounds_ms": runs, "step_rounds_full_gc": full, **faster,
            "step_traced": traced, "host_op_differences": diffs}


def traced_steps(torch, sample, steps=20) -> dict:
    """`steps` sampling steps under torch.profiler: device ms a step, and the
    host operators with the most self time a step (ms, calls a step)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_ms = sample(steps, 1)
    ops = sorted(((ev.key, ev.self_cpu_time_total / 1e3 / steps, ev.count / steps)
                  for ev in prof.key_averages() if ev.self_cpu_time_total > 0),
                 key=lambda o: -o[1])
    return {"host_ms": host_ms,
            "device_ms": sum(k["ms"] for k in device_times(prof, steps).values()),
            "host_self_ms": sum(o[1] for o in ops), "top_host_ops": ops[:12], "host_ops": ops}


def device_times(prof, calls) -> dict:
    """Device milliseconds and launches of each kernel per call, largest
    first (device events only: host ranges repeat their kernels' time, and
    so do the device-side copies of annotated host ranges, such as
    `Optimizer.step#Adam.step`)."""
    from torch.autograd import DeviceType

    kernels = {ev.key: {"ms": ev.self_device_time_total / 1e3 / calls,
                        "launches": ev.count / calls}
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
               and not getattr(ev, "is_user_annotation", False)}
    return dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"]))


def profile(torch, sample, cutoff, batch, per_launch=()) -> dict:
    """Device time by kernel over 10 traced sampling steps, beside the host
    time of the same 10 steps run just before without the profiler; for
    each name piece in `per_launch`, the device ms of each launch of its
    kernels within a step, in launch order (`per_launch_ms`)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    steps = 10
    sample(3, 2)  # warm up
    host_ms = sample(steps, 2)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_host_ms = sample(steps, 2)
    kernels = device_times(prof, steps)
    device_ms = sum(k["ms"] for k in kernels.values())
    return {"cutoff": cutoff, "batch": batch, "steps": steps, "host_ms_per_step": host_ms,
            "traced_host_ms_per_step": traced_host_ms, "device_ms_per_step": device_ms,
            "idle_share_estimate": 1 - device_ms / host_ms,
            "kernels_per_step": dict(list(kernels.items())[:25]),
            "cone_kernel_ms_per_step": sum(k["ms"] for name, k in kernels.items()
                                           if "cone_kernel" in name),
            **{f"{piece}_per_launch_ms": per_launch_ms(prof, piece, steps)
               for piece in per_launch}}


# kernels of the `fast` train step by name: (row, pieces of the profiler's
# kernel names), matched in this order; every other kernel is eager glue
TRAIN_KERNELS = (
    ("edge_bwd_kernel<x2h>", ("edge_bwd_kernel<false",)),
    ("edge_bwd_kernel<h2x>", ("edge_bwd_kernel<true",)),
    ("stage_w2_kernel", ("stage_w2_kernel",)),
    ("stage_rbf_kernel", ("stage_rbf_kernel",)),
    ("weight_grad_kernel", ("weight_grad_kernel", "atb_kernel")),
    ("reduce_kernel", ("(anonymous namespace)::reduce_kernel",)),  # not at::native's
    ("colsum_kernel", ("colsum_kernel",)),
    ("gather_kernel", ("gather_kernel",)),
    ("node_bwd_kernel", ("node_bwd_kernel",)),
    # build_adjacency's three kernels; "adj_" also matches the single
    # adj_kernel of earlier trees, which `profile train` runs on too
    ("adjacency", ("adj_",)),
    ("node_kernel", ("node_kernel",)),
    ("x2h_edge_kernel", ("x2h_edge_kernel",)),
    ("h2x_edge_kernel", ("h2x_edge_kernel",)),
    ("ew_kernel", ("ew_kernel",)),
    ("knn_kernel", ("knn_kernel",)),
)
PROFILE_TRAIN_STEPS = 5


def profile_train(torch, dev, feat_dim) -> dict:
    """Device time by kernel of PROFILE_TRAIN_STEPS `fast` B=32 train steps
    ([train]'s batch and model) traced by torch.profiler after TRAIN_WARMUP
    steps, beside the host time of as many steps run just before without
    the profiler. node_kernel counts the forward's launches and the
    backward's recompute together; `glue` is every other kernel (eager
    PyTorch), its largest listed in `glue_top`."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    tb, tmodel, state, step, tgen = train_setup(torch, dev, feat_dim)
    steps = PROFILE_TRAIN_STEPS
    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, tb, tgen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, tb, tgen)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, tb, tgen)
        torch.cuda.synchronize()
    rows = {label: {"ms": 0.0, "launches": 0.0} for label, _ in TRAIN_KERNELS}
    rows["glue"] = {"ms": 0.0, "launches": 0.0}
    glue = {}
    for name, k in device_times(prof, steps).items():
        label = next((lab for lab, pieces in TRAIN_KERNELS if any(p in name for p in pieces)),
                     "glue")
        rows[label]["ms"] += k["ms"]
        rows[label]["launches"] += k["launches"]
        if label == "glue":
            glue[name] = k
    device_ms = sum(r["ms"] for r in rows.values())
    return {"batch": TRAIN_B, "steps": steps, "host_ms_per_step": host_ms,
            "device_ms_per_step": device_ms, "idle_share_estimate": 1 - device_ms / host_ms,
            "kernels_per_step": rows, "glue_top": dict(list(glue.items())[:12]),
            "bwd_kernels": bwd_kernel_rows(torch, tb, tmodel, rows)}


def reduce_shapes(products, colsum_m, colsum_q) -> list:
    """The partials reduce_kernel sums in one pass of the float32 backward,
    as (S, n): S partials of n floats for each weight-gradient product (M, P,
    Q), one a cluster of its row chunks (csrc/weight_grad.cuh wg_plan, read
    from the library: `weight_grad.plan`), and for the column sums of the
    row buffer [colsum_m, colsum_q] (csrc/pass_bwd.cuh colsum:
    `colsum_partials`)."""
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    return [(kwg.plan(m, p, q)["partials"], p * q) for m, p, q in products] + [
        (kwg.colsum_partials(colsum_m, colsum_q), colsum_q)]


def reduce_bytes(products, colsum_m, colsum_q) -> float:
    """Bytes reduce_kernel moves in one pass: its partials read once and its
    outputs written (`reduce_shapes`)."""
    return sum((s + 1) * n * 4 for s, n in reduce_shapes(products, colsum_m, colsum_q))


def bwd_kernel_rows(torch, tb, tmodel, rows) -> dict:
    """The backwards' own kernels per launch at the B=32 step's shapes:
    device ms (from the traced steps' `rows`), launches per step, the bound
    (`bound`, from this batch's kNN graph: live edges, the h2x pass's ligand
    rows and their sources; each input read once, each output written once)
    and, where one PyTorch call computes the same function, its device time:
    index_add_ of the dz rows by source for gather_kernel's d nj,
    torch.sum(rowbuf, 0) for colsum_kernel and its reduce_kernel launch,
    torch.sum(partials, 0) of each reduce_kernel launch's partials; for
    the adjacency (per build: build_adjacency's three kernels), the stable
    torch.sort by source of adjacency_plain (not the same function).
    node_bwd_kernel, gather_kernel, colsum_kernel, the adjacency,
    stage_rbf_kernel and reduce_kernel (six a pass) run per pass: their
    bound and library time are the mean of an x2h and an h2x pass;
    stage_w2_kernel runs once a backward, for its 2L passes. Also
    `weight_grad_and_reduce`: the products' and their reductions' device ms
    a step together, and reduce_kernel's partials (from the library's plan,
    by pass, the column sums' last) and its device ms a launch alone on them
    (`weight_grad.reduce_partials`: no wait for a product)."""
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    with torch.no_grad():
        _, x, node_mask, _ = tmodel.net.embed(*tb)
        nbh = G.knn_graph(x, node_mask, K)
    nb, n = x.shape[:2]
    L = FLAGSHIP["num_layers"]
    bn, row0, fe, f4 = nb * n, n - MAX_LIGAND, 4 * RK + 4, 4
    lig_rows, src, _ = h2x_rows(torch, nbh, row0)
    live = {"x2h": int(nbh.mask.sum()), "h2x": int(nbh.mask[:, row0:].sum())}
    dst = {"x2h": bn, "h2x": lig_rows}
    adj_edges = {"x2h": bn * K, "h2x": nb * MAX_LIGAND * K}
    width = {"x2h": HW, "h2x": NHEADS}
    weights = f4 * (2 * HW * HW + 2 * HW * HW + 4 * RK * 2 * HW + 4 * 2 * HW + 4 * 2 * HW)
    per_pass = {}
    for sub, v in width.items():
        slots = dst[sub] * K
        # destination rows: ni, q, x, and dh (x2h) or d x (h2x); source rows:
        # nj and x; slots: idx, mask, e_w. Written: the per-edge rows (A, dKV,
        # dZ, F, d rel), d e_w, the row buffer's partials and d x.
        reads = (dst[sub] * (3 * HW + 3 + (HW if sub == "x2h" else 3))
                 + (bn if sub == "x2h" else src) * (2 * HW + 3)) * f4 + slots * 13 + weights
        writes = (slots * (2 * HW + HW + v + 2 * HW + fe + 3 + 1)
                  + dst[sub] * (8 * HW + v + 3)) * f4
        row_w = 13 * HW + v  # run_pass's row buffer
        reduce_args = ([(adj_edges[sub], HW, HW), (adj_edges[sub], HW, v),
                        (adj_edges[sub], fe, 2 * HW), (bn, HW, 5 * HW), (bn, HW, HW)], bn, row_w)
        per_pass[sub] = {
            "edge": bound(live[sub] * FLOP_EDGE_KERNEL_BWD[sub], reads + writes),
            "node": bound(bn * np.array([12 * HW * HW, 10 * HW]),
                          f4 * (bn * 12 * HW + 6 * HW * HW)),
            "gather": bound((0, live[sub] * (2 * HW + 3)),
                            f4 * (live[sub] * (2 * HW + 4) + bn * (2 * HW + 4))),
            "colsum": bound((0, bn * row_w), f4 * (bn * row_w + row_w)),
            # the pass's idx and nmask read, off and the live edges' list entries written
            "adj": bound((0, 0), adj_edges[sub] * 9 + live[sub] * f4 + nb * (n + 1) * f4),
            # one launch a backward: every pass's w2k [H, H] and w2v [H, V] read,
            # its fragments and transposes written (`stage_w2_bytes`), both kinds
            # of pass L times each
            "stage_w2": bound((0, 0), L * sum(stage_w2_bytes(V) for V in width.values())),
            # w_rbf [4, R, 2H] read, its TF32 (hi, lo) fragments (two layouts) written
            "stage_rbf": bound((0, 0), f4 * 4 * RK * 2 * HW + 16 * 2 * (2 * HW // 8)
                               * (2 * RK // 8) * 32),
            # per launch: five products' and the column sums' partials (six a pass)
            "reduce": bound((0, 0), reduce_bytes(*reduce_args) / 6),
        }
        # the library calls on operands of these shapes
        offs = (torch.arange(nb, device=x.device) * n)[:, None, None]
        srcs = (nbh.idx + offs)[:, row0:] if sub == "h2x" else nbh.idx + offs
        srcs = srcs[nbh.mask[:, row0:] if sub == "h2x" else nbh.mask]
        dz = torch.randn((live[sub], 2 * HW), device=x.device)
        dnj = torch.empty((bn, 2 * HW), device=x.device)
        rowbuf = torch.randn((bn, row_w), device=x.device)
        per_pass[sub]["gather_library_ms"] = device_ms(
            torch, lambda: dnj.zero_().index_add_(0, srcs, dz))
        per_pass[sub]["colsum_library_ms"] = device_ms(torch, lambda: torch.sum(rowbuf, 0))
        # reduce_kernel's function: torch.sum of each of its six launches'
        # partials [S, n] over their first dimension, the mean a launch
        shapes = reduce_shapes(*reduce_args)
        per_pass[sub]["reduce_partials"] = [S for S, _ in shapes]
        partials = [torch.randn((S, n_), device=x.device) for S, n_ in shapes]
        per_pass[sub]["reduce_library_ms"] = float(np.mean(
            [device_ms(torch, lambda p=p: torch.sum(p, 0)) for p in partials])) if shapes else None
        # reduce_kernel alone on the same partials (no product before it to
        # wait for), the mean a launch
        per_pass[sub]["reduce_alone_ms"] = float(np.mean(
            [kernel_device_ms(torch, lambda p=p: kwg.reduce_partials(p), "::reduce_kernel",
                              calls=20) for p in partials])) if shapes else None
        del partials
        first = row0 if sub == "h2x" else 0
        key = torch.where(nbh.mask[:, first:].reshape(nb, -1), nbh.idx[:, first:].reshape(nb, -1),
                          n)
        per_pass[sub]["adj_library_ms"] = device_ms(
            torch, lambda: torch.sort(key, dim=-1, stable=True))
        del dz, dnj, rowbuf

    def mean(key, field):
        return float(np.mean([per_pass[sub][key][field] if field else per_pass[sub][key]
                              for sub in width]))

    out = {}
    for name, key, sub, library in (
            ("edge_bwd_kernel<x2h>", "edge", "x2h", None),
            ("edge_bwd_kernel<h2x>", "edge", "h2x", None),
            ("node_bwd_kernel", "node", None, None),
            ("gather_kernel", "gather", None, "gather_library_ms"),
            ("colsum_kernel", "colsum", None, "colsum_library_ms"),
            ("adjacency", "adj", None, "adj_library_ms"),
            ("stage_w2_kernel", "stage_w2", None, None),
            ("stage_rbf_kernel", "stage_rbf", None, None),
            ("reduce_kernel", "reduce", None, "reduce_library_ms")):
        r = rows[name]
        b = per_pass[sub][key] if sub else {"bound_ms": mean(key, "bound_ms"),
                                            "bound_by": per_pass["x2h"][key]["bound_by"]}
        # the adjacency per build (two a step), whatever its kernels
        launches = 2 if name == "adjacency" else r["launches"]
        out[name] = {"ms_per_launch": r["ms"] / max(launches, 1), "launches_per_step": launches,
                     "kernel_launches_per_step": r["launches"], **b,
                     "library_ms": (mean(library, None) if library and all(
                         per_pass[sub_][library] is not None for sub_ in width) else None)}
    # the products and their reductions together (under programmatic
    # dependent launch the profiler counts the reduction's wait as its time)
    out["reduce_kernel"]["partials_x2h_h2x"] = [per_pass[sub]["reduce_partials"] for sub in width]
    out["reduce_kernel"]["alone_ms"] = (mean("reduce_alone_ms", None) if all(
        per_pass[sub]["reduce_alone_ms"] is not None for sub in width) else None)
    out["weight_grad_and_reduce"] = {
        "ms_per_step": rows["weight_grad_kernel"]["ms"] + rows["reduce_kernel"]["ms"],
        "weight_grad_ms_per_step": rows["weight_grad_kernel"]["ms"],
        "reduce_ms_per_step": rows["reduce_kernel"]["ms"],
        "launches_per_step": rows["weight_grad_kernel"]["launches"] + rows["reduce_kernel"][
            "launches"]}
    out["live_edges"], out["h2x_rows"], out["h2x_sources"] = live, lig_rows, src
    return out


def stage_w2_bytes(V: int, elem: int = 4) -> int:
    """Bytes stage_w2_kernel moves for one pass of value width V: w2k [H, H]
    and w2v [H, V] of `elem` bytes read once; float32 (elem 4): their fp16
    (hi, lo) fragments (512 bytes a column) and float32 transposes written,
    bf16 (elem 2): their 8-byte fragments and their transposes' (256 bytes a
    column each), 3 elem H (H + V) in both."""
    return 3 * elem * HW * (HW + V)


def profile_block(torch, dev, model, pocket, feat_dim) -> list:
    """The inference block and the train-mode block forward on the same
    inputs (B=4, N=608, K=32, L=9), in turns (inference, train, train,
    inference): CUDA-event ms per call, the wrapper's host ms per call (host
    clock from the call to its return, the device idle before it) and, over
    10 traced calls each, device time by kernel."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock

    rn = model.net.refine_net
    out = []
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(
            *pocket_batch(torch, dev, pocket, feat_dim, MAX_LIGAND, LIGAND_SIZES, 0))
        nbh = G.knn_graph(x, node_mask, K)
        packed = kblock.pack_block_params(rn)
        e_w = rn.edge_weights(x, nbh)[..., 0]
        x2h, h2x = kblock.pack_pass_params(rn)
        runs = {"inference": lambda: kblock.block_denoiser_cuda(rn, h, x, nbh, mlig, MAX_LIGAND,
                                                                packed),
                "train_fwd": lambda: kblock.block_denoiser_train_cuda(
                    rn, h, x, nbh, mlig, e_w, MAX_LIGAND, x2h, h2x)}
        for name in ("inference", "train_fwd", "train_fwd", "inference"):
            ms = cuda_ms(torch, runs[name])
            host = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[name]()
                host.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    runs[name]()
                torch.cuda.synchronize()
            kernels = device_times(prof, 10)
            out.append({"run": name, "ms": ms, "host_ms": float(np.median(host)),
                        "device_ms": sum(k["ms"] for k in kernels.values()),
                        "kernels_per_call": kernels})
    return out


# kernels of the backwards timed by `bwd_device_ms`: (key, pieces of the
# profiler's kernel names)
BWD_PIECES = (("wgrad", ("weight_grad_kernel", "atb_kernel")),
              ("reduce", ("(anonymous namespace)::reduce_kernel",)),
              # the products and their reductions together: under programmatic
              # dependent launch the profiler counts a reduction's wait as its time
              ("wgrad_reduce", ("weight_grad_kernel", "atb_kernel",
                                "(anonymous namespace)::reduce_kernel")),
              ("stage_w2", ("stage_w2_kernel",)),
              ("edge_bwd_x2h", ("edge_bwd_kernel<false",)),
              ("edge_bwd_h2x", ("edge_bwd_kernel<true",)), ("node_bwd", ("node_bwd_kernel",)),
              ("adj", ("adj_",)))


def bwd_device_ms(torch, label, fn, calls=10) -> dict:
    """Device ms per call of fn spent in the weight-gradient products
    (weight_grad_kernel, or atb_kernel before it), in reduce_kernel (which
    also sums the bias and LayerNorm column sums), in both together, in
    stage_w2_kernel, in the x2h and h2x edge_bwd_kernel, in node_bwd_kernel
    and in the inverse adjacency's kernels (adj_*, or adj_kernel before
    them), over `calls` traced calls after one warm-up call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = device_times(prof, calls)
    return {f"{key}_{label}_device_ms": sum(v["ms"] for k, v in times.items()
                                            if any(pc in k for pc in pieces))
            for key, pieces in BWD_PIECES}


def kernel_device_ms(torch, fn, piece, calls=10) -> float:
    """Device ms per call of fn in the kernels whose name holds `piece`, over
    `calls` traced calls after one warm-up call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(v["ms"] for k, v in device_times(prof, calls).items() if piece in k)


def cone_duel(torch, model, batch, label) -> dict:
    """The sampler's dependency cone of `batch`'s kNN graph (the flagship's L
    layers, MAX_LIGAND ligand rows), where the checkout has it: a digest of
    its Cone (hop, order, counts), cone_kernel's device ms and launches per
    call (torch.profiler) and CUDA-event ms per call."""
    import importlib.util

    if importlib.util.find_spec("targetdiff_tpu_torch.ops.kernels.cone") is None:
        return {}
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import cone as kcone

    L = FLAGSHIP["num_layers"]
    with torch.no_grad():
        _, x, node_mask, _ = model.net.embed(*batch)
        nbh = G.knn_graph(x, node_mask, K)

    def call():
        return kcone.cone_cuda(nbh.idx, nbh.mask, MAX_LIGAND, L)

    return {f"cone_{label}_digest": digest(torch, *call()),
            f"cone_{label}_device_ms": kernel_device_ms(torch, call, "cone_kernel", calls=20),
            f"cone_{label}_launches_per_call": launches_per_call(torch, call, "cone_kernel"),
            f"cone_{label}_ms": cuda_ms(torch, call)}


def duel(torch, dev, setup, pocket, feat_dim) -> dict:
    """CUDA-event times of the whole-block kernels, and ew_kernel's device
    time in the inference block at B=4 and B=100; CUDA-event and device
    times of the node launch (every row, and as the h2x pass launches it) and
    of the x2h and h2x edge launches alone at the kNN shape; CUDA-event times
    of one td_x2h_layer and one td_h2x_layer call at the hybrid shape and the
    device time of the edge kernel and of node_kernel in those calls
    (torch.profiler, 10 calls: the calls themselves are host-bound once the
    kernels are fast); the device time of the weight-gradient products and
    of reduce_kernel, the x2h and h2x edge_bwd_kernel and node_bwd_kernel in
    one block backward (kNN shape) and in one per-layer x2h and one h2x backward
    (hybrid shape), and those backwards' CUDA-event times; 50 kNN and 50
    hybrid sampling steps (host clock); the B=32 `fast` train step (host
    clock, 10 steps after 3), the device time per step of the same kernels
    over 3 more traced steps, and the `fast_pl` step on the same batch
    (host clock, 10 steps after 3). Digests (`digest`) of the float32
    kernels' outputs on those inputs: kNN graphs, the inference block, its
    edge weights, the train-mode checkpoints, the launches alone, the
    per-layer forwards and the block backward. The bf16 kernels (`bf16_*`):
    the whole block at the kNN shape (CUDA events, device time), the x2h
    and h2x edge launches and the node launch (both passes:
    `bf16_node_duel`, `bf16_h2x_duel`) alone at kNN B=4 and B=100 and the
    per-layer x2h and h2x at the hybrid shape (their edge kernel's and
    node_kernel's device time), each with a digest of its output; digests of
    the sampler's forward's ligand outputs (`fast_apply(need_full_h=False)`
    where the checkout has it: the dependency cone) at kNN B=4 and B=100 in
    both precisions and of `fetch_embedding` (every output); the dependency
    cone alone at kNN B=4 and B=100 (`cone_duel`: a digest of its Cone,
    cone_kernel's device ms); 1000 kNN B=4
    sampling steps in bf16 (host clock); 10 kNN
    B=100 sampling steps in bf16 and in float32 (`profile`: host and device
    ms per step, node_kernel's, the x2h and h2x edge kernels' and
    cone_kernel's device ms, the x2h edge and node launches one by one) and the B=32 `fast_bf16`,
    `fast` and `fast_pl` steps (`step_fields`: host ms over 10 steps after 3;
    device ms, node_kernel's, edge_bwd_kernel's, the weight-gradient
    products' and reductions' and stage_w2_kernel's over 3); the quality
    gate's float32 `fast` step at its own padding."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kelv
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.trainer import create_train_state, make_train_step
    from targetdiff_tpu_torch.utils import train as train_utils

    model, sample = setup("knn")
    rn = model.net.refine_net
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(
            *pocket_batch(torch, dev, pocket, feat_dim, MAX_LIGAND, [MAX_LIGAND] * B, 0))
        nbh = G.knn_graph(x, node_mask, K)
        packed = kblock.pack_block_params(rn)
        out["block_ms"] = cuda_ms(torch, lambda: kblock.block_denoiser_cuda(
            rn, h, x, nbh, mlig, MAX_LIGAND, packed))
        # ew_kernel's device time in the block call, at B=4 and at the
        # bench's batch of 100 (the example pocket 100 times)
        out["ew_knn_device_ms"] = kernel_device_ms(torch, lambda: kblock.block_denoiser_cuda(
            rn, h, x, nbh, mlig, MAX_LIGAND, packed), "ew_kernel")
        h100, x100, mask100, mlig100 = model.net.embed(*pocket_batch(
            torch, dev, pocket, feat_dim, MAX_LIGAND, LIGAND_SIZES * 25, 0))
        nbh100 = G.knn_graph(x100, mask100, K)
        out["ew_knn_b100_device_ms"] = kernel_device_ms(
            torch, lambda: kblock.block_denoiser_cuda(rn, h100, x100, nbh100, mlig100, MAX_LIGAND,
                                                      packed), "ew_kernel", calls=3)
        # the bf16 x2h edge launch alone at B=100 (layer 0, the bf16 pack)
        bf16 = torch.bfloat16
        bpacked = kblock.pack_block_params(rn, bf16)
        bpx = {k: v[:1] for k, v in bpacked.x2h.items()}
        xl16 = pass_launcher(torch, kblock, h100, x100, nbh100, mlig100,
                             rn.edge_weights(x100, nbh100, bf16)[..., 0], bpx, MAX_LIGAND,
                             bf16=True)
        xl16.node()
        out["bf16_x2h_edge_b100_ms"] = cuda_ms(torch, xl16.x2h)
        out["bf16_x2h_edge_b100_device_ms"] = device_ms(torch, xl16.x2h, calls=10)
        out["bf16_x2h_edge_b100_digest"] = digest(torch, xl16.out)
        bph = {k: v[:1] for k, v in bpacked.h2x.items()}
        out.update(bf16_node_duel(torch, kblock, xl16, pass_launcher(
            torch, kblock, h100, x100, nbh100, mlig100, xl16.tensors[0].ew, bph, MAX_LIGAND,
            bf16=True), "b100"))
        # the bf16 h2x edge launch alone at B=100 (td_block_h2x_bf16 in every tree)
        out.update(bf16_h2x_duel(torch, kblock, pass_launcher(
            torch, kblock, h100, x100, nbh100, mlig100, xl16.tensors[0].ew, bph, MAX_LIGAND,
            bf16=True), "b100"))
        del xl16
        # knn_kernel's device time at B=4, B=100 and the train step's shape,
        # and a digest of its outputs there
        knn_out = []
        for label, (xk, mk) in (("b4", (x, node_mask)), ("b100", (x100, mask100)),
                                ("train", train_positions(torch, dev))):
            out[f"knn_{label}_device_ms"] = kernel_device_ms(
                torch, lambda: kknn.knn_graph_cuda(xk, mk, K), "knn_", calls=20)
            knn_out.extend(kknn.knn_graph_cuda(xk, mk, K))
        out["knn_digest"] = digest(torch, *knn_out)
        del h100, x100, mask100, mlig100, nbh100
        e_w = rn.edge_weights(x, nbh)[..., 0]
        x2h, h2x = kblock.pack_pass_params(rn)
        out["train_fwd_ms"] = cuda_ms(torch, lambda: kblock.block_denoiser_train_cuda(
            rn, h, x, nbh, mlig, e_w, MAX_LIGAND, x2h, h2x), reps=10)
        hck, xck = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, MAX_LIGAND, x2h,
                                                    h2x)
        gh = torch.randn(h.shape, generator=gen, device=dev)
        gx = torch.randn(x.shape, generator=gen, device=dev)
        out["block_bwd_ms"] = cuda_ms(torch, lambda: kvjp.block_bwd_cuda(
            hck, xck, nbh.idx, nbh.mask, mlig, e_w, MAX_LIGAND, x2h, h2x, gh, gx), reps=10)
        out.update(bwd_device_ms(torch, "block_bwd", lambda: kvjp.block_bwd_cuda(
            hck, xck, nbh.idx, nbh.mask, mlig, e_w, MAX_LIGAND, x2h, h2x, gh, gx)))
        out["block_bwd_digest"] = digest(torch, *kvjp.block_bwd_cuda(
            hck, xck, nbh.idx, nbh.mask, mlig, e_w, MAX_LIGAND, x2h, h2x, gh, gx))
        # the float32 forwards' outputs: the inference block, its edge
        # weights and the train-mode checkpoints (bitwise across trees that
        # keep the float32 kernels)
        out["block_digest"] = digest(torch, *kblock.block_denoiser_cuda(
            rn, h, x, nbh, mlig, MAX_LIGAND, packed))
        out["ew_digest"] = digest(torch, kblock.edge_weights_cuda(x, nbh, packed))
        out["train_fwd_digest"] = digest(torch, hck, xck)
        # the launches alone at the kNN shape: td_block_node (every row), the
        # h2x pass's node launch (td_block_node_rows where the tree has it),
        # the x2h and h2x edge launches
        xl, hl = (pass_launcher(torch, kblock, h, x, nbh, mlig, e_w,
                                {k: v[:1] for k, v in st.items()}, MAX_LIGAND)
                  for st in (x2h, h2x))
        xl.node()
        hl.node_rows()
        xl.x2h()
        hl.h2x()
        out["launches_digest"] = digest(torch, xl.ni, xl.nj, xl.q, xl.out, hl.xout)
        for name, fn in (("x2h_edge", xl.x2h), ("h2x_edge", hl.h2x), ("node", xl.node),
                         ("node_h2x", hl.node_rows)):
            out[f"{name}_knn_ms"] = cuda_ms(torch, fn)
            out[f"{name}_knn_device_ms"] = device_ms(torch, fn)
        # the bf16 kernels at the kNN shape: the whole block and the x2h edge
        # launch alone (layer 0), with digests of their outputs
        out["bf16_block_ms"] = cuda_ms(torch, lambda: kblock.block_denoiser_cuda(
            rn, h, x, nbh, mlig, MAX_LIGAND, bpacked, dtype=bf16))
        out["bf16_block_device_ms"] = device_ms(torch, lambda: kblock.block_denoiser_cuda(
            rn, h, x, nbh, mlig, MAX_LIGAND, bpacked, dtype=bf16), calls=5)
        out["bf16_block_digest"] = digest(torch, *kblock.block_denoiser_cuda(
            rn, h, x, nbh, mlig, MAX_LIGAND, bpacked, dtype=bf16))
        xl16 = pass_launcher(torch, kblock, h, x, nbh, mlig, rn.edge_weights(x, nbh, bf16)[..., 0],
                             bpx, MAX_LIGAND, bf16=True)
        xl16.node()
        xl16.x2h()
        out["bf16_x2h_edge_digest"] = digest(torch, xl16.out)
        out["bf16_x2h_edge_knn_ms"] = cuda_ms(torch, xl16.x2h)
        out["bf16_x2h_edge_knn_device_ms"] = device_ms(torch, xl16.x2h)
        out.update(bf16_node_duel(torch, kblock, xl16, pass_launcher(
            torch, kblock, h, x, nbh, mlig, xl16.tensors[0].ew, bph, MAX_LIGAND, bf16=True),
            "b4"))
        out.update(bf16_h2x_duel(torch, kblock, pass_launcher(
            torch, kblock, h, x, nbh, mlig, xl16.tensors[0].ew, bph, MAX_LIGAND, bf16=True),
            "b4"))
        # the sampler's forward (need_full_h=False where the tree has it: the
        # dependency cone) at kNN B=4 and B=100: digests of its ligand outputs
        cone_kw = ({"need_full_h": False}
                   if "need_full_h" in inspect.signature(model.fast_apply).parameters else {})
        for label, sizes in (("b4", [MAX_LIGAND] * B), ("b100", LIGAND_SIZES * 25)):
            fb = pocket_batch(torch, dev, pocket, feat_dim, MAX_LIGAND, sizes, 0)
            for tag, pk, dt in (("f32", packed, torch.float32), ("bf16", bpacked, bf16)):
                pred = model.fast_apply(fb, fb.ligand_pos, fb.ligand_v, packed=pk, dtype=dt,
                                        **cone_kw)
                out[f"sampler_forward_{tag}_{label}_ligand_digest"] = digest(
                    torch, pred["pred_ligand_pos"], pred["pred_ligand_v"],
                    pred["final_ligand_h"])
            # the embedding export (every row: final_h too)
            out[f"embedding_{label}_digest"] = digest(torch, model.fetch_embedding(fb, impl="fast"))
            out.update(cone_duel(torch, model, fb, label))
    sample(3, 1)  # warm up
    out["sample_ms_per_step"] = sample(50, 1)
    # the kNN B=4 sampling step in bf16 (the default precision) over 1000
    # steps, host clock
    sample16 = setup("knn", B, torch.bfloat16)[1]
    sample16(3, 1)
    out["bf16_sample_ms_per_step_1000"] = sample16(1000, 1)
    # the kNN B=100 sampling step in bf16 and in float32: host and device ms
    # per step, node_kernel's, the edge kernels' and cone_kernel's device ms
    # per step, and the x2h edge and node launches one by one (layer order;
    # node: the x2h pass's, then the h2x pass's, each layer)
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        step100 = profile(torch, setup("knn", 100, dt)[1], "knn", 100,
                          per_launch=("x2h_edge", "node_kernel"))
        out.update({f"{tag}_knn_b100_step_host_ms": step100["host_ms_per_step"],
                    f"{tag}_knn_b100_step_device_ms": step100["device_ms_per_step"],
                    f"{tag}_knn_b100_cone_device_ms_per_step": step100["cone_kernel_ms_per_step"],
                    f"{tag}_knn_b100_x2h_edge_per_launch_ms": step100["x2h_edge_per_launch_ms"],
                    f"{tag}_knn_b100_node_per_launch_ms": step100["node_kernel_per_launch_ms"],
                    **{f"{tag}_knn_b100_{name}_device_ms_per_step": sum(
                        v["ms"] for k, v in step100["kernels_per_step"].items() if piece in k)
                       for name, piece in (("node", "node_kernel"), ("x2h_edge", "x2h_edge"),
                                           ("h2x_edge", "h2x_edge"))}})

    hmodel, hsample = setup("hybrid")
    hrn = hmodel.net.refine_net
    with torch.no_grad():
        hh, hx, hnode, hmlig = hmodel.net.embed(
            *pocket_batch(torch, dev, pocket, feat_dim, HYBRID_LIGAND, HYBRID_SIZES, 7))
        hnbh = hrn.graph(hx, hnode, hmlig)
        he_w = hrn.edge_weights(hx, hnbh)[..., 0]
        px, ph = kel.pack_layer_params(hrn.base_block[0])
        layers = {"x2h": lambda: kel.x2h_layer_cuda(hh, hx, hnbh, hmlig, he_w, px),
                  "h2x": lambda: kel.h2x_layer_cuda(hh, hx, hnbh, hmlig, he_w, HYBRID_LIGAND, ph)}
        cot = {"x2h": torch.randn(hh.shape, generator=gen, device=dev) * hnode[..., None],
               "h2x": torch.randn(hx.shape, generator=gen, device=dev)}
        bwds = {"x2h": lambda: kelv.x2h_layer_bwd_cuda(hh, hx, hnbh, hmlig, he_w, px,
                                                       cot["x2h"]),
                "h2x": lambda: kelv.h2x_layer_bwd_cuda(hh, hx, hnbh, hmlig, he_w, HYBRID_LIGAND,
                                                       ph, cot["h2x"])}
        out["layers_digest"] = digest(torch, layers["x2h"](), layers["h2x"]())
        # the bf16 per-layer x2h and h2x: each call, its edge kernel's and
        # node_kernel's device time
        bpx_h, bph_h = kel.pack_layer_params(hrn.base_block[0], bf16)

        def x2h16():
            return kel.x2h_layer_cuda(hh, hx, hnbh, hmlig, he_w, bpx_h, bf16)

        out["bf16_x2h_layer_hybrid_ms"] = cuda_ms(torch, x2h16)
        out["bf16_x2h_edge_hybrid_device_ms"] = kernel_device_ms(torch, x2h16, "x2h_edge")
        out["bf16_node_x2h_hybrid_device_ms"] = kernel_device_ms(torch, x2h16, "node_kernel")
        out["bf16_layers_digest"] = digest(torch, x2h16())

        def h2x16():
            return kel.h2x_layer_cuda(hh, hx, hnbh, hmlig, he_w, HYBRID_LIGAND, bph_h, bf16)

        out["bf16_h2x_layer_hybrid_ms"] = cuda_ms(torch, h2x16)
        out["bf16_h2x_edge_hybrid_device_ms"] = kernel_device_ms(torch, h2x16, "h2x_edge")
        out["bf16_node_h2x_hybrid_device_ms"] = kernel_device_ms(torch, h2x16, "node_kernel")
        out["bf16_h2x_layers_digest"] = digest(torch, h2x16())
        for sub, fn in bwds.items():
            out[f"{sub}_layer_bwd_hybrid_ms"] = cuda_ms(torch, fn, reps=10)
            out.update(bwd_device_ms(torch, f"{sub}_layer_bwd_hybrid", fn))
        for sub, fn in layers.items():
            out[f"{sub}_layer_hybrid_ms"] = cuda_ms(torch, fn)
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            # device time by kernel name: the edge kernel (x2h_edge_kernel, or
            # edge_kernel<false, .> before it; h2x_edge_kernel) and node_kernel
            times = device_times(prof, 10).items()
            out[f"{sub}_edge_hybrid_device_ms"] = sum(
                v["ms"] for k, v in times
                if f"{sub}_edge_kernel" in k or (sub == "x2h" and "edge_kernel<false" in k))
            out[f"node_{sub}_hybrid_device_ms"] = sum(v["ms"] for k, v in times
                                                      if "node_kernel" in k)
    hsample(3, 1)  # warm up
    out["hybrid_sample_ms_per_step"] = hsample(50, 1)

    tb, tmodel, state, step, tgen = train_setup(torch, dev, feat_dim)
    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, tb, tgen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, _ = step(state, tb, tgen)
    torch.cuda.synchronize()
    out["train_step_ms"] = 1e3 * (time.perf_counter() - t0) / 10
    # the backwards' kernels in 3 traced `fast` steps
    step_out = {}

    def three_steps():
        nonlocal state
        for _ in range(3):
            state, _ = step(state, tb, tgen)

    for key, ms in bwd_device_ms(torch, "train_step", three_steps, calls=1).items():
        out[key.replace("_device_ms", "_device_ms_per_step")] = ms / 3
    # the inverse adjacency's device time per build at this batch: the x2h
    # pass's (row0 = 0) in a per-layer x2h backward, the h2x pass's in an h2x one
    trn = tmodel.net.refine_net
    with torch.no_grad():
        th, tx, tnode, tmlig = tmodel.net.embed(*tb)
        tnbh = G.knn_graph(tx, tnode, K)
        te_w = trn.edge_weights(tx, tnbh)[..., 0]
        tpx, tph = kel.pack_layer_params(trn.base_block[0])
        tgh = torch.randn(th.shape, generator=gen, device=dev) * tnode[..., None]
        tgx = torch.randn(tx.shape, generator=gen, device=dev)
        out["adj_x2h_b32_device_ms"] = kernel_device_ms(torch, lambda: kelv.x2h_layer_bwd_cuda(
            th, tx, tnbh, tmlig, te_w, tpx, tgh), "adj_", calls=5)
        out["adj_h2x_b32_device_ms"] = kernel_device_ms(torch, lambda: kelv.h2x_layer_bwd_cuda(
            th, tx, tnbh, tmlig, te_w, MAX_LIGAND, tph, tgx), "adj_", calls=5)
        # the whole-block backward at this batch: a digest of every output
        tx2h, th2x = kblock.pack_pass_params(trn)
        thck, txck = kblock.block_denoiser_train_cuda(trn, th, tx, tnbh, tmlig, te_w, MAX_LIGAND,
                                                      tx2h, th2x)
        out["train_bwd_digest"] = digest(torch, *kvjp.block_bwd_cuda(
            thck, txck, tnbh.idx, tnbh.mask, tmlig, te_w, MAX_LIGAND, tx2h, th2x, tgh, tgx))
        del thck, txck
    # the `fast_pl` step on the same batch and model
    pl_state = create_train_state(tmodel, train_utils.get_optimizer(Config(OPTIMIZER),
                                                                    tmodel.parameters()))
    pl_step = make_train_step(tmodel, pos_noise_std=0.1, time_sampling="importance",
                              impl="fast_pl")
    for _ in range(TRAIN_WARMUP):
        pl_state, _ = pl_step(pl_state, tb, tgen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        pl_state, _ = pl_step(pl_state, tb, tgen)
    torch.cuda.synchronize()
    out["train_pl_step_ms"] = 1e3 * (time.perf_counter() - t0) / 10

    def three_pl_steps():
        nonlocal pl_state
        for _ in range(3):
            pl_state, _ = pl_step(pl_state, tb, tgen)

    for key, ms in bwd_device_ms(torch, "train_pl_step", three_pl_steps, calls=1).items():
        out[key.replace("_device_ms", "_device_ms_per_step")] = ms / 3
    # the `fast_bf16` step on the same batch and model, and the quality
    # gate's `fast` step (its model and padding, B=32 of its pool)
    from targetdiff_tpu_torch.tools import quality_gate as qg

    bf_step = make_train_step(tmodel, pos_noise_std=0.1, time_sampling="importance",
                              impl="fast_bf16")
    gmodel = qg.build_model(dev)
    steps = {"train_fast": (tmodel, step, tb, 10), "train_bf16": (tmodel, bf_step, tb, 10),
             "train_pl": (tmodel, pl_step, tb, 10),
             "gate_train": (gmodel, make_train_step(gmodel, pos_noise_std=0.1),
                            qg.ComplexBatch(*[t[:qg.BATCH] for t in qg.make_pool().to(dev)]), 20)}
    for label, (m, step_fn, batch_, reps) in steps.items():
        st = create_train_state(m, train_utils.get_optimizer(Config(OPTIMIZER), m.parameters()))
        out.update({f"{label}_{k}": v for k, v in step_fields(
            torch, step_fn, st, batch_, tgen, reps).items()})
    return out


def step_fields(torch, step, state, batch, gen, reps) -> dict:
    """A train step's host ms over `reps` steps after TRAIN_WARMUP, and its
    device ms, node_kernel's (the forward and the backward's recompute, both
    passes), the x2h and h2x edge_bwd_kernel's, the weight-gradient
    products', reduce_kernel's, both together and stage_w2_kernel's device
    ms per step (and the last two's launches) over 3 traced steps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    out = {"step_ms": 1e3 * (time.perf_counter() - t0) / reps}
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    times = device_times(prof, 3)
    out.update(step_device_ms=sum(v["ms"] for v in times.values()),
               node_device_ms_per_step=sum(v["ms"] for k, v in times.items()
                                           if "node_kernel" in k),
               **{f"edge_bwd_{sub}_device_ms_per_step": sum(
                   v["ms"] for k, v in times.items() if f"edge_bwd_kernel<{h2x}" in k)
                  for sub, h2x in (("x2h", "false"), ("h2x", "true"))},
               **{f"{key}_device_ms_per_step": sum(v["ms"] for k, v in times.items()
                                                   if any(pc in k for pc in pieces))
                  for key, pieces in BWD_PIECES if key in ("wgrad", "reduce", "wgrad_reduce",
                                                           "stage_w2")},
               **{f"{key}_launches_per_step": sum(v["launches"] for k, v in times.items()
                                                  if any(pc in k for pc in pieces))
                  for key, pieces in BWD_PIECES if key in ("reduce", "stage_w2")})
    return out


def bf16_h2x_duel(torch, kblock, hl, label) -> dict:
    """The bf16 h2x edge launch alone (`pass_launcher` hl of bf16 h2x
    weights, after its node launch): CUDA-event and device ms, and a digest
    of x'."""
    hl.node_rows()
    hl.h2x()
    return {f"bf16_h2x_edge_{label}_digest": digest(torch, hl.xout),
            f"bf16_h2x_edge_{label}_ms": cuda_ms(torch, hl.h2x),
            f"bf16_h2x_edge_{label}_device_ms": device_ms(torch, hl.h2x, calls=10)}


def bf16_node_duel(torch, kblock, xl, hl, label) -> dict:
    """The bf16 node launch alone (`pass_launcher`s xl, every row, and hl, as
    the h2x pass launches it): CUDA-event and device ms of both, a digest of
    the full launch's ni, nj and q (the rows below row0 of hl's are unset)."""
    xl.node()
    out = {f"bf16_node_{label}_digest": digest(torch, xl.ni, xl.nj, xl.q)}
    for name, fn in (("node", xl.node), ("node_h2x", hl.node_rows)):
        out[f"bf16_{name}_{label}_ms"] = cuda_ms(torch, fn)
        out[f"bf16_{name}_{label}_device_ms"] = device_ms(torch, fn)
    return out


# ---- the EGNN denoiser and the affinity models ----------------------------------------

# the flagship's widths with the EGNN refine net (configs/training.yml with
# model_type: egnn): 9 layers, hidden 128, kNN 32, 4 edge types, one distance
# feature (d^2), silu, no norm
EGNN = dict(FLAGSHIP, model_type="egnn")
EGNN_TRAIN_STEPS, EGNN_TRAIN_WARMUP = 5, 2
# configs/prop/pdbbind_general_egnn.yml (model, train) and
# pdbbind_general_egnn_enc_final_h.yml (model), held equal to the files by
# tests/test_torch_prop_cli.py (the card's machine has no PyYAML)
PROP_MODEL = dict(hidden_channels=256, encoder=dict(
    name="egnn", num_layers=6, hidden_dim=256, edge_dim=0, num_r_gaussian=64, act_fn="relu",
    norm=False, knn=48, cutoff=10.0))
PROP_TRAIN = dict(seed=2021, batch_size=16, max_epochs=100, pos_noise_std=0.1,
                  max_grad_norm=8.0,
                  optimizer=dict(type="adam", lr=1e-4, weight_decay=0, beta1=0.95, beta2=0.999),
                  scheduler=dict(type="plateau", factor=0.6, patience=10, min_lr=1e-6))
PROP_ENC_MODEL = dict(hidden_channels=256, enc_ligand_dim=0, enc_node_dim=128, enc_graph_dim=0,
                      enc_feature_type="final_h",
                      encoder=dict(PROP_MODEL["encoder"], name="egnn_enc"))
# [prop]: batches of 16 synthetic complexes at train_prop's default padding
PROP_B, PROP_PROTEIN, PROP_LIGAND, PROP_K = 16, 512, 96, 48
PROP_STEPS, PROP_WARMUP, PROP_CPU_ROWS = 5, 2, 2
PROP_REL = 1e-4  # the prop model on the card against the CPU, relative to the output's scale
PROP_STEP_REL = 1e-4  # its first loss and gradient norm on the card against the CPU's, relative
PROP_LIG_DIM = 30  # the prop ligand features (FeaturizeLigandAtomProp)
# [prop-cli]: 32 copies of examples/3ug2 (a 758-atom pocket: inference_prop's
# 768 protein slots) split 16 / 16, one epoch of the full-width config
PROP_CLI_COPIES, PROP_CLI_PROTEIN = 32, 768
# [prop-gate-short] and `prop-gate`
PROP_GATE_SHORT = dict(epochs=2, diff_steps=200)
PROP_GATE = dict(epochs=30, diff_steps=1500)  # tools/prop_quality_gate.py's defaults


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def kernel_split(torch, fn, calls=3, top=6) -> dict:
    """Where fn's device time goes: device ms and kernel launches per call
    (torch.profiler, after one warm-up call) and the `top` kernels by device
    time (name cut to 48 characters, ms and launches per call)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = device_times(prof, calls)
    return {"device_ms": sum(k["ms"] for k in kernels.values()),
            "launches": sum(k["launches"] for k in kernels.values()),
            "top": [(name[:48], k["ms"], k["launches"])
                    for name, k in list(kernels.items())[:top]]}


def egnn_phases(torch, dev, pocket, feat_dim, batch) -> dict:
    """[egnn-sample]: the EGNN denoiser at the flagship's widths on the
    example pocket (B = 4, N = 608): one call on the card against the same
    weights and inputs on the CPU (positions POS_TOL, logits H_TOL) with
    exactly one kNN launch per layer, timed; then a 1000-step DDPM run
    through `sample_diffusion_ligand` (the model takes the eager path from
    its config) with exactly 1000 x 9 kNN launches, molecules finite, in the vocabulary
    and near the pocket. [egnn-train]: `make_train_step(impl='eager')` on
    [train]'s B = 32 batch (N = 416): the first step's loss within 1e-4 of
    the CPU's on the batch's first four complexes with the same draws, then
    timed steps (9 kNN launches each), loss finite, peak GiB. Returns the
    kNN launches of the sampling run and of the timed steps."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.batch import ComplexBatch
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand
    from targetdiff_tpu_torch.trainer import create_train_state, make_train_step
    from targetdiff_tpu_torch.utils import train as train_utils

    L = EGNN["num_layers"]
    model, cpu = eager_models(torch, dev, EGNN, feat_dim, 7)
    if model.impl != "eager":
        raise AssertionError(f"egnn-sample: the EGNN model's path is {model.impl!r}, want eager")

    def call():
        with torch.no_grad():
            return model.apply(batch, batch.ligand_pos, batch.ligand_v)

    kknn.LAUNCHES = 0
    got = call()
    torch.cuda.synchronize()
    call_launches = kknn.LAUNCHES
    if call_launches != L:
        raise AssertionError(f"egnn-sample: {call_launches} kNN launches in a call, want {L}")
    with torch.no_grad():
        want = cpu.apply(batch.to("cpu"), batch.ligand_pos.cpu(), batch.ligand_v.cpu())
    lm = batch.ligand_mask.cpu()
    errs = {"pos": check_close("egnn pos", got["pred_ligand_pos"].cpu()[lm],
                               want["pred_ligand_pos"][lm], **POS_TOL),
            "logits": check_close("egnn logits", got["pred_ligand_v"].cpu()[lm],
                                  want["pred_ligand_v"][lm], **H_TOL)}
    call_ms, call_split = cuda_ms(torch, call, reps=10), kernel_split(torch, call)
    steps = model.num_timesteps
    kknn.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sample_diffusion_ligand(
        model, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(9),
        batch_size=B, num_steps=steps, max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND,
        rng=np.random.default_rng(9))
    wall = time.perf_counter() - t0
    sample_launches = kknn.LAUNCHES
    if sample_launches != L * steps:
        raise AssertionError(f"egnn-sample: {sample_launches} kNN launches, want {L * steps}")
    offset = check_molecules("egnn-sample", res, pocket)
    phase("egnn-sample", shape=f"B={B},N={MAX_PROTEIN + MAX_LIGAND},K={K},L={L},"
          f"H={EGNN['hidden_dim']}",
          max_abs_err=errs, call_knn_launches=call_launches, call_ms=call_ms,
          call_device_ms=call_split["device_ms"], call_kernel_launches=call_split["launches"],
          call_top_kernels=call_split["top"], steps=steps, seconds=res["time"][0],
          wall_seconds=wall,
          ms_per_step=1e3 * res["time"][0] / steps, knn_launches=sample_launches,
          ligand_atoms=[len(v) for v in res["v"]], max_centroid_offset_A=offset)
    del model, cpu

    tmodel, tcpu = eager_models(torch, dev, EGNN, feat_dim, 8)
    tb = train_batch(dev)
    sub = ComplexBatch(*[t[:4] for t in tb])
    t, eps, u = loss_draws(torch, tmodel, sub, torch.Generator(device=dev).manual_seed(4))
    state = create_train_state(tmodel, train_utils.get_optimizer(Config(OPTIMIZER),
                                                                 tmodel.parameters()))
    _, first = make_train_step(tmodel, pos_noise_std=0.0, impl="eager")(
        state, sub, None, time_step=t, pos_noise=eps, v_uniform=u)
    with torch.no_grad():
        ref = tcpu.get_diffusion_loss(sub.to("cpu"), time_step=t.cpu(), pos_noise=eps.cpu(),
                                      v_uniform=u.cpu(), impl="eager")
    loss_err = abs(float(first["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    if not loss_err <= 1e-4:
        raise AssertionError(f"egnn-train: first loss {float(first['loss'])} against the CPU's "
                             f"{float(ref['loss'])} (rel {loss_err})")
    step = make_train_step(tmodel, pos_noise_std=0.1, impl="eager")
    gen = torch.Generator(device=dev).manual_seed(5)
    for _ in range(EGNN_TRAIN_WARMUP):
        state, metrics = step(state, tb, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kknn.LAUNCHES = 0
    t0 = time.perf_counter()
    losses = []
    for _ in range(EGNN_TRAIN_STEPS):
        state, metrics = step(state, tb, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / EGNN_TRAIN_STEPS
    train_launches = kknn.LAUNCHES
    losses = [float(x) for x in losses]

    def one_step():
        nonlocal state
        state, _ = step(state, tb, gen)

    step_split = kernel_split(torch, one_step, calls=2)
    if train_launches != L * EGNN_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"egnn-train: kNN launches {train_launches} (want "
                             f"{L * EGNN_TRAIN_STEPS}), losses {losses}")
    phase("egnn-train", shape=f"B={TRAIN_B},N={TRAIN_PROTEIN + MAX_LIGAND},K={K},L={L}",
          first_loss=float(first["loss"]), cpu_first_loss=float(ref["loss"]),
          first_loss_rel_err=loss_err, losses=losses, ms_per_step=ms,
          complexes_per_s=1e3 * TRAIN_B / ms, peak_gib=peak_gib(torch),
          knn_launches=train_launches, step_device_ms=step_split["device_ms"],
          step_kernel_launches=step_split["launches"], step_top_kernels=step_split["top"])
    return {"sample": sample_launches, "train": train_launches}


# [variant-sample], [variant-train], [bf16-eager]: the uni_o2 options the
# released model does not use, at its widths (configs/training.yml: 1 block x
# 9 layers, hidden 128, 16 heads, kNN 32, 20 knots, 4 edge types), eager, the
# graph on the kNN kernel. V1: the reference's class defaults for the two
# edge options (targetdiff_tpu/models/uni_transformer.py:241-247); V2: every
# other option at once.
VARIANTS = {
    "V1": dict(FLAGSHIP, ew_net_type="r", x2h_out_fc=True),
    "V2": dict(FLAGSHIP, ew_net_type="m", num_x2h=2, num_h2x=2, sync_twoup=True,
               act_fn="swish", norm=False, time_emb_mode="sin", time_emb_dim=8),
}
VARIANT_SAMPLE_STEPS = {"V1": 1000, "V2": 100}
VARIANT_TRAIN_B = {"V1": (TRAIN_B,), "V2": (TRAIN_B, 16, 8)}  # V2: the largest that fits
VARIANT_TRAIN_STEPS, VARIANT_TRAIN_WARMUP = 3, 1
VARIANT_T = 500  # the time step of the single calls (V2 embeds it)
# the bf16 model on the card against the same weights on the CPU, each output
# relative to its scale: positions and final_h at JAX's bf16 bar on x and h
# (tools/kparity.py:91, the CPU tests' bar against JAX's bf16 model); the
# logits, the bf16 head's rounded output, at five bf16 ulps of their scale:
# there the card and the CPU part as far as bf16 lies from float32 on the
# CPU (EGNN 2.07e-2 and 1.95e-2, V1 1.32e-2 and 1.41e-2 on an H100). The
# first loss at the CPU tests' bf16 loss bar.
BF16_EAGER_BARS = {"pos": 2e-2, "logits": 5 * 2.0**-7, "final_h": 2e-2}
BF16_EAGER_LOSS_REL = 1e-2
BF16_EAGER_CLI_STEPS = 3


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count (the counts `reset_train_counts`
    zeroes), by module and counter, dicts summed."""
    import importlib

    out = {}
    for name in ("block_denoiser", "block_vjp", "edge_layer", "edge_layer_vjp", "knn",
                 "weight_grad"):
        mod = importlib.import_module(f"targetdiff_tpu_torch.ops.kernels.{name}")
        for attr, count in vars(mod).items():
            if attr.endswith("LAUNCHES"):
                out[f"{name}.{attr}"] = sum(count.values()) if isinstance(count, dict) else count
    return out


def knn_only(label, want_knn) -> int:
    """The kNN launches since `reset_train_counts`; AssertionError unless
    they are `want_knn` and no other kernel launched."""
    counts = kernel_launches()
    knn = counts.pop("knn.LAUNCHES")
    others = {k: v for k, v in counts.items() if v}
    if knn != want_knn or others:
        raise AssertionError(f"{label}: {knn} kNN launches (want {want_knn}), other kernels "
                             f"{others}")
    return knn


def eager_models(torch, dev, cfg, feat_dim, seed, max_ligand=MAX_LIGAND,
                 model_dtype=None):
    """A model of `cfg` with seeded random weights on the card and the same
    weights on the CPU."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.models.score_model import DiffusionModel

    md = model_dtype or torch.float32
    torch.manual_seed(seed)
    card = DiffusionModel(Config(cfg), feat_dim, NUM_CLASSES, device=dev,
                          max_protein=MAX_PROTEIN, max_ligand=max_ligand, model_dtype=md)
    cpu = DiffusionModel(Config(cfg), feat_dim, NUM_CLASSES, device="cpu",
                         max_protein=MAX_PROTEIN, max_ligand=max_ligand, model_dtype=md)
    cpu.net.load_state_dict({k: v.cpu() for k, v in card.net.state_dict().items()})
    return card, cpu


def eager_call_fields(torch, model, cpu, batch, label, tol=None, scale_bars=None) -> dict:
    """One eager call of `model` on `batch` (t = VARIANT_T) against the same
    weights on the CPU: one kNN launch a graph and no other kernel; errors
    of positions and logits within `tol` (allclose keywords of each), or
    with `scale_bars` those and final_h's, each relative to its scale,
    within its bar; ms by CUDA events."""
    t = torch.full((batch.num_graphs,), VARIANT_T, dtype=torch.long, device=batch.device)

    def call():
        with torch.no_grad():
            return model.apply(batch, batch.ligand_pos, batch.ligand_v, time_step=t)

    graphs = graphs_per_call(model.config)
    reset_train_counts()
    got = call()
    torch.cuda.synchronize()
    knn_only(label, graphs)
    with torch.no_grad():
        want = cpu.apply(batch.to("cpu"), batch.ligand_pos.cpu(), batch.ligand_v.cpu(),
                         time_step=t.cpu())
    lm = batch.ligand_mask.cpu()
    pairs = {"pos": (got["pred_ligand_pos"].cpu()[lm], want["pred_ligand_pos"][lm]),
             "logits": (got["pred_ligand_v"].cpu()[lm], want["pred_ligand_v"][lm])}
    if scale_bars is None:
        errs = {k: check_close(f"{label} {k}", g, w, **tol[k]) for k, (g, w) in pairs.items()}
    else:
        pairs["final_h"] = (got["final_h"].cpu(), want["final_h"])
        errs = {}
        for k, (g, w) in pairs.items():
            errs[k] = float((g - w).abs().max() / w.abs().max())
            if not errs[k] <= scale_bars[k]:
                raise AssertionError(f"{label}: {k} {errs[k]} of scale from the CPU's "
                                     f"(bar {scale_bars[k]})")
    return {"max_err": errs, "call_ms": cuda_ms(torch, call, reps=5, warmup=1),
            "call_knn_launches": graphs}


def graphs_per_call(cfg) -> int:
    """kNN graphs a forward builds: one a block (uni_o2), one a layer (EGNN)."""
    return cfg["num_layers"] if cfg["model_type"] == "egnn" else cfg["num_blocks"]


def check_molecules(label, res, pocket) -> float:
    """Molecules finite, of their sizes, in the vocabulary and near the
    pocket; returns the largest centroid offset (A)."""
    centre = pocket["protein_pos"].mean(0)
    for pos, v in zip(res["pos"], res["v"]):
        if pos.shape != (len(v), 3) or not np.isfinite(pos).all():
            raise AssertionError(f"{label}: a non-finite or misshaped molecule")
        if not ((v >= 0) & (v < NUM_CLASSES)).all():
            raise AssertionError(f"{label}: an atom type outside the vocabulary")
    offset = float(max(np.linalg.norm(p.mean(0) - centre) for p in res["pos"]))
    if offset > 10.0:
        raise AssertionError(f"{label}: a centroid lies {offset} A from the pocket's")
    return offset


def eager_train_fields(torch, dev, model, cpu, b, label, loss_rel=1e-4) -> dict:
    """`make_train_step` (the model's eager path) on the first b complexes
    of [train]'s batch: the first loss within loss_rel of the CPU's on the
    first four complexes with the same draws, then VARIANT_TRAIN_STEPS timed
    steps after VARIANT_TRAIN_WARMUP, one kNN launch each and no other
    kernel; losses finite; peak GiB of the timed steps."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.batch import ComplexBatch
    from targetdiff_tpu_torch.trainer import create_train_state, make_train_step
    from targetdiff_tpu_torch.utils import train as train_utils

    tb = train_batch(dev)
    sub = ComplexBatch(*[t[:4] for t in tb])
    tb = ComplexBatch(*[t[:b] for t in tb])
    t, eps, u = loss_draws(torch, model, sub, torch.Generator(device=dev).manual_seed(4))
    state = create_train_state(model, train_utils.get_optimizer(Config(OPTIMIZER),
                                                                model.parameters()))
    _, first = make_train_step(model, pos_noise_std=0.0)(state, sub, None, time_step=t,
                                                         pos_noise=eps, v_uniform=u)
    with torch.no_grad():
        ref = cpu.get_diffusion_loss(sub.to("cpu"), time_step=t.cpu(), pos_noise=eps.cpu(),
                                     v_uniform=u.cpu())
    loss_err = abs(float(first["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    if not loss_err <= loss_rel:
        raise AssertionError(f"{label}: first loss {float(first['loss'])} against the CPU's "
                             f"{float(ref['loss'])} (rel {loss_err})")
    step = make_train_step(model, pos_noise_std=0.1)
    gen = torch.Generator(device=dev).manual_seed(5)
    for _ in range(VARIANT_TRAIN_WARMUP):
        state, metrics = step(state, tb, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(VARIANT_TRAIN_STEPS):
        state, metrics = step(state, tb, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / VARIANT_TRAIN_STEPS
    launches = knn_only(label, VARIANT_TRAIN_STEPS * graphs_per_call(model.config))
    losses = [float(x) for x in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    return {"B": b, "first_loss": float(first["loss"]), "cpu_first_loss": float(ref["loss"]),
            "first_loss_rel_err": loss_err, "losses": losses, "ms_per_step": ms,
            "complexes_per_s": 1e3 * b / ms, "peak_gib": peak_gib(torch),
            "knn_launches": launches}


def variant_phases(torch, dev, pocket, feat_dim, batch) -> dict:
    """[variant-sample]: V1 and V2 at the released widths on the example
    pocket (B = 4, N = 608): one call on the card against the same weights
    on the CPU (positions POS_TOL, logits H_TOL), exactly one kNN launch a
    call and no other kernel, timed; then a DDPM run through
    `sample_diffusion_ligand` (the model's eager path; V1 1000 steps, V2 the
    last 100), one kNN launch a step, molecules finite, in the vocabulary
    and near the pocket, ms per step. [variant-train]: `make_train_step` of
    V1 at [train]'s B = 32 batch (N = 416) and of V2 at the largest of
    32 / 16 / 8 that fits the card (a batch that runs out of memory is
    recorded and the next tried): the first loss within 1e-4 of the CPU's,
    timed steps with one kNN launch each, peak GiB. Returns the kNN
    launches of each run and V1's train fields."""
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    card = card_name()
    out = {"sample": {}, "train": {}}
    for name, cfg in VARIANTS.items():
        model, cpu = eager_models(torch, dev, cfg, feat_dim, 21)
        rn = model.net.refine_net
        if model.impl != "eager" or not rn.knn_kernel:
            raise AssertionError(f"variant-sample {name}: path {model.impl!r}, graph on the "
                                 f"kNN kernel {rn.knn_kernel}")
        fields = eager_call_fields(torch, model, cpu, batch, f"variant-sample {name}",
                                   {"pos": POS_TOL, "logits": H_TOL})
        steps = VARIANT_SAMPLE_STEPS[name]
        reset_train_counts()
        t0 = time.perf_counter()
        res = sample_diffusion_ligand(
            model, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(9),
            batch_size=B, num_steps=steps, max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND,
            rng=np.random.default_rng(9))
        wall = time.perf_counter() - t0
        launches = knn_only(f"variant-sample {name}", steps)
        offset = check_molecules(f"variant-sample {name}", res, pocket)
        out["sample"][name] = launches
        phase("variant-sample", card=card, config=name,
              shape=f"B={B},N={MAX_PROTEIN + MAX_LIGAND},K={K},L={cfg['num_layers']},"
              f"H={cfg['hidden_dim']}", **fields, steps=steps, seconds=res["time"][0],
              wall_seconds=wall, ms_per_step=1e3 * res["time"][0] / steps,
              knn_launches=launches, ligand_atoms=[len(v) for v in res["v"]],
              max_centroid_offset_A=offset)
        del model, cpu, res
        torch.cuda.empty_cache()
    for name, cfg in VARIANTS.items():
        out_of_memory = []
        for b in VARIANT_TRAIN_B[name]:
            # fresh weights for each batch tried: a step that ran out of
            # memory may have updated them
            model, cpu = eager_models(torch, dev, cfg, feat_dim, 22)
            fields = None
            try:
                fields = eager_train_fields(torch, dev, model, cpu, b, f"variant-train {name}")
            except torch.cuda.OutOfMemoryError:
                if b == VARIANT_TRAIN_B[name][-1]:
                    raise
                out_of_memory.append(b)
            if fields is not None:
                break
            del model, cpu
            torch.cuda.empty_cache()
        out["train"][name] = fields
        phase("variant-train", card=card, config=name,
              shape=f"B={fields['B']},N={TRAIN_PROTEIN + MAX_LIGAND},K={K},"
              f"L={cfg['num_layers']}", out_of_memory_at_B=out_of_memory, **fields)
        del model, cpu
        torch.cuda.empty_cache()
    return out


def bf16_eager_phase(torch, dev, pocket, feat_dim, batch, v1_train) -> dict:
    """[bf16-eager]: the bf16 model (`model_dtype=torch.bfloat16`, JAX's
    dtype=bf16 model on its XLA path) of V1 and of the EGNN denoiser: one
    call on the card against the same weights on the CPU, positions, logits
    and final_h within BF16_EAGER_BARS of their scale, one kNN launch a graph
    and no other kernel, timed beside the float32 model's call; V1's eager
    train step at [variant-train]'s batch, ms and peak GiB beside float32's
    from [variant-train]; then `train_diffusion --dtype bf16` on V1 for
    BF16_EAGER_CLI_STEPS iterations: the bf16 model trained eagerly, losses
    finite, one kNN launch a step and validation call and no other kernel,
    the checkpoint float32. Returns the kNN launches."""
    from targetdiff_tpu_torch.cli import train_diffusion
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.models.score_model import DiffusionModel

    card = card_name()
    launches = {}
    t = torch.full((B,), VARIANT_T, dtype=torch.long, device=dev)
    for name, cfg in (("V1", VARIANTS["V1"]), ("egnn", EGNN)):
        model, cpu = eager_models(torch, dev, cfg, feat_dim, 23, model_dtype=torch.bfloat16)
        fields = eager_call_fields(torch, model, cpu, batch, f"bf16-eager {name}",
                                   scale_bars=BF16_EAGER_BARS)
        f32 = DiffusionModel(Config(cfg), feat_dim, NUM_CLASSES, device=dev,
                             max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND)
        f32.net.load_state_dict(model.net.state_dict())

        def f32_call():
            with torch.no_grad():
                return f32.apply(batch, batch.ligand_pos, batch.ligand_v, time_step=t)

        f32_ms = cuda_ms(torch, f32_call, reps=5, warmup=1)
        del f32
        train = {}
        if name == "V1":
            train = eager_train_fields(torch, dev, model, cpu, v1_train["B"], "bf16-eager V1",
                                       loss_rel=BF16_EAGER_LOSS_REL)
            train = {f"train_{k}": v for k, v in train.items()}
            train.update(train_ms_per_step_float32=v1_train["ms_per_step"],
                         train_peak_gib_float32=v1_train["peak_gib"])
        launches[name] = fields["call_knn_launches"]
        phase("bf16-eager", card=card, config=name, bars=BF16_EAGER_BARS, **fields,
              call_ms_float32=f32_ms, **train)
        del model, cpu
        torch.cuda.empty_cache()

    root = REPO / "outputs" / "chip_smoke_train_bf16_eager"
    cli_dataset(torch, root)
    config = cli_config(root, BF16_EAGER_CLI_STEPS, VARIANTS["V1"])
    args = train_diffusion.parser().parse_args(
        ["in-code", "--device", "cuda", "--logdir", str(root / "logs"), "--max_protein",
         str(MAX_PROTEIN), "--max_ligand", "40", "--train_report_iter", "1", "--dtype", "bf16"])
    reset_train_counts()
    t0 = time.perf_counter()
    res = train_diffusion.run(config, args)
    seconds = time.perf_counter() - t0
    # one graph a train step and a validation call (10 timesteps per batch of
    # the two-entry test split, one batch, at each val_freq = 2 iterations)
    n_val = BF16_EAGER_CLI_STEPS // 2 * 10
    cli_knn = knn_only("bf16-eager train-cli", BF16_EAGER_CLI_STEPS + n_val)
    log = (Path(res["log_dir"]) / "log.txt").read_text()
    if "training path: eager; model dtype: torch.bfloat16" not in log:
        raise AssertionError("bf16-eager train-cli: the CLI did not train the bf16 model eagerly")
    if not res["checkpoints"] or not np.isfinite(list(res["metrics"].values())).all():
        raise AssertionError(f"bf16-eager train-cli: checkpoints {res['checkpoints']}, "
                             f"metrics {res['metrics']}")
    with np.load(res["checkpoints"][-1]) as z:
        dtypes = sorted({str(z[k].dtype) for k in z.files if z[k].dtype.kind == "f"})
    if dtypes != ["float32"]:
        raise AssertionError(f"bf16-eager train-cli: checkpoint arrays of {dtypes}")
    launches["train_cli"] = cli_knn
    phase("bf16-eager train-cli", card=card, config="V1", steps=BF16_EAGER_CLI_STEPS,
          seconds=seconds, checkpoint=Path(res["checkpoints"][-1]).name,
          checkpoint_dtypes=dtypes, knn_launches=cli_knn, best_val=res["best_val"],
          last_metrics=res["metrics"])
    return launches


def prop_batch(torch, dev, seed=0):
    """PROP_B synthetic complexes (data/synth.py) at train_prop's default
    padding (PROP_PROTEIN + PROP_LIGAND slots), ligand features the one-hot
    of the atom type in the prop width, kinds round-robin, pK ~ N(6, 1)."""
    from targetdiff_tpu_torch.data.synth import synth_batch
    from targetdiff_tpu_torch.models.prop.prop_model import PropBatch

    rng = np.random.default_rng(seed)
    b = synth_batch(rng, PROP_B, max_protein=PROP_PROTEIN, max_ligand=PROP_LIGAND,
                    n_protein_range=(380, PROP_PROTEIN + 1), n_ligand_range=(20, 60), device=dev)
    lfeat = torch.nn.functional.one_hot(b.ligand_v, PROP_LIG_DIM).float()
    y = torch.tensor(rng.normal(6.0, 1.0, PROP_B), dtype=torch.float32, device=dev)
    kind = torch.arange(PROP_B, device=dev) % 3 + 1
    return PropBatch(b.protein_pos, b.protein_feat, b.protein_mask, b.ligand_pos, lfeat,
                     b.ligand_mask, y, kind)


def prop_phases(torch, dev, model, batch) -> dict:
    """[prop]: PropPredNet at configs/prop/pdbbind_general_egnn.yml's width
    (hidden 256, 6 layers, 64 RBF knots, K = 48) on PROP_B synthetic
    complexes (N = 608): its kNN graph from `knn_rounds_kernel`, bitwise
    equal to knn_graph_exact and timed beside its bound and torch.topk; the
    forward on the card against the CPU on the first PROP_CPU_ROWS complexes
    at PROP_REL, one kNN launch, timed (the kNN kernel's share of its device
    time); the first `prop_loss_fn` loss and gradient norm on those
    complexes against the CPU's with the same injected noise at
    PROP_STEP_REL; Adam steps of `prop_loss_fn` (one launch each), loss finite, ms
    per step, peak GiB. [prop-enc]: PropPredNetEnc at the
    final_h config's width fed the flagship's final_h from `fetch_embedding`
    on the block kernels, against the same model fed the eager final_h, at
    H_TOL. Returns the K = 48 fields and the prop training's launches."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.models.prop.prop_model import PropBatch, prop_loss_fn
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.utils import train as train_utils
    from targetdiff_tpu_torch.utils.misc_prop import get_prop_model

    pb = prop_batch(torch, dev)
    x = torch.cat([pb.protein_pos, pb.ligand_pos], 1)
    mask = torch.cat([pb.protein_mask, pb.ligand_mask], 1)
    rounds = knn_fields(torch, x, mask, PROP_K)
    torch.manual_seed(11)
    prop = get_prop_model(Config(PROP_MODEL), pb.protein_feat.shape[-1], PROP_LIG_DIM).to(dev)
    cpu = get_prop_model(Config(PROP_MODEL), pb.protein_feat.shape[-1], PROP_LIG_DIM)
    cpu.load_state_dict({k: v.cpu() for k, v in prop.state_dict().items()})

    def forward():
        with torch.no_grad():
            return prop(pb)

    kknn.LAUNCHES = 0
    got = forward()
    torch.cuda.synchronize()
    fwd_launches = kknn.LAUNCHES
    with torch.no_grad():
        want = cpu(PropBatch(*[t[:PROP_CPU_ROWS].cpu() for t in pb[:8]]))
    scale = float(want.abs().max())
    err = float((got[:PROP_CPU_ROWS].cpu() - want).abs().max())
    if fwd_launches != 1 or not err <= PROP_REL * scale or not bool(got.isfinite().all()):
        raise AssertionError(f"prop: forward {got[:PROP_CPU_ROWS]} against the CPU's {want} "
                             f"(err {err}, scale {scale}); kNN launches {fwd_launches}")
    fwd_ms, fwd_split = cuda_ms(torch, forward, reps=5), kernel_split(torch, forward)

    # the first prop_loss_fn step on the first PROP_CPU_ROWS complexes, with
    # the same injected noise on both sides: loss and gradient norm
    def first_step(m, b, noise):
        m.train()
        m.zero_grad()
        loss, _ = prop_loss_fn(m, b, PROP_TRAIN["pos_noise_std"], noise=noise)
        loss.backward()
        grad_norm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in m.parameters()
                                   if p.grad is not None))
        m.zero_grad()
        return float(loss.detach()), float(grad_norm)

    sub = PropBatch(*[t[:PROP_CPU_ROWS] for t in pb[:8]])
    ngen = torch.Generator(device=dev).manual_seed(14)
    noise = (torch.randn(sub.protein_pos.shape, generator=ngen, device=dev),
             torch.randn(sub.ligand_pos.shape, generator=ngen, device=dev))
    first = first_step(prop, sub, noise)
    cpu_first = first_step(cpu, PropBatch(*[t.cpu() for t in sub[:8]]),
                           tuple(n.cpu() for n in noise))
    first_rel = [abs(a - b) / abs(b) for a, b in zip(first, cpu_first)]
    if not (np.isfinite(first).all() and max(first_rel) <= PROP_STEP_REL):
        raise AssertionError(f"prop: first (loss, grad norm) {first} against the CPU's "
                             f"{cpu_first} (rel {first_rel})")
    optimizer = train_utils.get_optimizer(
        Config(dict(PROP_TRAIN["optimizer"], max_grad_norm=PROP_TRAIN["max_grad_norm"])),
        prop.parameters())
    gen = torch.Generator(device=dev).manual_seed(12)

    def train_step():
        optimizer.zero_grad()
        loss, _ = prop_loss_fn(prop, pb, PROP_TRAIN["pos_noise_std"], generator=gen)
        loss.backward()
        optimizer.step()
        return loss.detach()

    prop.train()
    for _ in range(PROP_WARMUP):
        train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kknn.LAUNCHES = 0
    t0 = time.perf_counter()
    losses = [train_step() for _ in range(PROP_STEPS)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / PROP_STEPS
    train_launches = kknn.LAUNCHES
    losses = [float(v) for v in losses]
    step_split = kernel_split(torch, train_step, calls=2)
    if train_launches != PROP_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"prop: kNN launches {train_launches} (want {PROP_STEPS}), "
                             f"losses {losses}")
    enc_cfg = PROP_MODEL["encoder"]
    phase("prop", shape=f"B={PROP_B},N={PROP_PROTEIN + PROP_LIGAND},K={PROP_K},"
          f"L={enc_cfg['num_layers']},H={enc_cfg['hidden_dim']}",
          knn=rounds, knn_share_of_forward=rounds["device_ms"] / fwd_split["device_ms"],
          cpu_rows=PROP_CPU_ROWS, max_abs_err=err, scale=scale, forward_ms=fwd_ms,
          forward_device_ms=fwd_split["device_ms"],
          forward_kernel_launches=fwd_split["launches"], forward_top_kernels=fwd_split["top"],
          forward_knn_launches=fwd_launches, first_loss=first[0], cpu_first_loss=cpu_first[0],
          first_grad_norm=first[1], cpu_first_grad_norm=cpu_first[1],
          first_rel_err=first_rel, step_top_kernels=step_split["top"],
          step_device_ms=step_split["device_ms"], losses=losses,
          ms_per_step=ms, complexes_per_s=1e3 * PROP_B / ms, peak_gib=peak_gib(torch),
          knn_launches=train_launches)
    del prop, cpu, optimizer

    # [prop-enc]: the flagship's final_h on the kernels and eagerly
    fast = model.fetch_embedding(batch, impl="fast")["final_h"]
    eager = model.fetch_embedding(batch, impl="eager")["final_h"]
    eb = PropBatch(batch.protein_pos, batch.protein_feat, batch.protein_mask, batch.ligand_pos,
                   torch.nn.functional.one_hot(batch.ligand_v, PROP_LIG_DIM).float(),
                   batch.ligand_mask, torch.zeros(batch.num_graphs, device=dev),
                   torch.ones(batch.num_graphs, dtype=torch.long, device=dev))
    torch.manual_seed(13)
    enc = get_prop_model(Config(PROP_ENC_MODEL), batch.protein_feat.shape[-1],
                         PROP_LIG_DIM).to(dev).eval()
    kknn.LAUNCHES = 0
    with torch.no_grad():
        out_fast = enc(eb._replace(enc_node_feat=fast))
        out_eager = enc(eb._replace(enc_node_feat=eager))
    torch.cuda.synchronize()
    enc_err = check_close("prop-enc", out_fast, out_eager, **H_TOL)
    if kknn.LAUNCHES != 2 or fast.shape[-1] != PROP_ENC_MODEL["enc_node_dim"]:
        raise AssertionError(f"prop-enc: kNN launches {kknn.LAUNCHES}, final_h {fast.shape}")

    def enc_forward():
        with torch.no_grad():
            return enc(eb._replace(enc_node_feat=fast))

    phase("prop-enc", shape=f"B={batch.num_graphs},N={fast.shape[1]},K={PROP_K},"
          f"L={enc_cfg['num_layers']},H={enc_cfg['hidden_dim']}",
          enc_node_dim=fast.shape[-1], pred=out_fast.tolist(), max_abs_err=enc_err,
          ms=cuda_ms(torch, enc_forward, reps=5))
    return {"rounds": rounds, "train": train_launches}


def prop_cli_phase(torch, dev) -> dict:
    """[prop-cli]: a PDBBind-style tree of PROP_CLI_COPIES copies of
    examples/3ug2 through `pdbbind_preparation` (pockets, then a random 16 /
    16 split), `train_prop` for one epoch of the full-width config,
    `eval_prop` on its checkpoint and `inference_prop` on examples/3ug2; the
    checkpoint reloads into a fresh model with bitwise the trained model's
    predictions."""
    from targetdiff_tpu_torch.cli import (eval_prop, inference_prop, pdbbind_preparation,
                                          train_prop)
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.datasets import get_dataset
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.utils.checkpoint import load_checkpoint

    root = REPO / "outputs" / "chip_smoke_prop_cli"
    shutil.rmtree(root, ignore_errors=True)
    src = root / "pdbbind"
    lines = []
    for i in range(PROP_CLI_COPIES):
        pid = f"{i:02d}g2"
        (src / pid).mkdir(parents=True)
        for part, ext in (("protein", "pdb"), ("ligand", "sdf")):
            shutil.copyfile(REPO / "examples" / f"3ug2_{part}.{ext}",
                            src / pid / f"{pid}_{part}.{ext}")
        kind = ("Kd=3.2nM", "Ki=10uM", "IC50=4mM")[i % 3]
        lines.append(f"{pid}  2.10  2012   {8.49 - 0.1 * i:.2f}  {kind}  // 3ug2 copy")
    (root / "INDEX_general_PL_data").write_text("\n".join(lines) + "\n")
    dest = root / "prepared"
    kknn.LAUNCHES = 0
    t0 = time.perf_counter()
    pdbbind_preparation.main(["pockets", "--root", str(src), "--index",
                              str(root / "INDEX_general_PL_data"), "--dest", str(dest),
                              "--num_workers", "1"])
    pdbbind_preparation.main(["split", "--index_pkl", str(dest / "index.pkl"), "--dest",
                              str(root / "split.pt"), "--test_frac", "0.5"])
    prep_s = time.perf_counter() - t0
    config = Config(dict(data=dict(name="pdbbind", path=str(dest / "index.pkl"),
                                   split=str(root / "split.pt")),
                         model=PROP_MODEL, train=dict(PROP_TRAIN, max_epochs=1)))
    pad = ["--max_protein", str(PROP_CLI_PROTEIN), "--max_ligand", str(PROP_LIGAND)]
    t0 = time.perf_counter()
    out = train_prop.run(config, train_prop.parser().parse_args(
        ["unused.yml", "--logdir", str(root / "logs"), "--device", "cuda", *pad]))
    train_s = time.perf_counter() - t0
    if out["iterations"] != 1 or len(out["checkpoints"]) != 1:
        raise AssertionError(f"prop-cli: train_prop ran {out['iterations']} steps, wrote "
                             f"{out['checkpoints']}")
    ck = out["checkpoints"][0]
    ev = eval_prop.run(eval_prop.parser().parse_args([ck, "--device", "cuda", *pad]))
    pk = inference_prop.run(inference_prop.parser().parse_args(
        [ck, "--protein", str(REPO / "examples" / "3ug2_protein.pdb"), "--ligand",
         str(REPO / "examples" / "3ug2_ligand.sdf")]))
    fresh = train_prop.build_model(config.model, dev)
    fresh.load_state_dict(load_checkpoint(ck, device=dev)["state_dict"])
    _, subsets = get_dataset(config.data, transform=train_prop.prop_transform())
    vb = next(train_prop.batches(subsets["test"], 16, PROP_CLI_PROTEIN, PROP_LIGAND, None, dev))
    with torch.no_grad():
        same = torch.equal(fresh.eval()(vb), out["model"].eval()(vb))
    numbers = list(ev["overall"].values()) + [pk] + list(out["scores"].values())
    if not same or ev["n"] != 16 or not np.isfinite(numbers).all():
        raise AssertionError(f"prop-cli: reload equal {same}, eval {ev}, pK {pk}")
    phase("prop-cli", complexes=PROP_CLI_COPIES, split="16/16", prep_seconds=prep_s,
          train_seconds=train_s, val=out["scores"], eval=ev["overall"], eval_n=ev["n"],
          inference_pk=pk, reload_bitwise=same, knn_launches=kknn.LAUNCHES)
    return {"knn": kknn.LAUNCHES}


def prop_gate_short_phase(torch, dev) -> None:
    """[prop-gate-short]: the port's prop gate at PROP_GATE_SHORT's size on
    the card: its report must be complete and finite, its checks need not
    pass."""
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.tools import prop_quality_gate as pg

    kknn.LAUNCHES = kblock.LAUNCHES = kblock.TRAIN_LAUNCHES = 0
    t0 = time.perf_counter()
    report = pg.run_prop_gate(PROP_GATE_SHORT["epochs"], PROP_GATE_SHORT["diff_steps"], dev,
                              log=lambda _: None)
    wall = time.perf_counter() - t0
    launches = {"knn": kknn.LAUNCHES, "block": kblock.LAUNCHES,
                "train_fwd": kblock.TRAIN_LAUNCHES}
    scores = [report[k] for k in ("untrained", "trained", "enc_untrained", "enc_trained")]
    numbers = [v for s in scores for v in s.values()] + [report["nll_distortion_auroc"],
                                                         report["nll_intact_mean"]]
    if (len(report["checks"]) != 6 or len(report["per_kind"]) != 3
            or not np.isfinite(numbers).all()
            or launches["train_fwd"] != PROP_GATE_SHORT["diff_steps"] or not launches["block"]):
        raise AssertionError(f"prop-gate-short: incomplete report {report}, launches {launches}")
    phase("prop-gate-short", epochs=PROP_GATE_SHORT["epochs"],
          diffusion_steps=PROP_GATE_SHORT["diff_steps"], checks=report["checks"],
          pearson=report["trained"]["pearson"], enc_pearson=report["enc_trained"]["pearson"],
          nll_auroc=report["nll_distortion_auroc"], timing=report["timing"],
          wall_seconds=wall, launches=launches)


DP_WORLD = 2  # [dp-train], [dp-sample]: ranks of the data-parallel dry run
# the launches of one rank: one `fast` train step, and 20 DDPM steps of its rows
# (sampling at its default precision, bf16: the bf16 block kernels)
DP_TRAIN_WANT = {"knn": 1, "block": 0, "block_bf16": 0, "cone": 0, "block_train": 1,
                 "block_vjp": 1}
DP_SAMPLE_WANT = {"knn": 20, "block": 0, "block_bf16": 20, "cone": 20, "block_train": 0,
                  "block_vjp": 0}


def dp_phases(torch, pocket) -> dict:
    """[dp-train] and [dp-sample]: targetdiff_tpu_torch/tools/dryrun_multi at
    full width, DP_WORLD ranks on this card over gloo (and over NCCL, one
    card a rank, when the machine has DP_WORLD cards): the B=32 train leg
    split over the ranks and 8 rows of the example pocket for 20 DDPM
    steps, each held to the one-process run of the same call (the tool's
    bars; it raises on a mismatch or a dead rank), with each rank's kernel
    launches, ms per step and the gradient all-reduce's ms and bytes.
    Returns rank 0's launches of the gloo run."""
    from targetdiff_tpu_torch.tools import dryrun_multi

    torch.cuda.empty_cache()  # the ranks share the card with this process
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= DP_WORLD else [])
    reports = {}
    for backend in backends:
        t0 = time.perf_counter()
        rep = dryrun_multi.run(DP_WORLD, "cuda", backend, pocket=pocket)
        wall = time.perf_counter() - t0
        for r, rank in enumerate(rep["ranks"]):
            for leg, want in (("train", DP_TRAIN_WANT), ("sample", DP_SAMPLE_WANT)):
                if rank[f"{leg}_launches"] != want:
                    raise AssertionError(f"dp-{leg} ({backend}): rank {r} launched "
                                         f"{rank[f'{leg}_launches']}, want {want}")
        one = rep["one_process"]
        size = dryrun_multi.FULL
        phase(f"dp-train {backend}", world=DP_WORLD, devices=rep["device"] if backend == "gloo"
              else "one card a rank", shape=f"B={size['train_b']} ({DP_WORLD}x"
              f"{size['train_b'] // DP_WORLD}),N={size['train_protein'] + size['max_ligand']},"
              f"K={K},L={FLAGSHIP['num_layers']}", one_process_ms_per_step=one["train_ms_per_step"],
              one_process_loss=one["loss"], wall_seconds=wall,
              one_process_device_ms_per_step=one["train_device_ms_per_step"],
              ranks=[{k: rank[k] for k in ("loss", "train_errs", "train_ms_per_step",
                                           "train_device_ms_per_step", "fwd_bwd_ms",
                                           "all_reduce_ms", "all_reduce_bytes", "train_launches")}
                     | {"all_reduce_share": rank["all_reduce_ms"] / rank["train_ms_per_step"]}
                     for rank in rep["ranks"]])
        phase(f"dp-sample {backend}", world=DP_WORLD,
              shape=f"rows={size['sample_rows']} ({DP_WORLD}x{size['sample_rows'] // DP_WORLD}),"
              f"steps={size['sample_steps']},NP={len(pocket['protein_pos'])}",
              one_process_ms_per_step=one["sample_ms_per_step"],
              ranks=[{k: rank[k] for k in ("sample_pos_err", "sample_ms_per_step",
                                           "sample_launches")} for rank in rep["ranks"]])
        reports[backend] = rep
    if len(backends) == 1:
        phase("dp nccl", skipped=f"{torch.cuda.device_count()} card(s): NCCL takes one card a "
              "rank")
    rank0 = reports["gloo"]["ranks"][0]
    return {k: {"train": rank0["train_launches"][k], "sample": rank0["sample_launches"][k]}
            for k in DP_TRAIN_WANT}


def prop_gate(torch, argv) -> int:
    """The `prop-gate [EPOCHS] [DIFF_STEPS]` mode (module docstring)."""
    if len(argv) > 2 or not all(a.isdigit() for a in argv):
        raise SystemExit("usage: chip_smoke.py prop-gate [EPOCHS] [DIFF_STEPS]")
    epochs = int(argv[0]) if argv else PROP_GATE["epochs"]
    diff_steps = int(argv[1]) if len(argv) > 1 else PROP_GATE["diff_steps"]
    sys.path.insert(0, str(REPO))
    from targetdiff_tpu_torch.ops.kernels import build
    from targetdiff_tpu_torch.tools import prop_quality_gate as pg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = pg.run_prop_gate(epochs, diff_steps, torch.device("cuda:0"),
                              log=lambda line: print(line, flush=True))
    report["timing"].update(build_seconds=build_s, wall_seconds=time.perf_counter() - t0,
                            card=card)  # the card beside its times
    report.update(card=card, device={"kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()})
    (REPO / "prop_quality_gate_torch.json").write_text(json.dumps(report, indent=1) + "\n")
    failed = [k for k, ok in report["checks"].items() if not ok]
    print(json.dumps({"card": card, "checks": report["checks"], "timing": report["timing"],
                      **{k: report[k] for k in ("trained", "enc_trained",
                                                "nll_distortion_auroc")}}), flush=True)
    print("PROP GATE", "FAIL: " + ", ".join(failed) if failed else "ok", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
