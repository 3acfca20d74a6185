#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``wordgesture_gan_tpu_torch/csrc``
   (one nvcc per source, started together) and print ptxas' register report
   and the tensor-core and float32 kernels' (inference and training) shared
   memory and CTAs per SM;
3. hold each kernel against its plain PyTorch version on the card at the
   flagship generator's full width (4 layers, H=48, L=128, Z=32) for
   B in {1, 7, 8, 9, 131, 512, 2048} (around the 8- and 4-sample tiles),
   float32 with TF32 off and bfloat16:
   kernel 4 (exact batched DTW, float32 only): aligned pairs at P in
   {1, 131, 8192}, D in {2, 3}, L=128 on gesture-like walks, the matrix entry
   at 64x64, 37x13, a short length and L=1 against the plain version and
   against aligned pairs, and four pairs against a float64 recurrence on
   the host, each distance relative to its own size, 1e-4; and aligned pairs
   at L=64, D=2, the realism report's shape;
   kernel 1 (inference forward): 1e-4 / 2e-2 abs; every full-width call must
   have taken the tensor-core kernel (bfloat16) or the float32 cluster kernel
   (launches counted per path), two launches on the same inputs give
   bit-equal outputs, and a stack at H=8 holds the general-shape kernel
   against the plain version too;
   kernels 2 and 3 (training forward with residuals, backward through
   time): the output, every residual plane and every gradient (dW_ih,
   dW_hh, db, dz, dx), each as max |err| / max |want|, 1e-4 / 2e-2; kernel
   3 and its plain version read kernel 2's residuals; kernel 2's output
   agrees with kernel 1's within kernel 1's tolerance (the two sum in
   different orders; in float32 the two run one recurrence and must be
   bit-equal); the bfloat16 calls must have taken the tensor-core kernels
   and the float32 calls the float32 cluster kernels (launches counted per
   path), and a stack at H=8 holds the general training pair against its
   plain version in both dtypes; two launches of kernel 3 on the same inputs
   give bit-equal gradients; the small PyTorch launches each wrapper adds
   around its kernels are counted under torch.profiler and printed;
4. serve gestures through the entry point a user calls,
   ``wordgesture_gan_tpu_torch.generate.main``: seeded random full-width
   weights written as a JAX-layout npz, 8192 gestures over a word list at
   --batch 512, bfloat16, monotone time head. The output must be (N, 128, 3),
   finite, |x|, |y| <= 1, t monotone from 0 to 1, and kernel 1's launch
   counts (set to 0 just before) must show the run went through it, every
   launch on the tensor-core path. A small
   batch with injected noise is then compared with the CPU's plain path,
   and one sampling call is profiled;
4b. serve the MLP and the transformer generators the same way
   (``generate.main --generator mlp|transformer``, full width, bf16, 8192
   gestures, batch 512): shape, range and clock checked, no BiLSTM kernel
   launched (their layers are matrix products and the bias kernel), a small
   batch with injected noise
   against the CPU, one sampling call profiled;
5. train through ``train.gan_loop.train_gan(..., device="cuda")``: the
   flagship recipe (bf16, batch 512, n_critic 5, λ_speed 2, λ_div 0.3,
   λ_dtc 4) on 4096 smoke gestures made in numpy from keyboard prototypes,
   2 epochs of 8 steps with a checkpoint each, then a resumed third epoch
   with every launch count set to 0 just before: 5 kernel-1, 3 kernel-2 and
   3 kernel-3 launches per step, all on the tensor-core paths; losses
   finite; one steady step profiled;
5b. the same in float32 (``compute_dtype="float32"``, as ``train_cli
   --precision float32``): 5/3/3 launches per step, all on the float32
   paths; ms per step and one steady step profiled;
5c, 5d. phases 5 and 5b with ``RuntimeConfig(scan_epoch=True)``: each epoch
   through ``gan_train_epoch``, the step captured once as a CUDA graph and
   replayed once per batch; the same checkpoints, resume and launch counts
   (a replay adds the launches its capture counted), ms per step beside
   the eager phase's; one replay profiled (device busy, idle share, events);
5e-5g. from two copies of one state and its random key, two epochs of
   3 batches of 512 through one captured graph against the same steps run
   eagerly: flagship bf16 (5e), float32 (5f) and the masked transformer
   step (5g, ``gan_train_epoch_masked``): traces, every state tensor, Adam's
   counts and the key bit-equal, the critics' u vectors moving across
   replays, kernels 1-3 counted 5/3/3 a step (none in 5g); 5f runs with
   ``torch.backends.cudnn.deterministic``, since cuDNN's float32 convolution
   backward is not run-to-run deterministic even eagerly (measured each
   run: two eager float32 epochs, cuDNN as trained); before them,
   ``apply_update``'s two forms (Python numbers, device tensors) bit-equal;
   phases 5-5d also count the threefry kernel's launches in the resumed
   epoch: one a step (its noise) and one a round of the epoch's shuffle;
5h. the JAX package's random draws (``csrc/threefry.cu``, ``utils/prng.py``):
   the kernel against its plain version on the same keys (bits and uniforms
   bit-equal, normals within 1 ulp) at a flagship step's draw (14 keys x
   512 x 32), (5, 512, 32), the shuffle's 20,331 sort keys, an
   initializer's uniforms and two odd shapes, timed beside the plain
   version (host), ``torch.randn`` (another generator, a yardstick) and the
   bound; ``init_gan_state(42)`` at full width and one step's draws on the
   card against the CPU; the graphed flagship bf16 step from that state,
   untraced, beside eager, with one threefry launch a replay;
5i. ``models/layers.py``'s ``gelu`` and ``leaky_relu`` (JAX's arithmetic:
   each op rounded in the array's dtype, the constants rounded to it) on
   the card, through the kernels of ``csrc/activations.cu`` (and
   ``F.leaky_relu`` for leaky_relu's forward), against the CPU's plain
   chain and against the plain chain on the card, forward and gradient, bit
   for bit, on all 65,536 bfloat16 inputs and 2^20 float32 ones; each
   activation and direction timed at the transformer's critic-loop call
   (1024, 128, 256) bfloat16 beside the plain chain and its bound;
5l. three graphed steps each of the ``flag`` and ``varlen2`` recipes (bf16,
   B=512) from one state, once as shipped and once with the activations
   patched to the plain functions: losses and every state tensor
   bit-equal; the shipped steps call the kernels on every activation (no
   plain call), the masked step (n_critic + 2) x layers gelu forwards and
   2 x layers backwards a step, as many attention calls each way, all
   through ``csrc/attention.cu``, and 2 x layers + 1 times as many layer
   norm calls each way (63 forwards, 18 backwards), all through
   ``csrc/layernorm.cu``;
5m. the transformer's attention core (``ops/attention.py``, the kernels of
   ``csrc/attention.cu``) against the plain chain on the card, forward and
   dq, dk, dv, at the masked step's calls (B = 1024 and 512, L = 128, four
   heads of 16, the cell's masks), at head 8, in float32 and at lengths and
   heads around the kernels' tiles (L from 1 to 256, h from 8 to 64), with
   two float8 controls that must fail; two backward launches bit-equal;
   each direction timed at the step's calls beside its bound, the plain
   chain and ``F.scaled_dot_product_attention``;
5n. the transformer's layer norm (``ops/layernorm.py``, the kernels of
   ``csrc/layernorm.cu``) against the plain chain on the card, the output,
   dx, dscale and dbias, at the masked step's calls (131,072 and 65,536
   rows of D = 64 in bfloat16 and float32) and at odd and wide D (1 to
   1024), with a float8 control that must fail; two launches bit-equal; a
   float16 tensor refused; each call timed beside its bound in bytes, the
   plain chain and ``F.layer_norm``;
5o. the models' bias adds (``ops/bias.py``, the kernel of ``csrc/bias.cu``)
   against the plain chain of adds on the card, bit for bit: the output and
   its layout, dy, db and the residual's cotangent, at the masked step's
   calls (65,536 and 131,072 tokens of 64, 192 and 256 features in
   bfloat16, the float32 (T, 3) output head, the critics' channel-first
   conv outputs, the (L, D) positions, the residual adds) and at unaligned,
   small, odd and empty shapes; two launches bit-equal; a float16 tensor and
   a b of another dtype refused; each call timed beside its bound in bytes
   and the plain chain; three graphed steps of the flag and varlen2 recipes
   with the kernel and with the chain patched in, bit-equal, every add of a
   step on the kernel (the masked step 239 bias adds and 56 residual adds);
5j. one bfloat16 step of the flagship recipe and one masked bfloat16 step
   (the transformer, lambda_speed 2) on the card against the CPU (B=32, full
   width), each model's gradient distance and each loss within
   BF16_CONTROL_FACTOR times the CPU's own distance from a step taken from
   the state nudged by one float32 rounding step, plus BF16_FLOOR;
5k. measured, not checked: cuDNN's float32 convolutions at the temporal
   critic's shapes with TF32 allowed and not (against float64), the float32
   step against the CPU with the global TF32 flag on (the step runs under
   ``layers.jax_products()``, which turns it off), the bf16 products of the
   steps with ``allow_bf16_reduced_precision_reduction`` on and off, and one
   bf16 step of each kind with that flag on and off;
6. one step on the card against the CPU's plain path from the same state,
   batch and injected noise (B=32, full width, float32, n_critic 5), for
   the reference recipe and the flagship one: losses, the gradients (Adam
   moments after a step at lr=0) and the parameters after a step at
   lr=2e-4, with the tolerances stated at STEP_RECIPES; kernels 2 and 3 of
   the card's steps counted on their float32 path (4-sample tiles);
7. evaluate through the entry points a user calls: the synthetic corpus
   (480 users: 8744 gestures to train on, 2170 to test on), a smoke
   generator trained for 2 epochs through ``train_cli.main`` (flagship
   recipe), then ``eval_cli.main --model both --n-samples 2000`` at full
   width with DTW on — 4·10^6 pairs through kernel 4 for the generator and
   again for the minimum-jerk baseline, whose pass must reuse the real side
   (``cached_real``); the FID autoencoders train 5 epochs instead of 100.
   Every metric finite, precision and recall in [0, 1], FID >= 0,
   DTW-Wasserstein > 0, launches counted from 0 (2 kernel-4, 4 kernel-1 on
   its float32 path);
   4096 sampled entries of the DTW matrix no larger than their diagonal
   path's cost; a small evaluation (n=64) on the card against the CPU; the
   suite profiled once;
7b. on the same corpus, ``train_cli.main --variable-length`` (the masked
   transformer step, bf16, batch 512) for 2 epochs, checkpointed, losses
   finite, one steady masked step profiled;
7b'. ``train_variable_gan`` with ``RuntimeConfig(scan_epoch=True)`` on 7b's
   corpus and recipe: 2 epochs checkpointed, losses finite, ms per step
   beside 7b's, one replay profiled;
7c. one float32 masked step (full-width transformer, B=32, n_critic 5, a mask
   of varied lengths) on the card against the CPU from the same state and
   injected noise, with phase 6's tolerances;
7d. ``eval_cli.main --variable-length --n-samples 2000`` on 7b's checkpoint,
   DTW on: masked sampling, resampling onto the 128-point grid on the card
   (held against the CPU's, 1e-4), the suite; launches counted from 0: one
   kernel-4 matrix of 4·10^6 pairs, no BiLSTM kernel; every metric finite,
   precision and recall in [0, 1], DTW-Wasserstein > 0;
7e. ``eval_cli.main --large-scale 100000`` on phase 7's generator, corpus and
   cached FID autoencoder: 10⁵ gestures through kernel 1 (launches counted
   from 0: 196, every one on its float32 path), then sliced W2, energy
   distance, the Sinkhorn matched cost (raw and extrapolated), chunked k-NN
   precision/recall and FID; every metric finite, precision and recall in
   [0, 1]; stage seconds and peak device memory; the k-NN pass and one
   Sinkhorn solve profiled;
7f. ``evaluate_large_scale`` at n = 2048 (real test gestures, generated
   ones) with injected draws and one FID autoencoder, on the card against
   the CPU, with the tolerances stated at LARGE_TOL;
7g. the contrastive encoder on the same corpus: ``train_contrastive_cli.main``
   for 2 epochs, then a third resumed from its checkpoint (epoch and step
   counters carried over), then ``eval_contrastive_cli.main --centroids
   --query <a test word>``; losses finite, recall@k, mAP and the centroid
   table in [0, 1]; seconds per epoch and steps per epoch;
7h. one contrastive train step (float32, 32 words x 2 gestures, L=128) on
   the card against the CPU from the same weights and batch: loss,
   gradients, BatchNorm running statistics and parameters, with the
   tolerances stated at CONTRASTIVE_TOL;
8. time kernel 1 (at B=512 and at the train step's 2B=1024; in float32 also
   with the sample tile the dispatch rule does not pick at that batch),
   kernels 2 and 3 (in float32 also the general kernels on the same inputs;
   a few profiled calls of the pair per dtype at one layer and at full
   depth, and of the general float32 pair at full depth, which split
   kernel 3 into its passes), their plain versions and cuDNN
   ``torch.nn.LSTM`` on the same weights (a yardstick the port never calls;
   the training yardstick is its float32 forward and backward) at B=512 in
   bfloat16 and float32 with CUDA events, beside each kernel's bound; time
   kernel 4 at 2000 x 2000 pairs in one launch beside its plain version over
   the same pairs and its bound (no PyTorch call computes DTW), at D=2 as
   the evaluation calls it and at D=3.

Then, run before phase 8's timings:

9a. ``train_cli.main`` as the one rank of an NCCL process group
   (``WGG_DISTRIBUTED=1``) on phase 7's corpus (its first 120 logs: 5 steps
   of 512), flagship recipe, bf16: one epoch with ``--profile-dir``, then a
   resumed one with every count set to 0 just before: 11 gradient
   all-reduces per step (one per gradient computation), kernels 1-3 5/3/3
   per step on their tensor-core paths, rank 0's checkpoints, a trace that
   names the kernels; ms per step beside phase 5's;
9a'. a third epoch of 9a, resumed, with ``RuntimeConfig(scan_epoch=True)``:
   the step and its 11 all-reduces captured as one CUDA graph, the same
   counts (all-reduces and kernels, per capture times the replays), ms per
   step beside 9a's; one replay under the group profiled; phase 5e's
   graphed-vs-eager check under the group, bit-equal;
9b. two ranks sharing the card (gloo; NCCL refuses two ranks on one GPU),
   started as ``chip_smoke.py --dp-worker``: a float32 full-width
   ``gan_train_step`` (reference recipe) at global B=32 and a contrastive
   step at 32 words x 2 (each word's gestures on different ranks), against
   one process on the card, with the tolerances stated at DP_TOL; 11 and 1
   gradient all-reduces;
10. ``python -m wordgesture_gan_tpu_torch.data.realism --users 200`` with
   ``--device cpu`` and on the card (kernel 4 once, at L=64, D=2, launches
   counted from 0): the four exact statistics equal, ``dtw_w`` within 1e-4;
   kernel 4 on the report's own pairs against its plain version, and timed;
11. seeded full-width weights in the reference implementation's layout
   through ``interop.torch_weights.trainer_state_from_torch`` (the same trees
   back), saved as a checkpoint and served through ``generate.main
   --checkpoint-dir`` (bf16, 512 gestures, one kernel-1 launch), a small
   batch with injected noise against the CPU;
12. ``tools/port_quality_runs.py --runs flag`` on phase 9a's corpus (the
   first 120 logs of phase 7's) cut to 2 epochs, FID autoencoders 5 epochs:
   the flagship recipe through ``train_cli.main(..., scan_epoch=True)``,
   then ``eval_cli.main --model both``, then the report against the JAX
   package's committed runs. Launches counted from 0 just before: kernels
   1-3 5/3/3 a step of the training call, on their tensor-core paths, and
   in all what the runner recorded per call; ``results.json`` written with
   both columns, the bands and the checks.

Output: check, timing and profile lines as JSON, then the kernel table as
one JSON line ({"kernels": [...]}), then the nvidia-smi line, then as the
last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from wordgesture_gan_tpu_torch import (eval_cli, eval_contrastive_cli, generate, train_cli,
                                       train_contrastive_cli)
from wordgesture_gan_tpu_torch.cli_common import load_split, resolve_dataset_zip
from wordgesture_gan_tpu_torch.configs import (ContrastiveConfig, EvaluationConfig, ModelConfig,
                                               RuntimeConfig, TrainingConfig)
from wordgesture_gan_tpu_torch.data.contrastive import create_contrastive_datasets
from wordgesture_gan_tpu_torch.data.pipeline import GestureArrays, load_dataset_from_zip
from wordgesture_gan_tpu_torch.data.variable_length import (create_variable_split,
                                                            load_variable_dataset_from_zip)
from wordgesture_gan_tpu_torch.interop.from_jax import write_generator_npz
from wordgesture_gan_tpu_torch.keyboard import QWERTYKeyboard
from wordgesture_gan_tpu_torch.losses import supervised_contrastive_loss
from wordgesture_gan_tpu_torch.metrics.fid import load_or_train_fid_autoencoder
from wordgesture_gan_tpu_torch.metrics.large_scale import (chunked_knn_precision_recall,
                                                           evaluate_large_scale)
from wordgesture_gan_tpu_torch.metrics.suite import evaluate_all_metrics
from wordgesture_gan_tpu_torch.models.contrastive import (contrastive_encoder_apply,
                                                          contrastive_encoder_init)
from wordgesture_gan_tpu_torch.models.gan import generator_init
from wordgesture_gan_tpu_torch.models import contrastive as contrastive_models
from wordgesture_gan_tpu_torch.models import gan as gan_models, generators, layers
from wordgesture_gan_tpu_torch.models.layers import gelu, leaky_relu
from wordgesture_gan_tpu_torch.ops.assignment import matched_mean_distance, sinkhorn_matching_cost
from wordgesture_gan_tpu_torch.ops import activations, build as kernel_build
from wordgesture_gan_tpu_torch.ops.activations import activation_launches
from wordgesture_gan_tpu_torch.ops import attention as attention_ops
from wordgesture_gan_tpu_torch.ops.attention import attention_launches
from wordgesture_gan_tpu_torch.ops import layernorm as layernorm_ops
from wordgesture_gan_tpu_torch.ops.layernorm import layernorm_launches
from wordgesture_gan_tpu_torch.ops import bias as bias_ops
from wordgesture_gan_tpu_torch.ops.bias import bias_launches
from wordgesture_gan_tpu_torch.ops import bilstm_fused, bilstm_train
from wordgesture_gan_tpu_torch.ops.bilstm_fused import (fused_bilstm_fwd, fused_bilstm_fwd_plain,
                                                        fused_kernel_info, sample_tile)
from wordgesture_gan_tpu_torch.ops.bilstm_train import (bilstm_train_bwd, bilstm_train_bwd_plain,
                                                        bilstm_train_fwd, bilstm_train_fwd_plain,
                                                        fp32_kernel_info, kernel_path,
                                                        mma_kernel_info)
from wordgesture_gan_tpu_torch.ops.dtw import dtw_matrix, dtw_pairs, dtw_pairs_plain
from wordgesture_gan_tpu_torch.ops.resample import batched_arclength_resample
from wordgesture_gan_tpu_torch.ops.stats import pairwise_l2
from wordgesture_gan_tpu_torch.parallel.distributed import free_port
from wordgesture_gan_tpu_torch.train.checkpoint import (find_checkpoint, latest_epoch,
                                                        load_generator)
from wordgesture_gan_tpu_torch.train.contrastive_loop import (contrastive_train_step,
                                                              make_contrastive_state)
from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures, train_gan
from wordgesture_gan_tpu_torch.train.gan_step import gan_train_epoch, gan_train_step
from wordgesture_gan_tpu_torch.train.masked_step import METRIC_KEYS as MASKED_METRIC_KEYS
from wordgesture_gan_tpu_torch.train.masked_step import (gan_train_epoch_masked,
                                                         gan_train_step_masked)
from wordgesture_gan_tpu_torch.train.state import MODELS, apply_update, init_gan_state
from wordgesture_gan_tpu_torch.train.step_graph import StepGraph
from wordgesture_gan_tpu_torch.train.variable_loop import train_variable_gan
from wordgesture_gan_tpu_torch.ops.threefry import threefry_draw
from wordgesture_gan_tpu_torch.train.step_graph import step_keys, step_noise
from wordgesture_gan_tpu_torch.utils import prng
from wordgesture_gan_tpu_torch.utils.chunking import chunk_layout
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves, tree_map

HIDDEN, SEQ, LAYERS, LATENT = 48, 128, 4, 32
# Around the tiles of 8 samples (tensor-core kernels) and 4 (kernel 1's float32
# kernel at a small batch), a batch no tile divides, and two and more waves.
CHECK_BATCHES = (1, 7, 8, 9, 131, 512, 2048)
TRAIN_CHECK_BATCHES = CHECK_BATCHES
# A stack off kernel 1's new paths: the general-shape kernel is still checked.
GENERAL_SHAPE = dict(hidden=8, seq=16, layers=3, latent=4, batches=(1, 37))
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE_N, SERVE_BATCH = 8192, 512
TIME_BATCH = 512
TRAIN_CALL_BATCH = 1024     # the train step's kernel-1 call: both fakes, 2B
# Training phase: the flagship recipe on smoke data (see smoke_dataset).
TRAIN_N = 4096
FLAGSHIP_TRAIN = dict(batch_size=512, n_critic=5, lambda_speed=2.0, lambda_div=0.3,
                      lambda_dtc=4.0)
# Launches per train step: kernel 1 once per critic iteration (both fakes in
# one 2B call); kernels 2 and 3 once per differentiated generator application
# (cycle 1, the second prior draw, cycle 2).
PER_STEP = {"bilstm_fused": 5, "bilstm_train_fwd": 3, "bilstm_train_bwd": 3}
# The step against the CPU: batch, learning rate, and tolerances. Losses
# 1e-4 relative to max(1, |loss|) and parameters within 2·lr per Adam step
# taken, as in the CPU parity test (tests/test_torch_train_step.py).
# Gradients (Adam's moments after a step at lr=0) relative to each leaf's
# largest: 1e-3 for the reference recipe (measured up to 1.2e-4 on an H100:
# the critics' float32 convolutions sum in another order on the card, and the
# WGAN loss is a difference of near-equal means); 1e-2 with the flagship
# auxiliaries, whose speed-profile and Pearson terms amplify float32
# rounding in G's gradient (measured up to 1.7e-3).
STEP_BATCH, STEP_LR = 32, 2e-4
STEP_LOSS_TOL = 1e-4
STEP_RECIPES = {"reference": ({}, 1e-3), "flagship": (FLAGSHIP_TRAIN, 1e-2)}
PLANES = ("h", "c", "i", "f", "g", "o")
# Peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W): HBM bytes/s,
# and FLOP/s by operand type (bf16 on the tensor cores, fp32 on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# bf16 terms a float32 gate gradient is split into for the tensor cores
# (ops/bilstm_train.py:split_hi_lo): each backward product runs that often.
BWD_SPLIT_TERMS = 2
WORDS = ("the quick brown fox jumps over lazy dog hello world gesture keyboard swipe "
         "typing model sample serve people time year good first would there their "
         "about which when make like just know take into your some could them see "
         "other than then now look only come over think also back after use two how "
         "our work well way even new want because any these give day most us").split()


def random_generator_tree(hidden: int, layers: int, latent: int, seed: int) -> dict:
    """JAX-layout generator params with PyTorch-default uniform init, from numpy."""
    rng = np.random.default_rng(seed)

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    lstm, d = [], 2 + latent
    for _ in range(layers):
        b = 1.0 / np.sqrt(hidden)
        lstm.append({direction: {"w_ih": uniform((d, 4 * hidden), b),
                                 "w_hh": uniform((hidden, 4 * hidden), b),
                                 "b_ih": uniform((4 * hidden,), b),
                                 "b_hh": uniform((4 * hidden,), b)}
                     for direction in ("fwd", "bwd")})
        d = 2 * hidden
    b = 1.0 / np.sqrt(2 * hidden)
    return {"lstm": lstm, "out": {"w": uniform((2 * hidden, 3), b), "b": uniform((3,), b)}}


def stack_on(tree: dict, device) -> list:
    return [{d: {k: torch.from_numpy(v).to(device) for k, v in layer[d].items()} for d in layer}
            for layer in tree["lstm"]]


def random_inputs(batch: int, seq: int, latent: int, seed: int, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, seq, 2)).astype(np.float32)).to(device)
    z = torch.from_numpy(rng.normal(size=(batch, latent)).astype(np.float32)).to(device)
    return x, z


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the current CUDA stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bilstm_bound_ms(batch: int, seq: int, hidden: int, layers: int, latent: int,
                    dtype: str) -> tuple:
    """Least time for the fused BiLSTM's work on an H100: (ms, "bytes" or
    "operations"). Operations: the gate products' multiply-adds, both
    directions, every step, plus the latent projection. Bytes: each input
    read once (prototype, z, weights), the output written once."""
    item = 2 if dtype == "bfloat16" else 4
    g = 4 * hidden
    flops = batch * 2 * (seq * 2 * g * (hidden + 2) + (layers - 1) * seq * 2 * g * 3 * hidden
                         + 2 * g * latent)
    weights = (2 * 2 * g + layers * 2 * hidden * g + (layers - 1) * 2 * 2 * hidden * g) * item \
        + (2 * latent * g + layers * 2 * g) * 4
    nbytes = batch * seq * 2 * item + batch * latent * 4 + weights + batch * seq * 2 * hidden * item
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def reset_launches(*wrappers) -> None:
    """Every launch count of the given kernel wrappers back to 0."""
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "launches_by_path"):
            w.launches_by_path = dict.fromkeys(w.launches_by_path, 0)


def only_path(wrapper, path: str, count: int) -> dict:
    """The per-path counts of ``wrapper`` if all ``count`` launches took ``path``."""
    return {**dict.fromkeys(wrapper.launches_by_path, 0), path: count}


def check_kernel(device, hidden=HIDDEN, seq=SEQ, layers=LAYERS, latent=LATENT,
                 batches=CHECK_BATCHES) -> list:
    """Phase 3: kernel 1 against its plain version, on the same inputs; the
    path each call took (``bilstm_fused.kernel_path``: a function of dtype and
    shape); two launches give the same bits."""
    tree = random_generator_tree(hidden, layers, latent, seed=1)
    stack = stack_on(tree, device)
    results = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        path = bilstm_fused.kernel_path(dtype, hidden, seq, layers)
        for batch in batches:
            x, z = random_inputs(batch, seq, latent, seed=batch, device=device)
            before = dict(fused_bilstm_fwd.launches_by_path)
            got = fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype)
            again = fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype)
            want = fused_bilstm_fwd_plain(stack, x, hidden, z, dtype=dtype)
            if device.type == "cuda":
                torch.cuda.synchronize()
                took = {k: fused_bilstm_fwd.launches_by_path[k] - before[k] for k in before}
                if took != only_path(fused_bilstm_fwd, path, 2):
                    raise AssertionError(f"{dtype_name} B={batch} H={hidden}: launches by path "
                                         f"{took}, expected both on {path}")
            if got.shape != (batch, seq, 2 * hidden) or got.dtype != dtype:
                raise AssertionError(f"kernel output {tuple(got.shape)} {got.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            results.append({"dtype": dtype_name, "batch": batch, "hidden": hidden, "path": path,
                            "sample_tile": sample_tile(dtype, batch) if path != "general" else 4,
                            "max_abs_err": err, "tolerance": TOLERANCE[dtype_name],
                            "bit_equal_across_two_launches": torch.equal(got, again)})
            print(json.dumps({"check": "bilstm_fused vs plain", **results[-1]}), flush=True)
            if not err <= TOLERANCE[dtype_name]:
                raise AssertionError(f"bilstm_fused disagrees with its plain version: "
                                     f"{dtype_name} B={batch} max |err| {err} > "
                                     f"{TOLERANCE[dtype_name]}")
            if not torch.equal(got, again):
                raise AssertionError(f"bilstm_fused is not deterministic: {dtype_name} B={batch}")
    return results


def check_gestures(gestures: np.ndarray, n: int, seq: int) -> None:
    if gestures.shape != (n, seq, 3):
        raise AssertionError(f"gestures shape {gestures.shape} != {(n, seq, 3)}")
    if not np.isfinite(gestures).all():
        raise AssertionError("non-finite gestures")
    if np.abs(gestures[..., :2]).max() > 1.0:
        raise AssertionError("|x|, |y| > 1")
    t = gestures[..., 2]
    if (np.diff(t, axis=1) < 0).any():
        raise AssertionError("time channel not monotone")
    if np.abs(t[:, 0]).max() != 0.0 or np.abs(t[:, -1] - 1.0).max() > 1e-5:
        raise AssertionError("time channel does not run from 0 to 1")


def serve(device, workdir: Path, n=SERVE_N, batch=SERVE_BATCH, hidden=HIDDEN, runs=2) -> dict:
    """Phase 4: the main path through the CLI entry point. The first run's
    kernel launches are counted; later runs time the steady state."""
    weights = workdir / "generator.npz"
    write_generator_npz(random_generator_tree(hidden, LAYERS, LATENT, seed=0), str(weights))
    (workdir / "run_meta.json").write_text(json.dumps({"gen_hidden_dim": hidden,
                                                       "time_head": "monotone"}))
    out = workdir / "gestures.npz"
    argv = ["--words", ",".join(WORDS), "--n", str(n), "--batch", str(batch),
            "--precision", "bfloat16", "--time-head", "monotone", "--seed", "0",
            "--weights", str(weights), "--checkpoint-dir", str(workdir), "--out", str(out),
            "--device", device.type]
    stats = []
    for run in range(runs):
        reset_launches(fused_bilstm_fwd)
        stats.append(generate.main(argv))
        if run == 0:
            launches = fused_bilstm_fwd.launches
            by_path = dict(fused_bilstm_fwd.launches_by_path)
    with np.load(out) as data:
        if set(data.files) != {"gestures", "words", "prototypes"}:
            raise AssertionError(f"npz keys {data.files}")
        check_gestures(data["gestures"], n, SEQ)
    expected = chunk_layout(n, batch)[1]
    path = bilstm_fused.kernel_path(torch.bfloat16, hidden, SEQ, LAYERS)
    if device.type == "cuda" and (launches != expected
                                  or by_path != only_path(fused_bilstm_fwd, path, expected)):
        raise AssertionError(f"bilstm_fused launched {launches} times ({by_path}), expected "
                             f"{expected} on {path}")

    # A small request with injected noise against the CPU's plain path.
    config = ModelConfig(time_head="monotone", compute_dtype="bfloat16", gen_hidden_dim=hidden)
    rng = np.random.default_rng(7)
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), 48)]
    kb = QWERTYKeyboard()
    protos = np.stack([kb.get_word_prototype(w, SEQ) for w in words])
    z = rng.normal(size=(len(words), LATENT)).astype(np.float32)
    model = load_generator(str(weights), config, device=device)
    got = generate_gestures(model, protos, model.config, batch=32, device=device, z=z)
    model_cpu = load_generator(str(weights), config, device="cpu")
    want = generate_gestures(model_cpu, protos, model_cpu.config, batch=32, device="cpu", z=z)
    err = float(np.abs(got - want).max())
    print(json.dumps({"check": "serving vs CPU plain path", "n": len(words),
                      "max_abs_err": err, "tolerance": TOLERANCE["bfloat16"]}), flush=True)
    if not err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"served gestures differ from the CPU path by {err}")
    if device.type == "cuda":
        kb_protos = np.stack([kb.get_word_prototype(WORDS[i % len(WORDS)], SEQ)
                              for i in range(n)])
        profile_serving(model, kb_protos, batch, device)
    return {"launches": launches, "launches_by_path": by_path, "chunks": expected, "runs": stats}


def device_profile(run, label: str, **extra) -> dict:
    """``run()`` once under torch.profiler: device time summed by kernel name
    against the call's wall time. Prints and returns the profile line."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # Device-side events only (kernels, copies): CPU ops also carry the
        # device time of the kernels they launched, which would count twice.
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            rows.append({"name": evt.key[:80], "count": evt.count,
                         "device_ms": evt.self_device_time_total / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    line = {"profile": label, **extra, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_events": sum(r["count"] for r in rows), "top": rows[:10]}
    print(json.dumps(line), flush=True)
    return line


def profile_serving(model, protos: np.ndarray, batch: int, device) -> None:
    """Where the serving path's time goes: one steady ``generate_gestures``
    call under torch.profiler."""
    generate_gestures(model, protos, model.config, batch=batch, device=device)   # warm
    device_profile(lambda: generate_gestures(model, protos, model.config, batch=batch,
                                             device=device),
                   "generate_gestures", n=len(protos), batch=batch)


def cudnn_lstm(tree: dict, latent: int, dtype: torch.dtype, device) -> torch.nn.LSTM:
    """``torch.nn.LSTM`` holding the stack's weights (the timed yardstick;
    the port never calls it)."""
    hidden = tree["lstm"][0]["fwd"]["w_hh"].shape[0]
    lstm = torch.nn.LSTM(2 + latent, hidden, num_layers=len(tree["lstm"]), bidirectional=True,
                         batch_first=True)
    with torch.no_grad():
        for k, layer in enumerate(tree["lstm"]):
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
                p = layer[direction]
                getattr(lstm, f"weight_ih_l{k}{suffix}").copy_(torch.from_numpy(p["w_ih"].T))
                getattr(lstm, f"weight_hh_l{k}{suffix}").copy_(torch.from_numpy(p["w_hh"].T))
                getattr(lstm, f"bias_ih_l{k}{suffix}").copy_(torch.from_numpy(p["b_ih"]))
                getattr(lstm, f"bias_hh_l{k}{suffix}").copy_(torch.from_numpy(p["b_hh"]))
    lstm = lstm.to(device=device, dtype=dtype)
    lstm.flatten_parameters()
    return lstm


def time_kernel(device, dtype_name: str, batch=TIME_BATCH, hidden=HIDDEN, seq=SEQ,
                layers=LAYERS, latent=LATENT) -> dict:
    """Phase 8: kernel 1, its plain version and cuDNN LSTM at one shape; in
    float32 also the cluster kernel with the other sample tile (4 or 8) than
    the one the dispatch rule picks at this batch."""
    dtype = getattr(torch, dtype_name)
    tree = random_generator_tree(hidden, layers, latent, seed=2)
    stack = stack_on(tree, device)
    x, z = random_inputs(batch, seq, latent, seed=3, device=device)
    ms = time_ms(lambda: fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype), iters=20)
    path = bilstm_fused.kernel_path(dtype, hidden, seq, layers)
    tile = sample_tile(dtype, batch)
    other = {}
    if path == "fp32":
        other_tile = 12 - tile
        got = bilstm_fused._launch_packed(stack, x, hidden, z, dtype, tile=other_tile)
        want = fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype)
        other = {"other_tile": other_tile,
                 "other_tile_ms": time_ms(lambda: bilstm_fused._launch_packed(
                     stack, x, hidden, z, dtype, tile=other_tile), iters=20),
                 "other_tile_max_abs_diff": (got - want).abs().max().item()}
    plain_ms = time_ms(lambda: fused_bilstm_fwd_plain(stack, x, hidden, z, dtype=dtype),
                       iters=2, warmup=1)
    lstm = cudnn_lstm(tree, latent, dtype, device)
    seq_in = torch.cat([x, z[:, None, :].expand(-1, seq, -1)], dim=-1).to(dtype)
    with torch.no_grad():
        library_ms = time_ms(lambda: lstm(seq_in), iters=20)
        lib_err = (lstm(seq_in)[0].float()
                   - fused_bilstm_fwd_plain(stack, x, hidden, z, dtype=dtype).float()).abs().max()
    bound_ms, bound_by = bilstm_bound_ms(batch, seq, hidden, layers, latent, dtype_name)
    row = {"dtype": dtype_name, "batch": batch, "path": path, "sample_tile": tile, "ms": ms,
           **other, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_max_abs_diff": lib_err.item(),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "us_per_dependent_step": ms * 1e3 / (layers * seq)}
    print(json.dumps({"timing": "bilstm_fused", **row}), flush=True)
    return row


# -- kernels 2 and 3: the training pair ---------------------------------------------------


def _bound(nbytes: float, flops: float, peak_flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def train_bounds_ms(batch: int, seq: int, hidden: int, layers: int, latent: int,
                    dtype: str) -> dict:
    """Least times of kernels 2 and 3 on an H100: {"fwd": (ms, by), "bwd":
    (ms, by)}.

    Kernel 2: kernel 1's gate products (on the tensor cores in bf16); bytes:
    the inputs once, the residuals (layers, 2, L, B, 6H) and the output once.
    Kernel 3: the products every backward step needs per sample and
    direction — dh through W_hh^T (H·4H), the input gradient (2H·4H above
    layer 1, 2·4H at it) and the weight gradients ([x | h_prev]^T·dgates,
    (din + H)·4H) — plus dW_z and dz (2·Z·4H per sample). The casting
    contract asks for float32 products of the float32 gate gradients with
    weights and residuals rounded to the compute dtype. In bfloat16 those
    operands are exact in bf16, so the least arithmetic that keeps the
    contract is BWD_SPLIT_TERMS bf16 tensor-core products per product (the
    gate gradient split in that many bf16 terms, float32 accumulation):
    operations x BWD_SPLIT_TERMS at the bf16 tensor peak. In float32 the
    operands are not exact in bf16, so the products stay on the float32
    CUDA-core peak. Bytes: residuals, dy, prototype, z and weights read once,
    dW, dz and dx written once. Beyond either bound the practical floor of
    kernels 1-3 is the chain of layers x L dependent steps."""
    item = 2 if dtype == "bfloat16" else 4
    H, g = hidden, 4 * hidden
    fwd_flops = batch * 2 * (seq * 2 * g * (H + 2) + (layers - 1) * seq * 2 * g * 3 * H
                             + 2 * g * latent)
    weights = (2 * 2 * g + layers * 2 * H * g + (layers - 1) * 2 * 2 * H * g) * item
    res = layers * 2 * seq * batch * 6 * H * item
    proto_z = batch * seq * 2 * item + batch * latent * 4
    fwd_bytes = proto_z + weights + (2 * latent * g + layers * 2 * g) * 4 + res \
        + batch * seq * 2 * H * item
    macs_first = H * g + 2 * g + (2 + H) * g
    macs_rest = H * g + 2 * H * g + (2 * H + H) * g
    bwd_flops = batch * 2 * (2 * seq * (macs_first + (layers - 1) * macs_rest)
                             + 2 * 2 * latent * g)
    dw = 2 * ((2 + latent + H + 1) + (layers - 1) * (3 * H + 1)) * g * 4
    bwd_bytes = res + batch * seq * 2 * H * item + proto_z + weights + latent * 2 * g * item \
        + dw + batch * latent * 4 + batch * seq * 2 * 4
    bwd_peak = PEAK_FLOPS["bfloat16"] / BWD_SPLIT_TERMS if dtype == "bfloat16" \
        else PEAK_FLOPS["float32"]
    return {"fwd": _bound(fwd_bytes, fwd_flops, PEAK_FLOPS[dtype]),
            "bwd": _bound(bwd_bytes, bwd_flops, bwd_peak)}


def _rel_err(got, want) -> tuple:
    """(max |err| / max |want|, max |err|)."""
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err / max(want.abs().max().item(), 1e-30), err


def _weight_grads_equal(a: list, b: list) -> bool:
    return all(torch.equal(a[k][d][leaf], b[k][d][leaf])
               for k in range(len(a)) for d in ("fwd", "bwd") for leaf in ("w_ih", "w_hh", "b_ih"))


def check_train_kernels(device, hidden=HIDDEN, seq=SEQ, layers=LAYERS, latent=LATENT,
                        batches=TRAIN_CHECK_BATCHES) -> list:
    """Phase 3, kernels 2 and 3: each against its plain version on the same
    inputs (kernel 3 and its plain version both read kernel 2's residuals),
    kernel 2's output against kernel 1's (float32 at H in {16, 32, 48}: one
    recurrence, bit-equal; otherwise the two sum in different orders: kernel
    1's tolerance), the kernel path every call took (at full width the
    tensor cores in bfloat16, the float32 cluster kernels in float32; the
    general kernels at other widths), and kernel 3 launched twice on the same
    inputs (bit-equal gradients)."""
    stack = stack_on(random_generator_tree(hidden, layers, latent, seed=4), device)
    results = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tol = TOLERANCE[dtype_name]
        path = kernel_path(dtype, hidden, seq, layers)
        for batch in batches:
            x, z = random_inputs(batch, seq, latent, seed=batch + 1, device=device)
            dy = torch.from_numpy(np.random.default_rng(batch).normal(
                size=(batch, seq, 2 * hidden)).astype(np.float32)).to(device)
            before = [dict(f.launches_by_path) for f in (bilstm_train_fwd, bilstm_train_bwd)]
            y, res = bilstm_train_fwd(stack, x, z, hidden, dtype)
            grads, dx, dz = bilstm_train_bwd(stack, x, z, res, dy, hidden, dtype)
            grads2, dx2, dz2 = bilstm_train_bwd(stack, x, z, res, dy, hidden, dtype)
            y_inference = fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype)
            if device.type == "cuda":
                torch.cuda.synchronize()
                took = [{k: f.launches_by_path[k] - b[k] for k in b}
                        for f, b in zip((bilstm_train_fwd, bilstm_train_bwd), before)]
                want_took = [{"mma": 0, "fp32": 0, "general": 0, path: 1},
                             {"mma": 0, "fp32": 0, "general": 0, path: 2}]
                if took != want_took:
                    raise AssertionError(f"{dtype_name} B={batch}: launches by path {took}, "
                                         f"expected {want_took}")
            y_p, res_p = bilstm_train_fwd_plain(stack, x, z, hidden, dtype)
            grads_p, dx_p, dz_p = bilstm_train_bwd_plain(stack, x, z, res, dy, hidden, dtype)
            if y.shape != (batch, seq, 2 * hidden) or y.dtype != dtype or res.dtype != dtype:
                raise AssertionError(f"kernel 2 output {tuple(y.shape)} {y.dtype}")
            fwd = {"y": _rel_err(y, y_p)}
            for p, name in enumerate(PLANES):
                rows = slice(p * hidden, (p + 1) * hidden)
                fwd[f"res_{name}"] = _rel_err(res[..., rows], res_p[..., rows])
            bwd = {"dx": _rel_err(dx, dx_p), "dz": _rel_err(dz, dz_p)}
            for leaf, key in (("w_ih", "dW_ih"), ("w_hh", "dW_hh"), ("b_ih", "db")):
                errs = [_rel_err(grads[k][d][leaf], grads_p[k][d][leaf])
                        for k in range(layers) for d in ("fwd", "bwd")]
                bwd[key] = (max(e[0] for e in errs), max(e[1] for e in errs))
            vs_kernel1 = (y.float() - y_inference.float()).abs().max().item()
            deterministic = (_weight_grads_equal(grads, grads2) and torch.equal(dx, dx2)
                             and torch.equal(dz, dz2))
            row = {"dtype": dtype_name, "batch": batch, "path": path, "tolerance_rel": tol,
                   "fwd_rel": {k: v[0] for k, v in fwd.items()},
                   "bwd_rel": {k: v[0] for k, v in bwd.items()},
                   "fwd_max_abs_err": max(v[1] for v in fwd.values()),
                   "bwd_max_abs_err": max(v[1] for v in bwd.values()),
                   "train_fwd_vs_bilstm_fused_max_abs": vs_kernel1,
                   "bwd_bit_equal_across_two_launches": deterministic}
            results.append(row)
            print(json.dumps({"check": "bilstm_train vs plain", **row}), flush=True)
            worst = max(list(fwd.items()) + list(bwd.items()), key=lambda kv: kv[1][0])
            if not worst[1][0] <= tol:
                raise AssertionError(f"bilstm_train disagrees with its plain version: "
                                     f"{dtype_name} B={batch} {worst[0]} {worst[1][0]} > {tol}")
            if not vs_kernel1 <= TOLERANCE[dtype_name]:
                raise AssertionError(f"kernel 2's output differs from kernel 1's by {vs_kernel1}")
            if path == "fp32" and device.type == "cuda" and vs_kernel1 != 0.0:
                raise AssertionError(f"float32 kernel 2 is not bit-equal to kernel 1: {vs_kernel1}")
            if not deterministic:
                raise AssertionError(f"kernel 3 is not deterministic: {dtype_name} B={batch}")
    return results


OWN_KERNELS = ("train_fwd", "train_bwd", "bilstm_fused")


def count_small_launches(device, batch=TIME_BATCH, hidden=HIDDEN, seq=SEQ, layers=LAYERS,
                         latent=LATENT) -> dict:
    """Phase 3: the PyTorch launches (casts, copies, concatenations, adds)
    each BiLSTM wrapper makes around its own kernels in one call, counted
    as device events under torch.profiler, per dtype (hence per kernel path).
    They add to the train step's launch count."""
    stack = stack_on(random_generator_tree(hidden, layers, latent, seed=2), device)
    x, z = random_inputs(batch, seq, latent, seed=3, device=device)
    dy = torch.from_numpy(np.random.default_rng(5).normal(
        size=(batch, seq, 2 * hidden)).astype(np.float32)).to(device)
    line = {"check": "small launches per wrapper call", "batch": batch}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        _, res = bilstm_train_fwd(stack, x, z, hidden, dtype)                  # warm
        bilstm_train_bwd(stack, x, z, res, dy, hidden, dtype)
        fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype)
        counts = {}
        for name, call in (("fwd", lambda: bilstm_train_fwd(stack, x, z, hidden, dtype)),
                           ("bwd", lambda: bilstm_train_bwd(stack, x, z, res, dy, hidden, dtype)),
                           ("inference", lambda: fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype))):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            own = sum(e.count for e in events if any(k in e.key for k in OWN_KERNELS))
            counts[name] = {"own_kernels": own, "small_launches": sum(e.count for e in events) - own}
        line[dtype_name] = {"path": kernel_path(dtype, hidden, seq, layers),
                            "inference_path": bilstm_fused.kernel_path(dtype, hidden, seq, layers),
                            **counts}
    print(json.dumps(line), flush=True)
    return line


def time_train_pair(device, dtype_name: str, batch=TIME_BATCH, hidden=HIDDEN, seq=SEQ,
                    layers=LAYERS, latent=LATENT) -> dict:
    """Phase 8, kernels 2 and 3: each kernel, its plain version, and cuDNN's
    float32 LSTM forward (training mode) and backward on the same weights.
    On the float32 path also the general CUDA-core kernels on the same
    inputs (the internal launchers; no user switch reaches them at this
    width), timed between two timings of the float32 kernels."""
    dtype = getattr(torch, dtype_name)
    tree = random_generator_tree(hidden, layers, latent, seed=2)
    stack = stack_on(tree, device)
    x, z = random_inputs(batch, seq, latent, seed=3, device=device)
    dy = torch.from_numpy(np.random.default_rng(5).normal(
        size=(batch, seq, 2 * hidden)).astype(np.float32)).to(device)
    fwd_ms = time_ms(lambda: bilstm_train_fwd(stack, x, z, hidden, dtype), iters=10)
    _, res = bilstm_train_fwd(stack, x, z, hidden, dtype)
    bwd_ms = time_ms(lambda: bilstm_train_bwd(stack, x, z, res, dy, hidden, dtype), iters=10)
    path = kernel_path(dtype, hidden, seq, layers)
    general = {}
    if path == "fp32":
        fwd_g, bwd_g = bilstm_train._LAUNCHERS["general"]
        general = {
            "general_fwd_ms": time_ms(lambda: fwd_g(stack, x, z, hidden, dtype), iters=10),
            "general_bwd_ms": time_ms(lambda: bwd_g(stack, x, z, res, dy, hidden, dtype), iters=10),
            "fwd_ms_again": time_ms(lambda: bilstm_train_fwd(stack, x, z, hidden, dtype), iters=10),
            "bwd_ms_again": time_ms(lambda: bilstm_train_bwd(stack, x, z, res, dy, hidden, dtype),
                                    iters=10)}
    plain_fwd_ms = time_ms(lambda: bilstm_train_fwd_plain(stack, x, z, hidden, dtype),
                           iters=2, warmup=1)
    plain_bwd_ms = time_ms(lambda: bilstm_train_bwd_plain(stack, x, z, res, dy, hidden, dtype),
                           iters=2, warmup=1)

    lstm = cudnn_lstm(tree, latent, torch.float32, device)
    seq_in = torch.cat([x, z[:, None, :].expand(-1, seq, -1)], dim=-1).requires_grad_()
    library_fwd_ms = time_ms(lambda: lstm(seq_in), iters=10)
    out = lstm(seq_in)[0]
    inputs = [seq_in, *lstm.parameters()]
    library_bwd_ms = time_ms(lambda: torch.autograd.grad(out, inputs, dy, retain_graph=True),
                             iters=10)
    bounds = train_bounds_ms(batch, seq, hidden, layers, latent, dtype_name)
    row = {"dtype": dtype_name, "batch": batch, "path": path,
           "sample_tile": sample_tile(dtype, batch) if path != "general" else None,
           "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, **general, "plain_fwd_ms": plain_fwd_ms,
           "plain_bwd_ms": plain_bwd_ms, "cudnn_fp32_fwd_ms": library_fwd_ms,
           "cudnn_fp32_bwd_ms": library_bwd_ms,
           "fwd_bound_ms": bounds["fwd"][0], "fwd_bound_by": bounds["fwd"][1],
           "bwd_bound_ms": bounds["bwd"][0], "bwd_bound_by": bounds["bwd"][1]}
    print(json.dumps({"timing": "bilstm_train", **row}), flush=True)
    return row


def profile_train_pair(device, dtype_name="bfloat16", batch=TIME_BATCH, hidden=HIDDEN, seq=SEQ,
                       latent=LATENT, depths=(1, LAYERS), calls=3, path=None) -> list:
    """Phase 8: a few calls of kernel 2 and kernel 3 under torch.profiler, at
    one layer and at the full depth: the device time per launch of each pass
    (forward, sweep, weight-gradient product, the fixed-order sum) and what a
    layer adds to the chain. ``path`` runs that path's internal launchers
    instead of the dispatch (the general kernels at full width, to split
    their time the same way). The profiler may drop the first events of a
    profile, so each pass is reported per event seen."""
    dtype = getattr(torch, dtype_name)
    fwd, bwd = bilstm_train._LAUNCHERS[path] if path else (bilstm_train_fwd, bilstm_train_bwd)
    lines = []
    for layers in depths:
        stack = stack_on(random_generator_tree(hidden, layers, latent, seed=2), device)
        x, z = random_inputs(batch, seq, latent, seed=3, device=device)
        dy = torch.from_numpy(np.random.default_rng(5).normal(
            size=(batch, seq, 2 * hidden)).astype(np.float32)).to(device)
        _, res = fwd(stack, x, z, hidden, dtype)
        bwd(stack, x, z, res, dy, hidden, dtype)                                       # warm

        def pairs():
            for _ in range(calls):
                fwd(stack, x, z, hidden, dtype)
                bwd(stack, x, z, res, dy, hidden, dtype)

        taken = path or kernel_path(dtype, hidden, seq, layers)
        line = device_profile(pairs, "bilstm_train pair", batch=batch, dtype=dtype_name,
                              path=taken, layers=layers, calls=calls)
        own = {r["name"].split("::")[-1].split("(")[0]: r["device_ms"] / r["count"]
               for r in line["top"] if any(k in r["name"] for k in OWN_KERNELS)}
        print(json.dumps({"timing": "bilstm_train passes", "batch": batch, "dtype": dtype_name,
                          "path": taken, "layers": layers, "ms_per_launch": own}), flush=True)
        lines.append(line)
    return lines


# -- kernel 4: exact batched DTW ----------------------------------------------------------

DTW_CHECK_PAIRS = (1, 131, 8192)
REALISM_SEQ = 64       # data/realism.py resamples (trace, prototype) pairs to 64 points
# Kernel against plain, each distance relative to its own size: the kernel
# adds costs along the path, the plain version subtracts prefix sums of up to
# 128 costs, so they differ by a few float32 roundings of sums of order 10-100.
DTW_TOL_REL = 1e-4
# Peak rates for the DTW bound: the H100 SXM's 132 SMs at the 1.98 GHz boost
# clock behind its 67 TFLOP/s float32 figure, 16 special-function lanes each.
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def gesture_like(rng, count: int, seq: int, dims: int) -> torch.Tensor:
    """Seeded sequences shaped like gestures: cumulative small steps, kept in
    [-1, 1]."""
    walk = np.cumsum(rng.normal(0.0, 0.05, (count, seq, dims)), axis=1)
    return torch.from_numpy(np.clip(walk, -1.0, 1.0).astype(np.float32))


def dtw_host_float64(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The classic O(L^2) recurrence in float64 numpy, vectorised over pairs."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    P, L, _ = x.shape
    cost = np.sqrt(((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1))
    acc = np.full((P, L + 1, L + 1), np.inf)
    acc[:, 0, 0] = 0.0
    for i in range(1, L + 1):
        for j in range(1, L + 1):
            acc[:, i, j] = cost[:, i - 1, j - 1] + np.minimum(
                np.minimum(acc[:, i - 1, j], acc[:, i - 1, j - 1]), acc[:, i, j - 1])
    return acc[:, L, L]


def _dtw_rel(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max over pairs of |err| / |want|, max |err|)."""
    err = (got.double() - want.double()).abs()
    return (err / want.double().abs().clamp_min(1e-6)).max().item(), err.max().item()


def dtw_bound_ms(pairs: int, rows: int, cols: int, seq: int, dims: int) -> dict:
    """Least time of kernel 4 on an H100 for ``pairs`` pairs of ``seq`` points:
    bytes (both sets read once — ``rows`` + ``cols`` sequences — and one
    float32 per pair written) against operations, the larger of the float32
    work (per cell ``dims`` subtractions, ``dims`` multiplies, ``dims``-1
    adds, two minimums and one add, at the 67 TFLOP/s peak) and one square
    root per cell on the special-function units."""
    cells = pairs * seq * seq
    t_bytes = ((rows + cols) * seq * dims * 4 + pairs * 4) / PEAK_BYTES_PER_S * 1e3
    t_fp32 = cells * (3 * dims + 2) / PEAK_FLOPS["float32"] * 1e3
    t_sfu = cells / SFU_OPS_PER_S * 1e3
    t_ops = max(t_fp32, t_sfu)
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "bytes_ms": t_bytes, "fp32_ms": t_fp32, "sqrt_sfu_ms": t_sfu,
            "set_by": "square roots on the special-function units" if t_sfu >= t_fp32
            else "float32 pipes"}


def check_dtw(device, seq=SEQ, pair_counts=DTW_CHECK_PAIRS) -> list:
    """Phase 3, kernel 4: both entries against the plain version on the same
    inputs, the matrix entry against aligned pairs, short and odd shapes, and
    a small case against a float64 recurrence on the host."""
    rng = np.random.default_rng(11)
    results = []

    def record(case: str, got, want, **extra):
        rel, err = _dtw_rel(got, want)
        row = {"case": case, **extra, "max_rel_err": rel, "max_abs_err": err,
               "tolerance_rel": DTW_TOL_REL}
        results.append(row)
        print(json.dumps({"check": "dtw vs plain", **row}), flush=True)
        if not (rel <= DTW_TOL_REL and torch.isfinite(got).all()):
            raise AssertionError(f"dtw disagrees with its plain version: {row}")

    for dims in (2, 3):
        for pairs in pair_counts:
            x = gesture_like(rng, pairs, seq, dims).to(device)
            y = gesture_like(rng, pairs, seq, dims).to(device)
            got = dtw_pairs(x, y)
            if got.shape != (pairs,) or got.dtype != torch.float32:
                raise AssertionError(f"dtw_pairs output {tuple(got.shape)} {got.dtype}")
            record("aligned pairs", got, dtw_pairs_plain(x, y), pairs=pairs, dims=dims, seq=seq)
        for n, m, length in ((64, 64, seq), (37, 13, seq), (33, 5, max(seq // 2 - 14, 1)),
                             (3, 2, 1)):
            real = gesture_like(rng, n, length, dims).to(device)
            fake = gesture_like(rng, m, length, dims).to(device)
            got = dtw_matrix(real, fake)
            idx = torch.arange(n * m, device=device)
            rx, fy = real[idx // m], fake[idx % m]
            record("matrix entry", got.reshape(-1), dtw_pairs_plain(rx, fy), n=n, m=m,
                   dims=dims, seq=length)
            record("matrix entry vs aligned pairs", got.reshape(-1), dtw_pairs(rx, fy), n=n,
                   m=m, dims=dims, seq=length)
        x, y = gesture_like(rng, 4, seq, dims), gesture_like(rng, 4, seq, dims)
        want = torch.from_numpy(dtw_host_float64(x.numpy(), y.numpy()))
        record("aligned pairs vs float64 host recurrence", dtw_pairs(x.to(device), y.to(device)).cpu(),
               want, pairs=4, dims=dims, seq=seq)
    for pairs in pair_counts:   # the realism report's shape: (x, y) at 64 points
        x = gesture_like(rng, pairs, REALISM_SEQ, 2).to(device)
        y = gesture_like(rng, pairs, REALISM_SEQ, 2).to(device)
        record("aligned pairs", dtw_pairs(x, y), dtw_pairs_plain(x, y), pairs=pairs, dims=2,
               seq=REALISM_SEQ)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return results


def dtw_plain_all_pairs(real: torch.Tensor, fake: torch.Tensor, chunk: int = 1 << 19) -> torch.Tensor:
    """The plain version over all n·m pairs, gathered in chunks of ``chunk``
    pairs (a whole (n·m, L, D) gather would not fit beside its row buffers)."""
    n, m = real.shape[0], fake.shape[0]
    idx = torch.arange(n * m, device=real.device)
    return torch.cat([dtw_pairs_plain(real[i // m], fake[i % m])
                      for i in idx.split(chunk)]).reshape(n, m)


def time_dtw(device, n=2000, seq=SEQ, dims=2) -> dict:
    """Phase 8, kernel 4: the matrix entry at the evaluation's shape (one
    launch for all n·n pairs) and the plain version over the same pairs (in
    chunks, timed once after a warm-up on one small chunk), whose result the
    kernel's whole matrix is also held against."""
    rng = np.random.default_rng(12)
    real = gesture_like(rng, n, seq, dims).to(device)
    fake = gesture_like(rng, n, seq, dims).to(device)
    ms = time_ms(lambda: dtw_matrix(real, fake), iters=5, warmup=1)
    dtw_plain_all_pairs(real[:64], fake[:64])                               # warm
    plain = []
    plain_ms = time_ms(lambda: plain.append(dtw_plain_all_pairs(real, fake)), iters=1, warmup=0)
    rel, err = _dtw_rel(dtw_matrix(real, fake), plain[0])
    if not rel <= DTW_TOL_REL:
        raise AssertionError(f"dtw matrix of {n}x{n} disagrees with its plain version: {rel}")
    row = {"pairs": n * n, "n": n, "m": n, "seq": seq, "dims": dims, "launches_per_matrix": 1,
           "ms": ms, "pairs_per_s": n * n / ms * 1e3, "plain_ms": plain_ms,
           "max_rel_err_all_pairs": rel, "max_abs_err_all_pairs": err,
           **dtw_bound_ms(n * n, n, n, seq, dims), "library_ms": None}
    print(json.dumps({"timing": "dtw", **row}), flush=True)
    return row


# -- training through the entry point -----------------------------------------------------


def smoke_dataset(n: int, seq: int = SEQ, seed: int = 0) -> GestureArrays:
    """``n`` smoke gestures over the word list: each word's keyboard
    prototype, displaced by a seeded smooth perturbation (three low
    sinusoids per coordinate, amplitude <= 0.05) and timed by a warped
    monotone clock (cumulative positive smooth increments, 0 to 1). Smoke
    data for driving the trainer, not a corpus; its realism is not measured."""
    rng = np.random.default_rng(seed)
    kb = QWERTYKeyboard()
    words = [WORDS[i % len(WORDS)] for i in range(n)]
    protos = {w: kb.get_word_prototype(w, seq) for w in set(words)}
    prototypes = np.stack([protos[w] for w in words]).astype(np.float32)
    u = np.linspace(0.0, 1.0, seq)[None, :, None]                           # (1, L, 1)
    freq = rng.uniform(0.5, 3.0, (n, 1, 3))
    phase = rng.uniform(0.0, 2 * np.pi, (n, 1, 3))
    amp = rng.uniform(0.0, 0.05 / 3, (n, 2, 3))
    waves = np.sin(2 * np.pi * freq * u + phase)                            # (n, L, 3)
    gestures = prototypes.copy()
    gestures[..., :2] = np.clip(prototypes[..., :2] + np.einsum("nlk,nck->nlc", waves, amp),
                                -1.0, 1.0)
    rate = np.exp(0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0, (n, 1)) * u[..., 0]
                               + rng.uniform(0, 2 * np.pi, (n, 1))))        # (n, L)
    clock = np.concatenate([np.zeros((n, 1)), np.cumsum(rate[:, 1:], axis=1)], axis=1)
    gestures[..., 2] = clock / clock[:, -1:]
    return GestureArrays(gestures.astype(np.float32), prototypes, words)


def train(device, workdir: Path, n=TRAIN_N, model: dict = None, batch_size: int = 512,
          scan: bool = False) -> dict:
    """Phases 5 and 5b (and, with ``scan``, 5c and 5d: the same through the
    captured CUDA graph of the step, ``RuntimeConfig.scan_epoch``): 2 epochs
    through ``train_gan``, then a resumed third epoch whose kernel launches
    are counted from 0 (a replay adds the launches its capture counted),
    every one on the path its dispatch rule names for the recipe's dtype and
    width. ``model`` overrides fields of the flagship configuration:
    ``compute_dtype`` for phase 5b (float32), the widths for a rehearsal on
    the CPU at a tiny size."""
    mcfg = ModelConfig(**{"time_head": "monotone", "compute_dtype": "bfloat16", **(model or {})})
    recipe = dict(FLAGSHIP_TRAIN, batch_size=batch_size)
    tcfg = TrainingConfig(**recipe, save_every=1)
    runtime = RuntimeConfig(scan_epoch=scan)
    ds = smoke_dataset(n, mcfg.seq_length)
    steps = n // tcfg.batch_size
    first = train_gan(ds, mcfg, tcfg, runtime, num_epochs=2, checkpoint_dir=str(workdir),
                      device=device)
    if latest_epoch(str(workdir)) != 2 or len(first.history) != 2:
        raise AssertionError("the first two epochs were not checkpointed")
    counters = {"bilstm_fused": fused_bilstm_fwd, "bilstm_train_fwd": bilstm_train_fwd,
                "bilstm_train_bwd": bilstm_train_bwd}
    reset_launches(*counters.values(), threefry_draw)
    third = train_gan(ds, mcfg, tcfg, runtime, num_epochs=3, checkpoint_dir=str(workdir),
                      device=device)
    launches = {name: c.launches for name, c in counters.items()}
    draws = threefry_draw.launches
    by_path = {name: dict(c.launches_by_path) for name, c in counters.items()}
    if len(third.history) != 1 or third.state["epoch"] != 3 or latest_epoch(str(workdir)) != 3:
        raise AssertionError("the run did not resume for exactly one epoch")
    for losses in first.history + third.history:
        bad = [k for k, v in losses.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite losses {bad}")
    expected = {name: per * steps for name, per in PER_STEP.items()}
    if device.type == "cuda" and launches != expected:
        raise AssertionError(f"launches in the resumed epoch {launches}, expected {expected}")
    # One threefry launch a step (its noise) and one a round of the epoch's
    # shuffle (jax.random.permutation's sort keys).
    rounds = int(np.ceil(3 * np.log(n) / np.log(2 ** 32 - 1)))
    if device.type == "cuda" and draws != steps + rounds:
        raise AssertionError(f"{draws} threefry launches in the resumed epoch, "
                             f"expected {steps + rounds}")
    # Every launch of the recipe's width and dtype took the path its dispatch
    # rule names (at full width the tensor-core ones in bfloat16, the float32
    # cluster ones in float32).
    shape = (getattr(torch, mcfg.compute_dtype), mcfg.gen_hidden_dim, mcfg.seq_length, 1)
    path = kernel_path(*shape)
    paths = {name: bilstm_fused.kernel_path(*shape) if name == "bilstm_fused" else path
             for name in counters}
    for name, counts in by_path.items():
        if device.type == "cuda" and counts != only_path(counters[name], paths[name],
                                                         expected[name]):
            raise AssertionError(f"{name} launches by path {counts}, expected all on "
                                 f"{paths[name]}")
    seconds = first.epoch_seconds + third.epoch_seconds
    line = {"training": "train_gan", "scan_epoch": scan, "n": n, "batch": tcfg.batch_size,
            "steps_per_epoch": steps, "dtype": mcfg.compute_dtype, "epoch_seconds": seconds,
            "gestures_per_s": [first.gestures_per_epoch / t for t in seconds],
            "ms_per_step": [t / steps * 1e3 for t in seconds],
            "launches_resumed_epoch": launches, "threefry_launches_resumed_epoch": draws,
            "kernel_path": paths,
            "launches_by_path": by_path, "losses_last_epoch": third.history[-1]}
    print(json.dumps(line), flush=True)
    if device.type == "cuda":   # where a steady step's time goes
        batch = {"gesture": torch.from_numpy(ds.gestures[:batch_size]).to(device),
                 "prototype": torch.from_numpy(ds.prototypes[:batch_size]).to(device)}
        tcfg_m = TrainingConfig(**recipe, div_margin=0.25)
        if scan:
            line["profile"] = profile_replay(
                lambda s, eb, graph: gan_train_epoch(s, eb, 1e-5, mcfg, tcfg_m, graph=graph),
                third.state, batch, "gan_train_step (CUDA graph replay)", batch=batch_size,
                dtype=mcfg.compute_dtype)
        else:
            gan_train_step(third.state, batch, 1e-5, mcfg, tcfg_m)             # warm
            line["profile"] = device_profile(
                lambda: gan_train_step(third.state, batch, 1e-5, mcfg, tcfg_m), "gan_train_step",
                batch=batch_size, dtype=mcfg.compute_dtype)
    line["launches"] = launches
    line["threefry_launches"] = draws
    return line


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def profile_replay(epoch, state: dict, inputs: dict, label: str, **extra) -> dict:
    """One replay of a captured step under torch.profiler: ``epoch(state,
    epoch_batches, graph)`` on a one-batch epoch of ``inputs`` first warms up
    and captures (no replay), then, profiled, replays once (the noise draws
    and input copies around it included)."""
    graph = StepGraph()
    stacked = {k: v[None] for k, v in inputs.items()}
    epoch(state, stacked, graph)
    line = device_profile(lambda: epoch(state, stacked, graph), label, **extra)
    if graph.captures != 1 or graph.replays != 1:
        raise AssertionError(f"{graph.captures} captures and {graph.replays} replays, "
                             f"expected 1 and 1")
    return line


# Phases 5e-5g: two copies of one state, two epochs of 3 batches of 512 each,
# the captured step replayed against the same steps run eagerly.
GRAPH_CHECK_BATCHES, GRAPH_CHECK_EPOCHS, GRAPH_CHECK_LR = 3, 2, 2e-4


def graphed_vs_eager(device, kind: str, batch: int = 512, model: dict = None,
                     mesh=None) -> dict:
    """Phases 5e-5g: from two copies of one state (and so of its random
    key), ``gan_train_epoch`` (``kind`` "bfloat16" or "float32", the
    flagship recipe) or ``gan_train_epoch_masked`` ("masked": the
    transformer, bf16, the default recipe, varied lengths) with one
    ``StepGraph`` for two epochs (the second all replays) against the same
    steps run eagerly, each drawing its own noise. The traces, every tensor
    of the state, Adam's counts and the key must be bit-equal;
    the critics' u vectors must move in every epoch; the BiLSTM kernels must
    count PER_STEP launches a step. ``model`` overrides widths for a
    rehearsal on the CPU (where both sides run the same eager steps);
    ``mesh``, a process group's, runs both sides under it (phase 9a').

    cuDNN's float32 convolution backward is not run-to-run deterministic on
    the card (two eager float32 epochs from one state differ in the last
    bits, which the GAN's steps amplify), so the float32 check runs with
    ``torch.backends.cudnn.deterministic``; bf16 and the masked step are
    deterministic as they run."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = kind == "float32"
    try:
        return _graphed_vs_eager(device, kind, batch, model, mesh)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _graph_check_inputs(device, kind: str, batch: int, model: dict) -> tuple:
    """Phases 5e-5g's configuration, GRAPH_CHECK_BATCHES stacked batches and
    the epoch and step functions of ``kind``."""
    masked = kind == "masked"
    mcfg = ModelConfig(**{"time_head": "monotone",
                          "compute_dtype": "float32" if kind == "float32" else "bfloat16",
                          **({"generator_type": "transformer"} if masked else {}),
                          **(model or {})})
    tcfg = TrainingConfig(**(dict(batch_size=batch) if masked
                             else dict(FLAGSHIP_TRAIN, batch_size=batch)), div_margin=0.25)
    ds = smoke_dataset(GRAPH_CHECK_BATCHES * batch, mcfg.seq_length, seed=11)
    arrays = {"gesture": ds.gestures, "prototype": ds.prototypes}
    if masked:
        rng = np.random.default_rng(12)
        lengths = rng.integers(min(VL_STEP_LENGTHS[0], mcfg.seq_length), mcfg.seq_length + 1,
                               len(ds.gestures))
        arrays["mask"] = (np.arange(mcfg.seq_length)[None, :]
                          < lengths[:, None]).astype(np.float32)
    batches = {k: torch.from_numpy(v).to(device).reshape(GRAPH_CHECK_BATCHES, batch, *v.shape[1:])
               for k, v in arrays.items()}
    epoch_fn, step_fn = ((gan_train_epoch_masked, gan_train_step_masked) if masked
                         else (gan_train_epoch, gan_train_step))
    return mcfg, tcfg, batches, epoch_fn, step_fn


def _state_diff(a: dict, b: dict) -> float:
    return max((x.detach() - y.detach()).abs().max().item() for m in MODELS
               for x, y in zip(tree_leaves(a[m]), tree_leaves(b[m])) if torch.is_tensor(x))


def eager_determinism(device, kind: str = "float32", batch: int = 512) -> dict:
    """Phase 5f's control: phase 5e-5g's epochs run eagerly twice from one
    state with cuDNN as the training runs it (not deterministic). A
    difference here is the eager step's own, which is why phase 5f runs with
    ``torch.backends.cudnn.deterministic``."""
    mcfg, tcfg, batches, _, step_fn = _graph_check_inputs(device, kind, batch, None)
    runs = [init_gan_state(0, mcfg, device), init_gan_state(0, mcfg, device)]
    losses = [[], []]
    for _ in range(GRAPH_CHECK_EPOCHS):
        for state, trace in zip(runs, losses):
            trace += [step_fn(state, {k: v[i] for k, v in batches.items()}, GRAPH_CHECK_LR,
                              mcfg, tcfg)[1] for i in range(GRAPH_CHECK_BATCHES)]
    loss_diff = max(abs(a[k].item() - b[k].item()) for a, b in zip(*losses) for k in a)
    line = {"check": "eager epoch vs eager epoch, cuDNN as trained (phase 5f's control)",
            "kind": kind, "batch": batch, "steps": GRAPH_CHECK_BATCHES * GRAPH_CHECK_EPOCHS,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "max_abs_loss_diff": loss_diff, "max_abs_state_diff": _state_diff(*runs)}
    print(json.dumps(line), flush=True)
    return line


def adam_forms(device, sizes=(4096, 333, 7), updates: int = 5, lr: float = 2e-4) -> dict:
    """``apply_update`` with a Python learning rate and an int step count
    against its captured form (a 0-d device learning rate and step count),
    ``updates`` updates from one state: bit-equal, or it raises. Beside it,
    how far ``_foreach_div`` by a Python number and by a 0-d device tensor
    lie apart on the card (the first multiplies by the reciprocal), which is
    why both forms multiply by the reciprocal of the bias correction."""
    gen = torch.Generator(device=device).manual_seed(5)
    params = [torch.randn(n, generator=gen, device=device) for n in sizes]
    runs = [([p.clone() for p in params], {"mu": [torch.zeros_like(p) for p in params],
                                           "nu": [torch.zeros_like(p) for p in params],
                                           "count": count})
            for count in (0, torch.zeros((), dtype=torch.int64, device=device))]
    (p0, o0), (p1, o1) = runs
    for _ in range(updates):
        grads = [torch.randn(n, generator=gen, device=device) for n in sizes]
        apply_update(p0, grads, o0, lr, 1.0)
        apply_update(p1, grads, o1, torch.tensor(lr, device=device), 1.0)
    equal = all(torch.equal(a, b) for a, b in zip(p0 + o0["mu"] + o0["nu"],
                                                  p1 + o1["mu"] + o1["nu"]))
    nu = o0["nu"][0]
    correction = 1.0 - 0.999 ** updates
    by_number = torch._foreach_div([nu], correction)[0]
    by_tensor = torch._foreach_div([nu], torch.tensor(correction, device=device))[0]
    line = {"check": "apply_update, Python lr and count vs device tensors", "updates": updates,
            "bit_equal": equal and int(o1["count"]) == o0["count"] == updates,
            "foreach_div_number_vs_tensor_max_abs": (by_number - by_tensor).abs().max().item()}
    print(json.dumps(line), flush=True)
    if not line["bit_equal"]:
        raise AssertionError(f"apply_update's two forms differ: {line}")
    return line


def _graphed_vs_eager(device, kind: str, batch: int, model: dict, mesh) -> dict:
    masked = kind == "masked"
    mcfg, tcfg, batches, epoch_fn, step_fn = _graph_check_inputs(device, kind, batch, model)
    graphed, eager = init_gan_state(0, mcfg, device), init_gan_state(0, mcfg, device)
    graph = StepGraph()
    counters = (fused_bilstm_fwd, bilstm_train_fwd, bilstm_train_bwd)
    before = [c.launches for c in counters]
    worst = {"max_abs_loss_diff": 0.0, "max_abs_state_diff": 0.0}
    t_graphed = t_eager = 0.0
    for _ in range(GRAPH_CHECK_EPOCHS):
        u = [t.clone() for t in tree_leaves(graphed["d1"]["sn"])]
        t0 = time.perf_counter()
        _, traces = epoch_fn(graphed, batches, GRAPH_CHECK_LR, mcfg, tcfg, mesh=mesh,
                             graph=graph)
        _sync(device)
        t1 = time.perf_counter()
        rows = [step_fn(eager, {k: v[i] for k, v in batches.items()}, GRAPH_CHECK_LR, mcfg,
                        tcfg, mesh=mesh)[1] for i in range(GRAPH_CHECK_BATCHES)]
        eager["epoch"] += 1
        _sync(device)
        t_graphed, t_eager = t_graphed + t1 - t0, t_eager + time.perf_counter() - t1
        for k, v in traces.items():
            want = torch.stack([r[k] for r in rows])
            worst["max_abs_loss_diff"] = max(worst["max_abs_loss_diff"],
                                             (v - want).abs().max().item())
        if all(torch.equal(a, b) for a, b in zip(tree_leaves(graphed["d1"]["sn"]), u)):
            raise AssertionError("the critics' u vectors did not move in a graphed epoch")
    worst["max_abs_state_diff"] = _state_diff(graphed, eager)
    for m in MODELS:
        if graphed[m]["opt"]["count"] != eager[m]["opt"]["count"]:
            raise AssertionError(f"{m}: Adam's count {graphed[m]['opt']['count']} graphed, "
                                 f"{eager[m]['opt']['count']} eager")
    steps = GRAPH_CHECK_BATCHES * GRAPH_CHECK_EPOCHS
    launches = dict(zip(("bilstm_fused", "bilstm_train_fwd", "bilstm_train_bwd"),
                        (c.launches - b for c, b in zip(counters, before))))
    line = {"check": "graphed epoch vs eager epoch on the card", "kind": kind, "batch": batch,
            "dtype": mcfg.compute_dtype, "steps": steps,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "process_group": mesh is not None, **worst,
            "bit_equal": worst["max_abs_loss_diff"] == 0.0 == worst["max_abs_state_diff"],
            "rng_equal": torch.equal(graphed["rng"], eager["rng"]),
            "captures": graph.captures, "replays": graph.replays, "launches": launches,
            "ms_per_step_graphed_with_capture": t_graphed / steps * 1e3,
            "ms_per_step_eager": t_eager / steps * 1e3}
    print(json.dumps(line), flush=True)
    if not (line["bit_equal"] and line["rng_equal"]):
        raise AssertionError(f"the graphed epoch differs from the eager one: {line}")
    if device.type == "cuda":
        want = dict.fromkeys(launches, 0) if masked else {
            name: 2 * per * steps for name, per in PER_STEP.items()}
        if graph.captures != 1 or graph.replays != steps - 1 or launches != want:
            raise AssertionError(f"{graph.captures} captures, {graph.replays} replays, "
                                 f"launches {launches} (graphed and eager), expected {want}")
    return line


# Phase 5h: the threefry kernel (ops/threefry.py, the JAX package's random
# draws) against its plain version, the card's draws against the CPU's, and
# the graphed flagship step with its draws inside the graph.
STEP_DRAWS = 2 * FLAGSHIP_TRAIN["n_critic"] + 4     # a flagship step's (B, Z) normals
# Operations per drawn number, counted from csrc/threefry.cu: the hash's 20
# rounds of add, two shifts, or and xor plus 5 key injections (118 integer
# operations), the uniform's 8, and the normal's erfinv with XLA's log1p and
# log (about 70 more); the card's 32-bit CUDA-core rate is taken as its
# float32 peak (PEAK_FLOPS), which the integer pipes do not exceed.
THREEFRY_OPS = {"bits": 118, "uniform": 126, "normal": 196}
THREEFRY_CHECKS = (("normal", (STEP_DRAWS,), (TIME_BATCH, LATENT)),
                   ("normal", (), (5, TIME_BATCH, LATENT)),
                   ("bits", (), (20331,)), ("uniform", (), (384, 256)),
                   ("normal", (3,), (7,)), ("bits", (2,), (3, 1)))


def _draw(kind: str, keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    if kind == "bits":
        return prng.random_bits(keys, shape)
    if kind == "uniform":
        return prng.uniform(keys, shape, -1 / np.sqrt(384), 1 / np.sqrt(384))
    return prng.normal(keys, shape)


def threefry_bound_ms(kind: str, numbers: int, n_keys: int) -> tuple:
    nbytes = numbers * (8 if kind == "bits" else 4) + n_keys * 16
    return _bound(nbytes, numbers * THREEFRY_OPS[kind], PEAK_FLOPS["float32"])


def check_threefry(device) -> dict:
    """The kernel against its plain version on the same keys: bits and
    uniforms bit-equal, normals within 1 ulp; then its time at the train
    step's draw (14 keys x 512 x 32) and at (5, 512, 32), beside the plain
    version on the host, ``torch.randn`` of the shape (another generator, a
    yardstick only) and the bound."""
    results = []
    for kind, stack, shape in THREEFRY_CHECKS:
        keys = prng.split(prng.PRNGKey(42), stack[0]) if stack else prng.PRNGKey(42)
        want = _draw(kind, keys, shape)
        got = _draw(kind, keys.to(device), shape).cpu()
        if kind == "normal":
            ulp = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max().item()
        else:
            ulp = 0 if torch.equal(got, want) else None
        results.append({"kind": kind, "keys": stack[0] if stack else 1, "shape": list(shape),
                        "max_ulp": ulp, "max_abs_err": (got.double() - want.double()).abs()
                        .max().item()})
        if ulp is None or ulp > (1 if kind == "normal" else 0):
            raise AssertionError(f"threefry kernel vs plain: {results[-1]}")
    timings = {}
    for label, stack, shape in (("step", STEP_DRAWS, (TIME_BATCH, LATENT)),
                                ("5x512x32", None, (5, TIME_BATCH, LATENT))):
        keys = prng.split(prng.PRNGKey(7), stack) if stack else prng.PRNGKey(7)
        numbers = (stack or 1) * int(np.prod(shape))
        dev_keys = keys.to(device)
        t0 = time.perf_counter()
        for _ in range(3):
            prng.normal(keys, shape)
        plain_ms = (time.perf_counter() - t0) / 3 * 1e3
        bound, by = threefry_bound_ms("normal", numbers, stack or 1)
        timings[label] = {
            "numbers": numbers, "ms": time_ms(lambda: prng.normal(dev_keys, shape), 200),
            "plain_host_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "torch_randn_ms": time_ms(lambda: torch.randn(((stack or 1), *shape),
                                                          device=device), 200)}
    line = {"check": "threefry kernel vs plain version", "checks": results, "timing": timings}
    print(json.dumps(line), flush=True)
    return line


def draws_card_vs_cpu(device) -> dict:
    """``init_gan_state(42)`` at full width on the card and on the CPU (the
    initializers draw on the CPU either way), then one flagship step's keys
    split off its key and drawn on both: weights bit-equal, noise within 1
    ulp (the kernel against the plain version)."""
    mcfg = ModelConfig(time_head="monotone")
    cpu, card = init_gan_state(42, mcfg, "cpu"), init_gan_state(42, mcfg, device)
    equal = all(torch.equal(a.detach(), b.detach().cpu()) for m in MODELS
                for a, b in zip(tree_leaves(cpu[m]), tree_leaves(card[m])) if torch.is_tensor(a))
    _, keys = step_keys(cpu["rng"], FLAGSHIP_TRAIN["n_critic"], True)
    want = step_noise(keys, TIME_BATCH, mcfg.latent_dim, FLAGSHIP_TRAIN["n_critic"])
    got = step_noise(keys.to(device), TIME_BATCH, mcfg.latent_dim, FLAGSHIP_TRAIN["n_critic"])
    ulp = max((g.cpu().view(torch.int32).long() - w.view(torch.int32).long()).abs().max().item()
              for g, w in ((got[k], want[k]) for k in want))
    line = {"check": "init_gan_state(42) and one step's draws, card vs CPU",
            "state_bit_equal": equal and torch.equal(cpu["rng"], card["rng"]),
            "step_noise_max_ulp": ulp, "step_keys": keys.shape[0]}
    print(json.dumps(line), flush=True)
    if not line["state_bit_equal"] or ulp > 1:
        raise AssertionError(f"the card's draws differ from the CPU's: {line}")
    return line


# -- bfloat16 arithmetic as JAX's: the activations and the bf16 steps ----------------------
#
# The port computes gelu and leaky_relu op by op in the array's dtype, with
# the constants rounded to it, as JAX does (models/layers.py). Phase 5i holds
# the card's results bit-equal to the CPU's for every bfloat16 input and for
# 2^20 float32 inputs, gradients included (NaN equals NaN). Phase 5j runs one
# bfloat16 step of the flagship recipe and one of the variable-length recipe
# (masked, lambda_speed 2) on the card and on the CPU from one state. A bf16
# rounding that flips on one side moves everything after it, so each model's
# gradient distance (relative L2 of Adam's first moments after a step at
# lr=0) and each loss are held to the CPU's own step from the state nudged
# by one float32 rounding step: the card may be BF16_CONTROL_FACTOR times as
# far from the CPU as that control is, plus BF16_FLOOR.
ACT_F32_N = 1 << 20
BF16_CONTROL_FACTOR, BF16_FLOOR = 4.0, 0.02


def _mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (NaN counts as equal to NaN)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over elements whose bits differ: 0.0 where they
    are all equal (NaN to NaN counts as equal), inf where a NaN or an
    infinity meets another value."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    differ = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    if not differ.any():
        return 0.0
    err = (a[differ] - b[differ]).abs()
    return float(torch.where(torch.isnan(err), torch.inf, err).max())


def _forward_backward(fn, x: torch.Tensor, g: torch.Tensor) -> tuple:
    xx = x.detach().clone().requires_grad_()
    y = fn(xx)
    y.backward(g)
    return y, xx.grad


def check_activations(device) -> dict:
    """Phase 5i: ``layers.gelu`` and ``layers.leaky_relu`` on the card (the
    kernels) against the CPU (the plain chain) and against the plain chain
    on the card, forward and gradient, bit for bit: all 65,536 bfloat16
    inputs, and 2^20 float32 inputs from N(0, 3^2) with zeros, infinities,
    NaN and the extremes, each against a cotangent drawn in numpy. Every
    card call of the dispatchers must have taken the kernels. The line's
    ``max_abs_err`` holds each kernel's largest error against either plain
    chain, over both dtypes."""
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    rng = np.random.default_rng(13)
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-38, -1e-38, 1e-45, 3.4e38, -3.4e38]
    f32 = torch.from_numpy(np.concatenate([rng.normal(0, 3, ACT_F32_N), special]).astype(np.float32))
    plain = {"gelu": layers.plain_gelu, "leaky_relu": layers.plain_leaky_relu}
    out = {}
    errs = dict.fromkeys(activations.OPS, 0.0)
    reset_launches(activation_launches)
    for x in (every, f32):
        g = torch.from_numpy(rng.normal(size=x.shape[0]).astype(np.float32)).to(x.dtype)
        for name, fn in (("gelu", gelu), ("leaky_relu", leaky_relu)):
            cpu = _forward_backward(fn, x, g)
            card = _forward_backward(fn, x.to(device), g.to(device))
            card_plain = _forward_backward(plain[name], x.to(device), g.to(device))
            out[f"{name}_{str(x.dtype).split('.')[-1]}"] = {
                "inputs": x.shape[0], "forward_mismatches": _mismatches(cpu[0], card[0]),
                "gradient_mismatches": _mismatches(cpu[1], card[1]),
                "kernel_vs_plain_on_card_forward_mismatches": _mismatches(card_plain[0], card[0]),
                "kernel_vs_plain_on_card_gradient_mismatches": _mismatches(card_plain[1], card[1])}
            op = "gelu" if name == "gelu" else "leaky"
            for i, direction in enumerate(("fwd", "bwd")):
                errs[f"{op}_{direction}"] = max(errs[f"{op}_{direction}"],
                                                _max_abs_err(cpu[i], card[i]),
                                                _max_abs_err(card_plain[i], card[i]))
    calls = {f"{op}/{path}": n for (op, path), n in activation_launches.launches_by_path.items()}
    line = {"check": "gelu and leaky_relu: kernels on the card vs plain on the CPU and on the "
                     "card, bit for bit", **out, "calls": calls, "max_abs_err": errs}
    print(json.dumps(line), flush=True)
    bad = [k for k, v in out.items() if any(v[m] for m in v if m.endswith("mismatches"))]
    if bad:
        raise AssertionError(f"activations differ on the card: {bad}")
    want = {f"{op}/{path}": 2 for op in activations.OPS for path in activations.PATHS}
    if device.type == "cuda" and calls != want:
        raise AssertionError(f"activation calls {calls}, expected {want}")
    return line


# The activation kernels' timings: the transformer's critic-loop call, both
# fakes (2B = 1024 rows, L = 128, 4 x d_model = 256), bfloat16. The bound is
# the bytes: the tensors each kernel reads and writes once.
ACT_TIME_SHAPE = (2 * TIME_BATCH, SEQ, 256)
ACT_TENSORS_MOVED = {"gelu_fwd": 2, "gelu_bwd": 3, "leaky_fwd": 2, "leaky_bwd": 3}


def time_activations(device, shape=ACT_TIME_SHAPE, iters: int = 50) -> list:
    """The card's path of each activation and direction (``ops/activations.py``:
    a kernel of ``csrc/activations.cu``, or ``F.leaky_relu`` for leaky_relu's
    forward) at ``shape`` in bfloat16, against the plain chain doing the same
    work (its backward through autograd, as a step runs it) and the bound in
    bytes."""
    gen = torch.Generator(device=device).manual_seed(17)
    x = (torch.randn(shape, generator=gen, device=device) * 2).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    xg = x.detach().requires_grad_()
    plain_out = {"gelu": layers.plain_gelu(xg), "leaky": layers.plain_leaky_relu(xg)}
    slope = layers._in_dtype(0.2, torch.bfloat16)
    n = x.numel()
    lines = []
    for op in activations.OPS:
        act = op.split("_")[0]
        if op.endswith("fwd"):
            fn = layers.plain_gelu if act == "gelu" else layers.plain_leaky_relu
            with torch.no_grad():
                plain_ms = time_ms(lambda: fn(x), iters)
        else:
            plain_ms = time_ms(lambda: torch.autograd.grad(plain_out[act], xg, g,
                                                           retain_graph=True), iters)
        if op in activations.KERNEL_OPS:
            route = "cuda"
            card = lambda op=op: activations._launch(op, x, None if op == "gelu_fwd" else g, slope)
        else:
            route = "F.leaky_relu"
            card = lambda: F.leaky_relu(x, slope)
        with torch.no_grad():
            ms = time_ms(card, iters)
        bound = ACT_TENSORS_MOVED[op] * n * x.element_size() / PEAK_BYTES_PER_S * 1e3
        line = {"timing": f"activation {op}", "route": route, "dtype": "bfloat16",
                "shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes", "ms_over_bound": ms / bound}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


class plain_activations:
    """Inside: every module of the port that bound ``layers.gelu`` or
    ``layers.leaky_relu`` calls the plain functions instead (phase 5l's
    control, for the smoke only)."""

    PATCHED = {"gelu": layers.plain_gelu, "leaky_relu": layers.plain_leaky_relu}

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod in (layers, gan_models, generators)
                      for name in self.PATCHED if hasattr(mod, name)]
        for mod, name, _ in self.saved:
            setattr(mod, name, self.PATCHED[name])
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# -- the attention core (csrc/attention.cu) against the plain chain ----------------------
#
# Phase 5m. The kernels sum the chain's products and its softmax in another
# order, so a value may differ from the chain's in its last bit, and a bf16
# rounding of P, dP or a result that flips there moves by one bf16 step.
# Each result (the forward's output, dq, dk, dv) is held to the plain chain
# on the card (``generators.plain_attention`` under ``jax_products()``, its
# backward by autograd) as ||kernel - chain|| / ||chain|| over the tensor,
# within ATTN_LIMIT of the dtype: in bfloat16 2e-3, what a one-step flip
# (2^-8) in a quarter of the elements reads (read on an H100: 3.5e-5 to
# 6.1e-5 at L = 128, up to 1.9e-4 at other shapes, where a few flips are a
# larger share of fewer elements); in float32 1e-5 (read: up to 4.6e-7, the
# sums' order). Two controls run the chain with one rounding more, of P
# (both ways) or of the logits to float8 (e4m3): each must land beyond the
# limit in every result (read: 2.6e-2 and more).
# Inputs: q, k, v from N(0, 1.5^2); masks of the cell's length mix (83.6% of
# rows at full length, the rest 12 to L - 1), a row of padding keys only
# where the batch has three rows or more.
ATTN_LIMIT = {"bfloat16": 2e-3, "float32": 1e-5}
# (B, L, H, h, dtype, masked): the critic loop's call and the joint step's,
# head 8, float32; then lengths and heads around the kernels' tiles.
ATTN_CHECKS = ((1024, 128, 4, 16, "bfloat16", True), (512, 128, 4, 16, "bfloat16", True),
               (512, 128, 8, 8, "bfloat16", True), (512, 128, 4, 16, "bfloat16", False),
               (512, 128, 4, 16, "float32", True), (512, 128, 8, 8, "float32", True),
               (3, 12, 2, 8, "bfloat16", True), (7, 33, 2, 16, "bfloat16", True),
               (9, 65, 4, 24, "bfloat16", True), (4, 64, 2, 32, "bfloat16", True),
               (3, 100, 2, 48, "bfloat16", True), (2, 129, 2, 56, "bfloat16", True),
               (5, 200, 3, 40, "bfloat16", True), (3, 256, 1, 64, "bfloat16", True),
               (1, 1, 1, 8, "bfloat16", False), (3, 12, 2, 8, "float32", True),
               (7, 33, 2, 24, "float32", True), (3, 256, 1, 64, "float32", True))
ATTN_TIME_SHAPES = ((2 * TIME_BATCH, SEQ, 4, 16), (TIME_BATCH, SEQ, 4, 16))


def attention_inputs(device, batch: int, seq: int, heads: int, head: int, dtype: torch.dtype,
                     masked: bool = True, seed: int = 0) -> tuple:
    """(qkv, mask or None, the output's cotangent) for phase 5m, drawn on
    ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = (torch.randn(batch, seq, 3, heads, head, generator=gen, device=device) * 1.5).to(dtype)
    g = torch.randn(batch, seq, heads * head, generator=gen, device=device).to(dtype)
    if not masked:
        return qkv, None, g
    full = torch.rand(batch, generator=gen, device=device) < 0.836
    short = torch.randint(min(12, seq), seq + 1, (batch,), generator=gen, device=device)
    lengths = torch.where(full, seq, short)
    if batch >= 3:
        lengths[2] = 0
    mask = (torch.arange(seq, device=device)[None, :] < lengths[:, None]).to(torch.float32)
    return qkv, mask, g


def _to_float8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, its gradient passed straight through."""
    return x + (x.to(torch.float8_e4m3fn).to(x.dtype) - x).detach()


class _Float8Softmax(torch.autograd.Function):
    """softmax rounded to float8 e4m3, forward and backward: the gradient
    P (g - sum P g) of the rounded P, as a kernel that rounds P would give."""

    @staticmethod
    def forward(ctx, logits):
        p = torch.softmax(logits, dim=-1).to(torch.float8_e4m3fn).to(logits.dtype)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return p * (g - (p * g).sum(dim=-1, keepdim=True))


def attention_control(qkv: torch.Tensor, mask, rounded: str) -> torch.Tensor:
    """``generators.plain_attention`` with P ("P") or the logits ("logits")
    rounded to float8: phase 5m's controls."""
    B, L, _, H, h = qkv.shape
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    logits = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) / math.sqrt(h)
    if rounded == "logits":
        logits = _to_float8(logits)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, -1e30)
    attn = _Float8Softmax.apply(logits) if rounded == "P" else torch.softmax(logits, dim=-1)
    return (attn.to(v.dtype) @ v).transpose(1, 2).reshape(B, L, H * h)


def _attention_results(fn, qkv: torch.Tensor, mask, g: torch.Tensor) -> dict:
    """{"out", "dq", "dk", "dv"} of ``fn(qkv, mask)`` against cotangent ``g``."""
    x = qkv.detach().requires_grad_()
    with layers.jax_products():
        out = fn(x, mask)
        (dqkv,) = torch.autograd.grad(out, x, g)
    return {"out": out.detach(), "dq": dqkv[:, :, 0], "dk": dqkv[:, :, 1], "dv": dqkv[:, :, 2]}


def attention_case(device, batch: int, seq: int, heads: int, head: int, dtype_name: str,
                   masked: bool = True, seed: int = 0) -> dict:
    """One case of phase 5m: the dispatcher (the kernels on the card) and the
    controls against the plain chain, each result's relative distance; two
    backward launches bit-equal; the launches counted."""
    dtype = getattr(torch, dtype_name)
    qkv, mask, g = attention_inputs(device, batch, seq, heads, head, dtype, masked, seed)
    want = _attention_results(generators.plain_attention, qkv, mask, g)
    dispatched = lambda x, m: attention_ops.attention(x, m, generators.plain_attention)
    reset_launches(attention_launches)
    got = _attention_results(dispatched, qkv, mask, g)
    calls = {f"{op}/{p}": n for (op, p), n in attention_launches.launches_by_path.items() if n}
    again = _attention_results(dispatched, qkv, mask, g)
    line = {"check": "attention kernels vs the plain chain on the card",
            "shape": [batch, seq, heads, head], "dtype": dtype_name, "masked": masked,
            "limit": ATTN_LIMIT[dtype_name], "calls": calls,
            "rel_l2": {k: _rel_l2([got[k].double()], [want[k].double()]) for k in want},
            "max_abs_err": {k: float((got[k].double() - want[k].double()).abs().max())
                            for k in want},
            "finite": all(bool(torch.isfinite(t).all()) for t in got.values()),
            "deterministic": all(torch.equal(got[k], again[k]) for k in got)}
    for rounded in ("P", "logits"):
        control = _attention_results(lambda x, m: attention_control(x, m, rounded), qkv, mask, g)
        line[f"control_{rounded}_rel_l2"] = {
            k: _rel_l2([control[k].double()], [want[k].double()]) for k in want}
    return line


def check_attention(device, cases=ATTN_CHECKS, strict: bool = True) -> list:
    """Phase 5m: every case of ``cases`` (``attention_case``); each result
    within the limit, finite and bit-equal across two launches, each control
    beyond it wherever the case is large enough to show it (L >= 64), one
    kernel launch each way a call and no plain call."""
    lines = []
    for case in cases:
        line = attention_case(device, *case)
        print(json.dumps(line), flush=True)
        lines.append(line)
        limit = line["limit"]
        bad = [k for k, v in line["rel_l2"].items() if not v <= limit]
        if case[1] >= 64:
            bad += [f"control_{r}:{k}" for r in ("P", "logits")
                    for k, v in line[f"control_{r}_rel_l2"].items() if not v > limit]
        if not (line["finite"] and line["deterministic"]):
            bad.append("finite/deterministic")
        if device.type == "cuda" and line["calls"] != {"attention_fwd/cuda": 1,
                                                       "attention_bwd/cuda": 1}:
            bad.append(f"calls {line['calls']}")
        if bad and strict:
            raise AssertionError(f"attention {case}: {bad}")
    return lines


def time_attention(device, shapes=ATTN_TIME_SHAPES, iters: int = 50) -> list:
    """The attention kernels at the masked step's calls, in bfloat16 with the
    cell's masks: each direction's ms (CUDA events) beside its bound
    (``portbench.attention_bounds``), the plain chain doing the same work
    (its backward through autograd, as a step runs it) and
    ``F.scaled_dot_product_attention`` with a boolean mask, the one-call
    library yardstick (not bit-compatible: the port never calls it)."""
    from portbench.attention_bounds import attention_bounds_ms

    lines = []
    for batch, seq, heads, head in shapes:
        qkv, mask, g = attention_inputs(device, batch, seq, heads, head, torch.bfloat16, seed=3)
        mask[2] = 1.0     # SDPA gives NaN for a row of padding keys only
        qkv = qkv.contiguous()
        bounds = attention_bounds_ms(batch, seq, heads, head, "bfloat16")
        xg = qkv.detach().requires_grad_()
        with layers.jax_products():
            plain_out = generators.plain_attention(xg, mask)
        q, k, v = (xg[:, :, i].transpose(1, 2) for i in range(3))
        keep = (mask > 0)[:, None, None, :]
        sdpa_out = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        g4 = g.reshape(batch, seq, heads, head).transpose(1, 2)
        with torch.no_grad(), layers.jax_products():
            runs = {
                "fwd": (lambda: attention_ops._launch("attention_fwd", qkv, mask),
                        lambda: generators.plain_attention(qkv, mask),
                        lambda: F.scaled_dot_product_attention(q.detach(), k.detach(),
                                                               v.detach(), attn_mask=keep)),
                "bwd": (lambda: attention_ops._launch("attention_bwd", qkv, mask, g),
                        None, None)}
            times = {d: [time_ms(fn, iters) if fn else None for fn in fns]
                     for d, fns in runs.items()}
        with layers.jax_products():
            times["bwd"][1] = time_ms(lambda: torch.autograd.grad(
                plain_out, xg, g, retain_graph=True), iters)
            times["bwd"][2] = time_ms(lambda: torch.autograd.grad(
                sdpa_out, xg, g4, retain_graph=True), iters)
        for direction, (ms, plain_ms, library_ms) in times.items():
            bound, by = bounds[direction]
            line = {"timing": f"attention {direction}", "route": "cuda", "dtype": "bfloat16",
                    "shape": [batch, seq, heads, head], "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
                    "ms_over_bound": ms / bound}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


# -- the layer norm (csrc/layernorm.cu) against the plain chain --------------------------
#
# Phase 5n. The kernels take the row's moments and the column sums of the
# backward in another order than the chain's reductions, so a value may
# differ from the chain's in its last bit, and a bf16 rounding that flips
# there moves by one bf16 step. Each result (the output, dx, dscale, dbias)
# is held to the plain chain on the card (``ops.layernorm.plain_layernorm``,
# its backward by autograd) as ||kernel - chain|| / ||chain|| over the
# tensor, within LN_LIMIT of the dtype: the attention's limits (ATTN_LIMIT)
# and reasons. The control runs the chain with two roundings more: the
# normalized value to float8 (e4m3, its gradient passed through) and the
# cotangent to float8; it must land beyond the limit in every result.
# Inputs: x from N(0.5, 2^2), the scale from N(1, 0.1^2), the bias from
# N(0, 0.1^2), the cotangent from N(0, 1), drawn on the card from a seed.
LN_LIMIT = ATTN_LIMIT
# (rows, D, dtype): the critic loop's call (2B x L rows) and the joint
# step's (B x L) at d_model 64 in bfloat16, the final norm's in float32;
# then odd and wide D, a row or a few.
LN_CHECKS = ((131072, 64, "bfloat16"), (65536, 64, "bfloat16"), (131072, 64, "float32"),
             (65536, 64, "float32"), (1000, 37, "bfloat16"), (1000, 37, "float32"),
             (999, 100, "bfloat16"), (333, 1024, "bfloat16"), (333, 1024, "float32"),
             (7, 48, "bfloat16"), (5, 6, "float32"), (3, 1, "bfloat16"), (1, 64, "bfloat16"))
# (rows, D, dtype, direction, saves statistics): the masked step's calls.
LN_TIME_CASES = ((131072, 64, "bfloat16", "fwd", False), (65536, 64, "bfloat16", "fwd", True),
                 (65536, 64, "bfloat16", "bwd", True), (131072, 64, "float32", "fwd", False),
                 (65536, 64, "float32", "bwd", True))
L2_BYTES = 50e6


def layernorm_inputs(device, rows: int, d: int, dtype: torch.dtype, seed: int = 0) -> tuple:
    """(x, scale, bias, the output's cotangent) for phase 5n, drawn on
    ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(rows, d, generator=gen, device=device) * 2 + 0.5).to(dtype)
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device=device)).to(dtype)
    bias = (0.1 * torch.randn(d, generator=gen, device=device)).to(dtype)
    g = torch.randn(rows, d, generator=gen, device=device).to(dtype)
    return x, scale, bias, g


def layernorm_control(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """``plain_layernorm`` with the normalized value rounded to float8:
    phase 5n's control (its caller rounds the cotangent too)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = _to_float8((xf - mean) * torch.rsqrt(var + eps))
    return out.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def _layernorm_results(fn, x, scale, bias, g) -> dict:
    """{"out", "dx", "dscale", "dbias"} of ``fn(x, scale, bias)`` against
    cotangent ``g``."""
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    return {"out": out.detach(), **dict(zip(("dx", "dscale", "dbias"), grads))}


def layernorm_case(device, rows: int, d: int, dtype_name: str, seed: int = 0) -> dict:
    """One case of phase 5n: the dispatcher (the kernels on the card) and the
    control against the plain chain, each result's relative distance; two
    launches bit-equal; the calls counted."""
    x, scale, bias, g = layernorm_inputs(device, rows, d, getattr(torch, dtype_name), seed)
    want = _layernorm_results(layernorm_ops.plain_layernorm, x, scale, bias, g)
    reset_launches(layernorm_launches)
    got = _layernorm_results(layernorm_ops.layernorm, x, scale, bias, g)
    calls = {f"{op}/{p}": n for (op, p), n in layernorm_launches.launches_by_path.items() if n}
    again = _layernorm_results(layernorm_ops.layernorm, x, scale, bias, g)
    g8 = g.to(torch.float8_e4m3fn).to(g.dtype)
    control = _layernorm_results(layernorm_control, x, scale, bias, g8)
    rel = lambda a, b: _rel_l2([a.double()], [b.double()])
    return {"check": "layer norm kernels vs the plain chain on the card", "shape": [rows, d],
            "dtype": dtype_name, "limit": LN_LIMIT[dtype_name], "calls": calls,
            "rel_l2": {k: rel(got[k], want[k]) for k in want},
            "max_abs_err": {k: float((got[k].double() - want[k].double()).abs().max())
                            for k in want},
            "control_rel_l2": {k: rel(control[k], want[k]) for k in want},
            "finite": all(bool(torch.isfinite(t).all()) for t in got.values()),
            "deterministic": all(torch.equal(got[k], again[k]) for k in got)}


def check_layernorm(device, cases=LN_CHECKS, strict: bool = True) -> list:
    """Phase 5n: every case of ``cases`` (``layernorm_case``); each result
    within the limit, finite and bit-equal across two launches, the control
    beyond it in every result wherever the case has rows enough to show it
    (64 or more), one call each way and no plain call; a float16 tensor on
    the card raises ValueError."""
    lines = []
    for case in cases:
        line = layernorm_case(device, *case)
        print(json.dumps(line), flush=True)
        lines.append(line)
        limit = line["limit"]
        bad = [k for k, v in line["rel_l2"].items() if not v <= limit]
        if case[0] >= 64:
            bad += [f"control:{k}" for k, v in line["control_rel_l2"].items() if not v > limit]
        if not (line["finite"] and line["deterministic"]):
            bad.append("finite/deterministic")
        if device.type == "cuda" and line["calls"] != {"layernorm_fwd/cuda": 1,
                                                       "layernorm_bwd/cuda": 1}:
            bad.append(f"calls {line['calls']}")
        if bad and strict:
            raise AssertionError(f"layer norm {case}: {bad}")
    if device.type == "cuda":
        try:
            layernorm_ops.layernorm(torch.zeros(4, 64, dtype=torch.float16, device=device),
                                    torch.ones(64, device=device), torch.zeros(64, device=device))
        except ValueError:
            pass
        else:
            raise AssertionError("a float16 tensor took the layer norm kernels")
    return lines


def layernorm_bound_ms(rows: int, d: int, dtype_name: str, direction: str,
                       stats: bool) -> float:
    """Least time for the call's bytes: each input read once, each output
    written once (the forward's statistics with ``stats``; the backward reads
    x, g and them, writes dx, dscale, dbias)."""
    item = 2 if dtype_name == "bfloat16" else 4
    tensor = rows * d * item
    if direction == "fwd":
        nbytes = 2 * tensor + 2 * d * item + (8 * rows if stats else 0)
    else:
        nbytes = 3 * tensor + 8 * rows + 3 * d * item
    return nbytes / PEAK_BYTES_PER_S * 1e3


def graphed_ms(calls: list, replays: int = 5) -> float:
    """Mean ms per call of ``calls`` (thunks on the card), captured in order
    as one CUDA graph and replayed (CUDA events): device time with the
    gaps of a replayed graph, none of the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * len(calls))


def time_layernorm(device, cases=LN_TIME_CASES, calls: int = 24) -> list:
    """The layer norm kernels at the masked step's calls: each call's ms
    (``graphed_ms`` over ``calls`` calls whose inputs rotate over copies
    that exceed the L2 cache, so each launch reads them from device memory;
    ``warm_ms`` on one copy) beside its bound in bytes, the plain chain
    doing the same work (its backward through autograd, as a step runs it)
    and ``F.layer_norm``, the one-call library yardstick (another
    arithmetic: the port never calls it), these two launched eagerly
    (``time_ms``) on the rotated inputs: their kernels outlast the host's
    launches."""
    eps = 1e-5
    lines = []
    for rows, d, dtype_name, direction, stats in cases:
        dtype = getattr(torch, dtype_name)
        per_call = (3 if direction == "bwd" else 2) * rows * d * (2 if dtype == torch.bfloat16
                                                                   else 4)
        copies = max(2, math.ceil(2 * L2_BYTES / per_call))
        inputs = [layernorm_inputs(device, rows, d, dtype, seed=i) for i in range(copies)]
        leaves = [[t.detach().requires_grad_() for t in inp[:3]] for inp in inputs]
        if direction == "fwd":
            kernel = lambda i: layernorm_ops._forward(*inputs[i][:3], eps, stats)
            plain = lambda i: layernorm_ops.plain_layernorm(*inputs[i][:3], eps)
            library = lambda i: F.layer_norm(inputs[i][0], (d,), *inputs[i][1:3], eps)
        else:
            saved = [layernorm_ops._forward(*inp[:3], eps, True) for inp in inputs]
            plain_out = [layernorm_ops.plain_layernorm(*lv, eps) for lv in leaves]
            lib_out = [F.layer_norm(lv[0], (d,), lv[1], lv[2], eps) for lv in leaves]
            kernel = lambda i: layernorm_ops._backward(inputs[i][0], inputs[i][1], inputs[i][3],
                                                       *saved[i][1:])
            plain = lambda i: torch.autograd.grad(plain_out[i], leaves[i], inputs[i][3],
                                                  retain_graph=True)
            library = lambda i: torch.autograd.grad(lib_out[i], leaves[i], inputs[i][3],
                                                    retain_graph=True)
        turn = itertools.count()
        cycled = lambda fn: lambda: fn(next(turn) % copies)
        with torch.no_grad():
            ms = graphed_ms([lambda i=i: kernel(i % copies) for i in range(calls)])
            warm_ms = graphed_ms([lambda: kernel(0)] * calls)
        with torch.set_grad_enabled(direction == "bwd"):
            plain_ms = time_ms(cycled(plain), calls)
            library_ms = time_ms(cycled(library), calls)
        bound = layernorm_bound_ms(rows, d, dtype_name, direction, stats)
        line = {"timing": f"layernorm {direction}", "route": "cuda", "dtype": dtype_name,
                "shape": [rows, d], "statistics": stats, "ms": ms, "warm_ms": warm_ms,
                "input_copies": copies, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound, "bound_by": "bytes", "ms_over_bound": ms / bound}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


# -- the bias adds (csrc/bias.cu) against the plain chain --------------------------------
#
# Phase 5o. The kernel rounds where the chain rounds (each add float32, then
# the dtype), so every result equals the chain's bit for bit: the output
# and its layout, dy, db (the chain's own reduction) and the residual's
# cotangent, compared with torch.equal on the card. Inputs from N(0, 1)
# drawn on the card from a seed, rounded to the dtype.
#
# (layout, shape, dtype, b's dimensions, residual): "rows" a row-major y;
# "ncl" a convolution's (B, C, L) output read as its (B, L, C) view, b (C,);
# "unaligned" a row-major y starting one element into its allocation. The
# masked step's calls at d_model 64 (2B and B tokens of L = 128 through the
# embedding and attn_out (64), qkv (192), mlp1 (256); the float32 output
# head (3); the critics' conv outputs; the positions (L, D); the residual
# adds), then the small, odd and empty.
BIAS_CHECKS = (("rows", (65536, 64), "bfloat16", 1, False),
               ("rows", (65536, 192), "bfloat16", 1, False),
               ("rows", (65536, 256), "bfloat16", 1, False),
               ("rows", (131072, 64), "bfloat16", 1, False),
               ("rows", (131072, 192), "bfloat16", 1, False),
               ("rows", (131072, 256), "bfloat16", 1, False),
               ("rows", (65536, 3), "float32", 1, False),
               ("rows", (131072, 3), "float32", 1, False),
               ("ncl", (512, 64, 128), "bfloat16", 1, False),
               ("ncl", (512, 32, 128), "bfloat16", 1, False),
               ("rows", (512, 128, 64), "bfloat16", 2, False),
               ("rows", (65536, 64), "bfloat16", 1, True),
               ("rows", (131072, 64), "bfloat16", 1, True),
               ("rows", (65536, 64), "float32", 1, True),
               ("unaligned", (1000, 64), "bfloat16", 1, False),
               ("unaligned", (1000, 64), "bfloat16", 1, True),
               ("rows", (512, 1), "bfloat16", 1, False),
               ("rows", (7, 5), "float32", 1, False),
               ("ncl", (3, 5, 7), "bfloat16", 1, False),
               ("rows", (0, 64), "bfloat16", 1, False))
# The masked step's calls (the first fourteen checks), timed.
BIAS_TIME_CASES = BIAS_CHECKS[:14]
# The adds of one graphed step of each recipe at n_critic 5: the varlen2
# transformer makes 11 bias adds and 8 residual adds a forward (embedding,
# positions, each block's qkv and mlp1 and, with the residual, attn_out and
# mlp2, the output head) in 7 forwards a step; the rest are the critics'
# and the encoder's layers.
BIAS_CALLS_PER_STEP = {"flag": {"bias/cuda": 170},
                       "varlen2": {"bias/cuda": 239, "bias_residual/cuda": 56}}


def bias_inputs(device, layout: str, shape: tuple, dtype: torch.dtype, b_dims: int,
                residual: bool, seed: int = 0) -> tuple:
    """(y, b, residual or None, the output's cotangent) for phase 5o, drawn
    on ``device`` from ``seed``; y (and the residual) in ``layout``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*size):
        if layout == "unaligned":
            return torch.randn(math.prod(size) + 1, generator=gen, device=device).to(
                dtype)[1:].view(size)
        t = torch.randn(*size, generator=gen, device=device).to(dtype)
        return t.transpose(1, 2) if layout == "ncl" else t

    y = draw(*shape)
    b = torch.randn(y.shape[y.dim() - b_dims:], generator=gen, device=device).to(dtype)
    r = draw(*shape) if residual else None
    g = torch.randn(y.shape, generator=gen, device=device).to(dtype)
    return y, b, r, g


def _bias_results(fn, y, b, r, g) -> dict:
    """{"out", "dy", "db"[, "dres"]} of ``fn(y, b, r)`` against cotangent ``g``."""
    leaves = [t.detach().requires_grad_() for t in (y, b) + (() if r is None else (r,))]
    out = fn(*leaves[:2], leaves[2] if r is not None else None)
    grads = torch.autograd.grad(out, leaves, g)
    return {"out": out.detach(), **dict(zip(("dy", "db", "dres"), grads))}


def bias_case(device, layout: str, shape: tuple, dtype_name: str, b_dims: int, residual: bool,
              seed: int = 0) -> dict:
    """One case of phase 5o: the dispatcher (the kernel on the card) against
    the plain chain, bit for bit, the output's layout too; two launches
    bit-equal; the kernel's path; the calls counted."""
    y, b, r, g = bias_inputs(device, layout, shape, getattr(torch, dtype_name), b_dims, residual,
                             seed)
    want = _bias_results(bias_ops.plain_add_bias, y, b, r, g)
    reset_launches(bias_launches)
    got = _bias_results(bias_ops.add_bias, y, b, r, g)
    calls = {f"{op}/{p}": n for (op, p), n in bias_launches.launches_by_path.items() if n}
    again = _bias_results(bias_ops.add_bias, y, b, r, g)
    return {"check": "bias kernel vs the plain chain on the card", "layout": layout,
            "shape": list(shape), "dtype": dtype_name, "b_shape": list(b.shape),
            "residual": residual, "calls": calls,
            "path": bias_ops.path_of(y, b, r) if device.type == "cuda" else "plain",
            "bits_differ": {k: _mismatches(got[k], want[k]) for k in want},
            "same_layout": activations.same_layout(got["out"], want["out"]),
            "deterministic": all(torch.equal(got[k], again[k]) for k in got)}


def check_bias(device, cases=BIAS_CHECKS, strict: bool = True) -> list:
    """Phase 5o: every case of ``cases`` (``bias_case``) bit-equal to the
    chain in every result, the output in the chain's layout, two launches
    bit-equal, one call (none for an empty tensor) and no plain call; a
    float16 tensor, or a b of another dtype, on the card raises ValueError."""
    lines = []
    for case in cases:
        line = bias_case(device, *case)
        print(json.dumps(line), flush=True)
        lines.append(line)
        bad = [k for k, v in line["bits_differ"].items() if v]
        if not (line["same_layout"] and line["deterministic"]):
            bad.append("layout/deterministic")
        op = "bias_residual" if case[4] else "bias"
        if device.type == "cuda" and line["calls"] != ({f"{op}/cuda": 1} if math.prod(case[1])
                                                       else {}):
            bad.append(f"calls {line['calls']}")
        if bad and strict:
            raise AssertionError(f"bias {case}: {bad}")
    if device.type == "cuda":
        for y, b in ((torch.zeros(4, 64, dtype=torch.float16, device=device),
                      torch.zeros(64, dtype=torch.float16, device=device)),
                     (torch.zeros(4, 64, dtype=torch.bfloat16, device=device),
                      torch.zeros(64, device=device))):
            try:
                bias_ops.add_bias(y, b)
            except ValueError:
                pass
            else:
                raise AssertionError(f"a {y.dtype} y with a {b.dtype} b took the bias kernel")
    return lines


def bias_bound_ms(shape: tuple, dtype_name: str, b_dims: int, residual: bool) -> float:
    """Least time for the call's bytes: y (and the residual) read once, the
    output written once, b read once."""
    item = 2 if dtype_name == "bfloat16" else 4
    n = math.prod(shape)
    return ((2 + residual) * n + math.prod(shape[len(shape) - b_dims:])) * item \
        / PEAK_BYTES_PER_S * 1e3


def time_bias(device, cases=BIAS_TIME_CASES, calls: int = 24) -> list:
    """The bias kernel at the masked step's calls: each call's ms
    (``graphed_ms`` over ``calls`` calls whose inputs rotate over copies
    that exceed the L2 cache, so each launch reads them from device memory;
    ``warm_ms`` on one copy) beside its bound in bytes and the plain chain
    (``y + b``, then the residual's add: the kernels PyTorch picks),
    replayed alike."""
    lines = []
    for layout, shape, dtype_name, b_dims, residual in cases:
        dtype = getattr(torch, dtype_name)
        per_call = (2 + residual) * math.prod(shape) * (2 if dtype == torch.bfloat16 else 4)
        copies = max(2, math.ceil(2 * L2_BYTES / per_call))
        inputs = [bias_inputs(device, layout, shape, dtype, b_dims, residual, seed=i)[:3]
                  for i in range(copies)]
        with torch.no_grad():
            ms = graphed_ms([lambda i=i: bias_ops.add_bias(*inputs[i % copies])
                             for i in range(calls)])
            warm_ms = graphed_ms([lambda: bias_ops.add_bias(*inputs[0])] * calls)
            plain_ms = graphed_ms([lambda i=i: bias_ops.plain_add_bias(*inputs[i % copies])
                                   for i in range(calls)])
        bound = bias_bound_ms(shape, dtype_name, b_dims, residual)
        line = {"timing": "bias" + ("_residual" if residual else ""), "route": "cuda",
                "path": bias_ops.path_of(*inputs[0]), "layout": layout, "dtype": dtype_name,
                "shape": list(shape), "b_shape": list(inputs[0][1].shape), "ms": ms,
                "warm_ms": warm_ms, "input_copies": copies, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes", "ms_over_bound": ms / bound,
                "plain_over_bound": plain_ms / bound}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


class plain_bias:
    """Inside: every module of the port that bound ``add_bias`` runs the
    plain chain instead, on the card too (phase 5o's control, for the smoke
    only)."""

    MODULES = (layers, gan_models, generators, contrastive_models)

    def __enter__(self):
        self.saved = [(mod, mod.add_bias) for mod in self.MODULES]
        for mod, _ in self.saved:
            mod.add_bias = lambda y, b, residual=None: bias_ops.plain_add_bias(y, b, residual)
        return self

    def __exit__(self, *exc):
        for mod, fn in self.saved:
            mod.add_bias = fn


def bias_paths_bit_equal(device, batch: int = 512, model: dict = None) -> list:
    """Phase 5o, whole steps: for the ``flag`` recipe (``kind`` "bfloat16")
    and ``varlen2`` (``kind`` "masked"), GRAPH_CHECK_BATCHES graphed steps
    from one state with the bias kernel and again with the plain chain
    patched in (``plain_bias``): every loss and every state tensor
    bit-equal. On the card every add of a step goes through the kernel,
    none plain, as many as ``BIAS_CALLS_PER_STEP`` names."""
    lines = []
    for kind, recipe in (("bfloat16", "flag"), ("masked", "varlen2")):
        mcfg, tcfg, batches, epoch_fn, _ = _graph_check_inputs(device, kind, batch, model)
        if recipe == "varlen2":
            tcfg = dataclasses.replace(tcfg, lambda_speed=2.0)
        runs = {}
        for path in ("kernel", "plain"):
            state = init_gan_state(0, mcfg, device)
            reset_launches(bias_launches)
            with plain_bias() if path == "plain" else contextlib.nullcontext():
                _, traces = epoch_fn(state, batches, GRAPH_CHECK_LR, mcfg, tcfg,
                                     graph=StepGraph())
            _sync(device)
            runs[path] = (state, traces, {f"{op}/{p}": n / GRAPH_CHECK_BATCHES for (op, p), n
                                          in bias_launches.launches_by_path.items() if n})
        (a, ta, calls), (b, tb, plain_calls) = runs["kernel"], runs["plain"]
        line = {"check": "graphed steps with the bias kernel vs the plain chain",
                "recipe": recipe, "batch": batch, "steps": GRAPH_CHECK_BATCHES,
                "max_abs_loss_diff": max((ta[k] - tb[k]).abs().max().item() for k in ta),
                "max_abs_state_diff": _state_diff(a, b), "calls_per_step": calls,
                "plain_run_calls_per_step": plain_calls}
        line["bit_equal"] = line["max_abs_loss_diff"] == 0.0 == line["max_abs_state_diff"]
        print(json.dumps(line), flush=True)
        if not line["bit_equal"]:
            raise AssertionError(f"the bias kernel changes the {recipe} steps: {line}")
        if plain_calls:
            raise AssertionError(f"the patched {recipe} steps still called the dispatcher: {line}")
        if device.type == "cuda":
            if any(k.endswith("/plain") for k in calls):
                raise AssertionError(f"a plain bias add in the {recipe} steps: {line}")
            if calls != BIAS_CALLS_PER_STEP[recipe]:
                raise AssertionError(f"bias adds a {recipe} step {calls}, expected "
                                     f"{BIAS_CALLS_PER_STEP[recipe]}")
        lines.append(line)
    return lines


def activation_paths_bit_equal(device, batch: int = 512, model: dict = None) -> list:
    """Phase 5l: for the ``flag`` recipe (``kind`` "bfloat16") and ``varlen2``
    (the masked step with lambda_speed 2), GRAPH_CHECK_BATCHES graphed
    steps from one state (``init_gan_state(0)``), once as shipped and once
    with the activations patched to the plain functions: the traces (every
    loss) and every state tensor must be bit-equal. The shipped steps must
    call the kernels on every activation, and the masked step must make
    (n_critic + 2) x layers gelu forwards and 2 x layers gelu backwards a
    step (the critic loop's generator calls and the joint step's two), as
    many attention forwards and backwards, all through the attention
    kernels, and (2 x layers + 1) times as many layer norms, all through
    the layer norm kernels (both run on both sides)."""
    lines = []
    for kind, recipe in (("bfloat16", "flag"), ("masked", "varlen2")):
        mcfg, tcfg, batches, epoch_fn, _ = _graph_check_inputs(device, kind, batch, model)
        if recipe == "varlen2":
            tcfg = dataclasses.replace(tcfg, lambda_speed=2.0)
        runs = {}
        for path in ("kernels", "plain"):
            state = init_gan_state(0, mcfg, device)
            reset_launches(activation_launches, attention_launches, layernorm_launches)
            if path == "plain":
                with plain_activations():
                    _, traces = epoch_fn(state, batches, GRAPH_CHECK_LR, mcfg, tcfg,
                                         graph=StepGraph())
            else:
                _, traces = epoch_fn(state, batches, GRAPH_CHECK_LR, mcfg, tcfg,
                                     graph=StepGraph())
            _sync(device)
            runs[path] = (state, traces, {f"{op}/{p}": n / GRAPH_CHECK_BATCHES for (op, p), n
                                          in activation_launches.launches_by_path.items() if n},
                          {f"{op}/{p}": n / GRAPH_CHECK_BATCHES for (op, p), n
                           in attention_launches.launches_by_path.items() if n},
                          {f"{op}/{p}": n / GRAPH_CHECK_BATCHES for (op, p), n
                           in layernorm_launches.launches_by_path.items() if n})
        (a, ta, calls, attention_calls, layernorm_calls), (b, tb, plain_calls, _, _) = (
            runs["kernels"], runs["plain"])
        loss_diff = max((ta[k] - tb[k]).abs().max().item() for k in ta)
        line = {"check": "graphed steps with the activation kernels vs the plain chain",
                "recipe": recipe, "batch": batch, "steps": GRAPH_CHECK_BATCHES,
                "max_abs_loss_diff": loss_diff, "max_abs_state_diff": _state_diff(a, b),
                "calls_per_step": calls, "plain_run_calls_per_step": plain_calls,
                "attention_calls_per_step": attention_calls,
                "layernorm_calls_per_step": layernorm_calls}
        line["bit_equal"] = line["max_abs_loss_diff"] == 0.0 == line["max_abs_state_diff"]
        print(json.dumps(line), flush=True)
        if not line["bit_equal"]:
            raise AssertionError(f"the activation kernels change the {recipe} steps: {line}")
        if plain_calls:
            raise AssertionError(f"the patched {recipe} steps still called the dispatchers: {line}")
        if device.type == "cuda":
            if any(k.endswith("/plain") for k in calls):
                raise AssertionError(f"a plain activation call in the {recipe} steps: {line}")
            if kind == "masked":
                layers_n = mcfg.tfm_num_layers
                want = {"gelu_fwd/cuda": (tcfg.n_critic + 2) * layers_n,
                        "gelu_bwd/cuda": 2 * layers_n}
                got = {k: calls.get(k) for k in want}
                if got != want:
                    raise AssertionError(f"gelu calls a masked step {got}, expected {want}")
                want = {"attention_fwd/cuda": (tcfg.n_critic + 2) * layers_n,
                        "attention_bwd/cuda": 2 * layers_n}
                if attention_calls != want:
                    raise AssertionError(f"attention calls a masked step {attention_calls}, "
                                         f"expected {want}")
                norms = 2 * layers_n + 1
                want = {"layernorm_fwd/cuda": (tcfg.n_critic + 2) * norms,
                        "layernorm_bwd/cuda": 2 * norms}
                if layernorm_calls != want:
                    raise AssertionError(f"layer norm calls a masked step {layernorm_calls}, "
                                         f"expected {want}")
        lines.append(line)
    return lines


def _nudge(state: dict, seed: int) -> dict:
    """``state`` with every parameter moved by one float32 rounding step
    (relative 2^-24, random sign; ``tests/jax_trajectory.py``'s control)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in MODELS:
            for p in tree_leaves(state[m]["params"]):
                sign = torch.from_numpy(rng.choice([-1.0, 1.0], tuple(p.shape)))
                p.copy_((p.double() * (1 + 2.0 ** -24 * sign)).float())
    return state


def _step_inputs(kind: str, batch: int, mcfg: ModelConfig) -> tuple:
    """The batch and noise of phases 6 and 10: smoke gestures, and for the
    masked step a mask of true lengths in VL_STEP_LENGTHS."""
    if kind == "masked":
        ds = smoke_dataset(batch, mcfg.seq_length, seed=4)
        rng = np.random.default_rng(8)
        lengths = rng.integers(min(VL_STEP_LENGTHS[0], mcfg.seq_length), mcfg.seq_length + 1,
                               batch)
        lengths[0] = mcfg.seq_length
        mask = (np.arange(mcfg.seq_length)[None, :] < lengths[:, None]).astype(np.float32)
        data = {"gesture": torch.from_numpy(ds.gestures),
                "prototype": torch.from_numpy(ds.prototypes), "mask": torch.from_numpy(mask)}
        noise = _step_noise(batch, mcfg.latent_dim, 5, seed=9)
        noise.pop("z_ms")
        return data, noise
    ds = smoke_dataset(batch, mcfg.seq_length, seed=3)
    data = {"gesture": torch.from_numpy(ds.gestures), "prototype": torch.from_numpy(ds.prototypes)}
    return data, _step_noise(batch, mcfg.latent_dim, 5, seed=6)


def _bf16_step(kind: str, batch: int, model: dict = None) -> tuple:
    """(step, ModelConfig, TrainingConfig) of phase 5j's ``kind``: the
    flagship recipe on the BiLSTM, or the masked step on the transformer with
    lambda_speed 2; bfloat16, full width unless ``model`` overrides it."""
    fields = {"time_head": "monotone", "compute_dtype": "bfloat16", **(model or {})}
    if kind == "masked":
        return (gan_train_step_masked, ModelConfig(generator_type="transformer", **fields),
                TrainingConfig(batch_size=batch, n_critic=5, lambda_speed=2.0))
    return (gan_train_step, ModelConfig(**fields),
            TrainingConfig(**dict(FLAGSHIP_TRAIN, batch_size=batch), div_margin=0.25))


def _moments(dev, step, mcfg, tcfg, data: dict, noise: dict, nudge: bool = False) -> tuple:
    """One step at lr=0 from ``init_gan_state(0)``: (Adam's first moments by
    model, the losses)."""
    state = init_gan_state(0, mcfg, device=dev)
    if nudge:
        _nudge(state, 1)
    _, metrics = step(state, {k: v.to(dev) for k, v in data.items()}, 0.0, mcfg, tcfg,
                      noise={k: v.to(dev) for k, v in noise.items()})
    return ({m: [t.detach().cpu().double() for t in tree_leaves(state[m]["opt"]["mu"])]
             for m in MODELS}, {k: v.item() for k, v in metrics.items()})


def _rel_l2(a: list, b: list) -> float:
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
    return (num / max(sum(float((y ** 2).sum()) for y in b), 1e-300)) ** 0.5


def bf16_step_vs_cpu(device, kind: str, batch=STEP_BATCH, model: dict = None) -> dict:
    """Phase 5j, one step: ``kind`` "flagship" (``gan_train_step``, the
    flagship recipe, full width) or "masked" (``gan_train_step_masked``, the
    transformer, lambda_speed 2), bfloat16, on the card and on the CPU, and
    the control on the CPU. ``model`` overrides configuration fields (a
    rehearsal on the CPU at a tiny size)."""
    step, mcfg, tcfg = _bf16_step(kind, batch, model)
    data, noise = _step_inputs(kind, batch, mcfg)
    cpu, cpu_m = _moments(torch.device("cpu"), step, mcfg, tcfg, data, noise)
    card, card_m = _moments(device, step, mcfg, tcfg, data, noise)
    ctl, ctl_m = _moments(torch.device("cpu"), step, mcfg, tcfg, data, noise, nudge=True)
    grads = {m: {"card": _rel_l2(card[m], cpu[m]), "control": _rel_l2(ctl[m], cpu[m])}
             for m in MODELS}
    losses = {k: {"card": abs(card_m[k] - w) / max(1.0, abs(w)),
                  "control": abs(ctl_m[k] - w) / max(1.0, abs(w))} for k, w in cpu_m.items()}
    line = {"check": f"bf16 {kind} step on the card vs CPU, against a nudged CPU control",
            "batch": batch, "grad_rel_l2": grads, "loss_rel": losses,
            "tolerance": {"factor_of_control": BF16_CONTROL_FACTOR, "floor": BF16_FLOOR}}
    print(json.dumps(line), flush=True)
    bad = [k for k, v in {**grads, **losses}.items()
           if not v["card"] <= BF16_CONTROL_FACTOR * v["control"] + BF16_FLOOR]
    if bad:
        raise AssertionError(f"the card's bf16 {kind} step parts from the CPU's: {bad}")
    return line


def precision_flags(device, batch: int = 512, seq: int = SEQ) -> dict:
    """Phase 5k, measurements for the record (no check): (a) the temporal
    critic's float32 convolutions under cuDNN with TF32 allowed (PyTorch's
    default) and not, each against float64 on the host; (b) phase 6's
    float32 steps on the card vs CPU with the global TF32 flag on, which
    the step's ``jax_products()`` overrides; (c) the bf16 products of the
    steps with ``allow_bf16_reduced_precision_reduction`` on (PyTorch's
    default) and off: elements whose bits differ, and each against float64;
    (d) one bf16 masked and one bf16 flagship step on the card with that
    flag on and off: Adam's moments bit-equal or not."""
    rng = np.random.default_rng(21)
    out = {"cudnn_allow_tf32_default": True}
    h = torch.from_numpy(rng.uniform(-1, 1, (batch, seq, 3)).astype(np.float32))
    convs = {}
    for cin, cout, k, pad in ((3, 64, 5, 2), (64, 64, 5, 2), (64, 32, 3, 1)):
        w = torch.from_numpy(rng.uniform(-1, 1, (cout, cin, k)).astype(np.float32)) / (cin * k) ** 0.5
        ref = torch.nn.functional.conv1d(h.transpose(1, 2).double(), w.double(), padding=pad)
        errs = {}
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            got = torch.nn.functional.conv1d(h.transpose(1, 2).to(device), w.to(device),
                                             padding=pad).cpu().double()
            errs[f"tf32_{tf32}"] = float((got - ref).abs().max() / ref.abs().max())
        convs[f"{cin}->{cout}"] = errs
        h = torch.tanh(ref.float()).transpose(1, 2).contiguous()
    torch.backends.cudnn.allow_tf32 = False
    out["conv1d_max_rel_err"] = convs
    torch.backends.cudnn.allow_tf32 = True
    steps = {}
    for recipe in STEP_RECIPES:
        lambdas, _ = STEP_RECIPES[recipe]
        mcfg = ModelConfig(time_head="monotone", compute_dtype="float32")
        tcfg = TrainingConfig(**dict(lambdas, batch_size=STEP_BATCH, n_critic=5), div_margin=0.25)
        data, noise = _step_inputs("flagship", STEP_BATCH, mcfg)
        card, _ = _moments(device, gan_train_step, mcfg, tcfg, data, noise)
        cpu, _ = _moments(torch.device("cpu"), gan_train_step, mcfg, tcfg, data, noise)
        steps[recipe] = max(_rel_err(a, b)[0] for m in MODELS for a, b in zip(card[m], cpu[m]))
    torch.backends.cudnn.allow_tf32 = False
    out["float32_step_max_grad_err_rel_tf32_on"] = steps
    gemms = {}
    for name, (m, k, n) in {"encoder_in": (batch, seq * 3, 192), "qkv": (batch * seq, 64, 192),
                            "mlp2": (batch * seq, 256, 64),
                            "qkv_weight_grad": (64, batch * seq, 192),
                            "encoder_weight_grad": (seq * 3, batch, 192)}.items():
        a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
        b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(torch.bfloat16)
        ref = (a.double() @ b.double())
        res = {}
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            res[flag] = (a.to(device) @ b.to(device)).cpu()
        gemms[name] = {"shape": [m, k, n], "mismatches": _mismatches(res[True], res[False]),
                       "max_rel_err_on": float((res[True].double() - ref).abs().max() / ref.abs().max()),
                       "max_rel_err_off": float((res[False].double() - ref).abs().max() / ref.abs().max())}
    out["bf16_gemms"] = gemms
    same = {}
    for kind in ("flagship", "masked"):
        step, mcfg, tcfg = _bf16_step(kind, batch)
        data, noise = _step_inputs(kind, batch, mcfg)
        runs = []
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            runs.append(_moments(device, step, mcfg, tcfg, data, noise)[0])
        same[kind] = all(torch.equal(a, b) for m in MODELS for a, b in zip(runs[0][m], runs[1][m]))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    out["bf16_step_moments_equal_flag_on_off"] = same
    line = {"measure": "precision flags on the card", **out}
    print(json.dumps(line), flush=True)
    return line


def time_graphed_step(device, epochs: int = 3, batches: int = 8) -> dict:
    """The flagship bf16 step at B=512 from ``init_gan_state(42)``: ``epochs``
    graphed epochs of ``batches`` replays after one warm-up epoch (untraced,
    host clock around synchronised epochs, the epoch's key splitting
    included), then one eager epoch from the same state; the threefry
    launches per graphed step."""
    mcfg = ModelConfig(time_head="monotone", compute_dtype="bfloat16")
    tcfg = TrainingConfig(**dict(FLAGSHIP_TRAIN, batch_size=TIME_BATCH), div_margin=0.25)
    ds = smoke_dataset(batches * TIME_BATCH, mcfg.seq_length, seed=13)
    data = {"gesture": torch.from_numpy(ds.gestures), "prototype": torch.from_numpy(ds.prototypes)}
    eb = {k: v.to(device).reshape(batches, TIME_BATCH, *v.shape[1:]) for k, v in data.items()}
    state, graph = init_gan_state(42, mcfg, device), StepGraph()
    gan_train_epoch(state, eb, GRAPH_CHECK_LR, mcfg, tcfg, graph=graph)     # warm-up, capture
    _sync(device)
    reset_launches(threefry_draw)
    t0 = time.perf_counter()
    for _ in range(epochs):
        gan_train_epoch(state, eb, GRAPH_CHECK_LR, mcfg, tcfg, graph=graph)
    _sync(device)
    graphed_ms = (time.perf_counter() - t0) / (epochs * batches) * 1e3
    per_step = threefry_draw.launches / (epochs * batches)
    t0 = time.perf_counter()
    for i in range(batches):
        gan_train_step(state, {k: v[i] for k, v in eb.items()}, GRAPH_CHECK_LR, mcfg, tcfg)
    _sync(device)
    line = {"timing": "flagship bf16 step, B=512, graphed replays vs eager", "untraced": True,
            "graphed_ms_per_step": graphed_ms,
            "eager_ms_per_step": (time.perf_counter() - t0) / batches * 1e3,
            "threefry_launches_per_graphed_step": per_step, "replays": graph.replays,
            "captures": graph.captures}
    print(json.dumps(line), flush=True)
    if device.type == "cuda" and (per_step != 1 or graph.captures != 1):
        raise AssertionError(f"the graphed step should draw in one threefry launch: {line}")
    return line


def _step_noise(batch: int, latent: int, n_critic: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"z_rand": (n_critic, batch, latent), "eps_enc": (n_critic, batch, latent),
              "z1": (batch, latent), "eps_rec": (batch, latent), "eps2": (batch, latent),
              "z_ms": (batch, latent)}
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}


def step_vs_cpu(device, batch=STEP_BATCH, model: dict = None) -> list:
    """Phase 6: one float32 step of each recipe (the reference's, without
    the auxiliaries, and the flagship's) on the card and on the CPU from the
    same state, batch and noise."""
    return [step_vs_cpu_recipe(device, name, batch, model) for name in STEP_RECIPES]


def step_vs_cpu_recipe(device, recipe: str, batch=STEP_BATCH, model: dict = None) -> dict:
    """One recipe of phase 6: at lr=0 (the gradients, as Adam's moments) and
    at lr=2e-4 (the parameters). ``model`` overrides configuration fields,
    as in ``train``."""
    lambdas, grad_tol = STEP_RECIPES[recipe]
    mcfg = ModelConfig(**{"time_head": "monotone", **(model or {})})
    tcfg = TrainingConfig(**dict(lambdas, batch_size=batch, n_critic=5), div_margin=0.25)
    data, noise = _step_inputs("flagship", batch, mcfg)
    counters = (bilstm_train_fwd, bilstm_train_bwd)
    before = [dict(c.launches_by_path) for c in counters]
    worst = compare_step(device, gan_train_step, mcfg, tcfg, data, noise, grad_tol)
    # The card's steps (one at each lr) ran kernels 2 and 3 (once per
    # differentiated generator application: 2 a step without the diversity
    # terms, 3 with them), every launch on the path the dispatch names for
    # this dtype and width (float32 at full width: "fp32").
    took = [{k: c.launches_by_path[k] - b[k] for k in b} for c, b in zip(counters, before)]
    path = kernel_path(getattr(torch, mcfg.compute_dtype), mcfg.gen_hidden_dim, mcfg.seq_length, 1)
    want = [only_path(c, path, max(1, sum(t.values()))) for c, t in zip(counters, took)]
    if device.type == "cuda" and took != want:
        raise AssertionError(f"step launches by path {took}, expected all on {path}")
    line = {"check": "gan_train_step on the card vs CPU plain path", "recipe": recipe,
            "batch": batch, "dtype": mcfg.compute_dtype, "sample_tile": sample_tile(
                getattr(torch, mcfg.compute_dtype), batch), "train_launches_by_path": took, **worst,
            "tolerances": {"loss": STEP_LOSS_TOL, "grad": grad_tol,
                           "param_in_lr_per_adam_step": 2}}
    print(json.dumps(line), flush=True)
    return line


def compare_step(device, step, mcfg, tcfg, data: dict, noise: dict, grad_tol: float) -> dict:
    """``step(state, batch, lr, mcfg, tcfg, noise=)`` on the card and on the
    CPU from one fresh state, at lr=0 (Adam's moments: the gradients, each
    leaf relative to its largest, within ``grad_tol``) and at lr=2e-4 (the
    parameters within 2·lr per Adam step); losses within STEP_LOSS_TOL of
    max(1, |loss|). Returns the worst errors."""
    worst = {"max_loss_err_rel": 0.0, "max_grad_err_rel": 0.0,
             "max_param_err_in_lr_per_adam_step": 0.0}
    for lr in (0.0, STEP_LR):
        runs = []
        for dev in (device, torch.device("cpu")):
            state = init_gan_state(0, mcfg, device=dev)
            _, metrics = step(state, {k: v.to(dev) for k, v in data.items()}, lr, mcfg, tcfg,
                              noise={k: v.to(dev) for k, v in noise.items()})
            runs.append((state, {k: v.item() for k, v in metrics.items()}))
        (gpu, gm), (cpu, cm) = runs
        for k, want in cm.items():
            err = abs(gm[k] - want) / max(1.0, abs(want))
            worst["max_loss_err_rel"] = max(worst["max_loss_err_rel"], err)
            if not err <= STEP_LOSS_TOL:
                raise AssertionError(f"step loss {k} on the card {gm[k]} vs CPU {want}")
        for m in MODELS:
            if lr == 0.0:
                for part in ("mu", "nu"):
                    for a, b in zip(tree_leaves(gpu[m]["opt"][part]), tree_leaves(cpu[m]["opt"][part])):
                        err = _rel_err(a.cpu(), b)[0]
                        worst["max_grad_err_rel"] = max(worst["max_grad_err_rel"], err)
                        if not err <= grad_tol:
                            raise AssertionError(f"{m} {part} on the card vs CPU: {err}")
            else:
                adam_steps = tcfg.n_critic if m in ("d1", "d2") else 1
                for a, b in zip(tree_leaves(gpu[m]["params"]), tree_leaves(cpu[m]["params"])):
                    err = (a.detach().cpu() - b.detach()).abs().max().item() / lr
                    worst["max_param_err_in_lr_per_adam_step"] = max(
                        worst["max_param_err_in_lr_per_adam_step"], err / adam_steps)
                    if not err <= 2 * adam_steps:
                        raise AssertionError(f"{m} parameters on the card vs CPU: {err} lr")
    return worst

# -- evaluation through the entry points --------------------------------------------------

# The corpus: the port's synthetic swipelog writer over dataset/wordfreq.txt;
# 480 users give a test split of 2170 gestures (8744 to train on), enough
# for the 2000 the evaluation samples (440 users give 2010, 320 give 1586).
EVAL_USERS, EVAL_N = 480, 2000
EVAL_TRAIN_EPOCHS = 2          # a smoke generator: the flagship recipe, 2 epochs
EVAL_FID_EPOCHS = 5            # the FID autoencoders' epochs, cut from 100
EVAL_SCALARS = ("l2_wasserstein", "dtw_wasserstein", "jerk_real", "jerk_fake", "velocity_corr",
                "acceleration_corr", "speed_profile_corr", "time_delta_corr",
                "ae_reconstruction_loss", "ae_test_loss", "fid", "fid_paper", "fid_positional",
                "precision", "recall")
# The small evaluation on the card against the CPU: distances, jerk,
# correlations and the autoencoder losses within 2e-3 of max(1, |value|) (two
# float32 trainings of the autoencoders whose sums run in another order);
# the FIDs, small differences of traces, within 5% + 1e-5; precision and
# recall within one sample of the set (a distance on a ball's edge may flip).
SMALL_EVAL_N, SMALL_EVAL_TRAIN, SMALL_EVAL_FID_EPOCHS = 64, 512, 2


def _check_results(name: str, results: dict) -> None:
    bad = [k for k in EVAL_SCALARS if not np.isfinite(results[k])]
    if bad:
        raise AssertionError(f"{name}: non-finite metrics {bad}")
    if not (0.0 <= results["precision"] <= 1.0 and 0.0 <= results["recall"] <= 1.0):
        raise AssertionError(f"{name}: precision/recall outside [0, 1]")
    if min(results["fid"], results["fid_paper"], results["fid_positional"]) < 0.0:
        raise AssertionError(f"{name}: negative FID")
    if not results["dtw_wasserstein"] > 0.0:
        raise AssertionError(f"{name}: dtw_wasserstein {results['dtw_wasserstein']}")


def evaluate(device, workdir: Path, users=EVAL_USERS, n=EVAL_N, train_epochs=EVAL_TRAIN_EPOCHS,
             fid_epochs=EVAL_FID_EPOCHS, batch_size=512, model_args=()) -> dict:
    """Phase 7: train a smoke generator through ``train_cli.main`` on the
    synthetic corpus, then score it and the minimum-jerk baseline through
    ``eval_cli.main`` with DTW on, kernel launches counted from 0.
    ``model_args`` are extra CLI flags for a rehearsal at a tiny size."""
    ckpt = workdir / "checkpoints"
    data = ["--synthetic", "--synthetic-users", str(users), "--data",
            str(workdir / "swipelogs.zip"), "--checkpoint-dir", str(ckpt), "--device", device.type]
    t0 = time.perf_counter()
    trained = train_cli.main(["--epochs", str(train_epochs), "--batch-size", str(batch_size),
                              "--lambda-speed", "2.0", "--lambda-div", "0.3", "--lambda-dtc", "4.0",
                              *model_args, *data])
    train_seconds = time.perf_counter() - t0
    if latest_epoch(str(ckpt)) != train_epochs or len(trained.history) != train_epochs:
        raise AssertionError("train_cli did not train and checkpoint the requested epochs")

    counters = {"dtw": dtw_matrix, "dtw_aligned_pairs": dtw_pairs, "bilstm_fused": fused_bilstm_fwd}
    reset_launches(*counters.values())
    t0 = time.perf_counter()
    out = eval_cli.main(["--model", "both", "--n-samples", str(n), "--fid-epochs",
                         str(fid_epochs), *data])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    fused_by_path = dict(fused_bilstm_fwd.launches_by_path)

    if out["n"] != n:
        raise AssertionError(f"the test split gave {out['n']} samples, not {n}")
    for name in ("gan", "minjerk"):
        _check_results(name, out[name])
    stages = out["stage_seconds"]
    # The minimum-jerk pass must reuse the real side of the GAN pass: no
    # second autoencoder training, the same autoencoder behind both FIDs.
    if ("fid_autoencoder_training" not in stages["gan"]
            or "fid_autoencoder_training" in stages["minjerk"]
            or out["gan"]["ae_reconstruction_loss"] != out["minjerk"]["ae_reconstruction_loss"]
            or out["gan"]["jerk_real"] != out["minjerk"]["jerk_real"]):
        raise AssertionError("the minimum-jerk pass did not reuse cached_real")
    expected = {"dtw": 2, "dtw_aligned_pairs": 0, "bilstm_fused": chunk_layout(n, 512)[1]}
    if device.type == "cuda" and launches != expected:
        raise AssertionError(f"launches on the evaluation path {launches}, expected {expected}")
    # The evaluation samples in the checkpoint's compute dtype (float32 unless
    # trained otherwise): its kernel-1 launches take that dtype's path.
    eval_dtype = torch.bfloat16 if "bfloat16" in model_args else torch.float32
    eval_hidden = int(model_args[model_args.index("--gen-hidden") + 1]) \
        if "--gen-hidden" in model_args else HIDDEN
    eval_path = bilstm_fused.kernel_path(eval_dtype, eval_hidden, SEQ, LAYERS)
    if device.type == "cuda" and fused_by_path != only_path(fused_bilstm_fwd, eval_path,
                                                            expected["bilstm_fused"]):
        raise AssertionError(f"bilstm_fused launches by path {fused_by_path}, expected all on "
                             f"{eval_path}")
    line = {"evaluation": "eval_cli.main", "model": "both", "n": n, "pairs_per_matrix": n * n,
            "synthetic_users": users, "generator": f"train_cli.main, {train_epochs} epochs",
            "train_cli_seconds": train_seconds, "fid_epochs": fid_epochs,
            "fid_epochs_default": EvaluationConfig().fid_autoencoder_epochs,
            "seconds": wall, "stage_seconds": stages, "launches": launches,
            "bilstm_fused_launches_by_path": fused_by_path,
            "gan": {k: out["gan"][k] for k in EVAL_SCALARS},
            "minjerk": {k: out["minjerk"][k] for k in EVAL_SCALARS}}
    print(json.dumps(line), flush=True)

    # The same split and fakes again (the cached corpus, the same checkpoint
    # and seed), to look inside: the DTW matrix against the diagonal path, and
    # against the scalar the CLI printed.
    args = eval_cli.build_parser().parse_args(["--n-samples", str(n), *data])
    meta = json.loads((ckpt / "run_meta.json").read_text())
    mcfg = ModelConfig(time_head=meta["time_head"], gen_hidden_dim=meta["gen_hidden_dim"])
    train_ds, test_ds, _ = load_split(args, mcfg, TrainingConfig(), verbose=False)
    real = test_ds.gestures[:n]
    model = load_generator(str(find_checkpoint(str(ckpt))), mcfg, device=device)
    fake = generate_gestures(model, test_ds.prototypes[:n], mcfg, seed=args.seed, device=device)
    real_t = torch.from_numpy(real[:, :, :2]).to(device)
    fake_t = torch.from_numpy(fake[:, :, :2]).to(device)
    matrix = dtw_matrix(real_t, fake_t)
    rng = np.random.default_rng(13)
    i = torch.from_numpy(rng.integers(0, n, 4096)).to(device)
    j = torch.from_numpy(rng.integers(0, n, 4096)).to(device)
    diagonal = (real_t[i] - fake_t[j]).norm(dim=-1).sum(dim=-1)
    slack = (matrix[i, j] - diagonal * (1.0 + 1e-5)).max().item()
    again = matched_mean_distance(matrix.cpu().numpy()) / np.sqrt(real.shape[1])
    gap = abs(again - out["gan"]["dtw_wasserstein"]) / out["gan"]["dtw_wasserstein"]
    print(json.dumps({"check": "dtw matrix of the evaluation", "sampled_pairs": 4096,
                      "max_dtw_minus_diagonal_path_cost": slack,
                      "dtw_wasserstein_recomputed": again, "rel_gap_to_cli": gap,
                      "tolerance_rel": 1e-6}), flush=True)
    if slack > 0.0 or not torch.isfinite(matrix).all():
        raise AssertionError("an exact DTW distance exceeds its diagonal path's cost")
    if gap > 1e-6:
        raise AssertionError(f"dtw_wasserstein recomputed {again} vs CLI {out['gan']}")

    line["small_eval"] = small_eval_vs_cpu(device, real, fake, train_ds.gestures, mcfg)
    if device.type == "cuda":   # where the suite's time goes, autoencoder training included
        ecfg = EvaluationConfig(fid_autoencoder_epochs=fid_epochs)
        line["profile"] = device_profile(
            lambda: evaluate_all_metrics(real, fake, train_ds.gestures, mcfg, ecfg,
                                         verbose=False, device=device),
            "evaluate_all_metrics", n=n, fid_epochs=fid_epochs)
    line["launches"] = launches
    line["bilstm_fused_launches_by_path"] = fused_by_path
    return line


def small_eval_vs_cpu(device, real, fake, train, mcfg, n=SMALL_EVAL_N, n_train=SMALL_EVAL_TRAIN,
                      fid_epochs=SMALL_EVAL_FID_EPOCHS) -> dict:
    """A small evaluation on the card against the same call on the CPU."""
    ecfg = EvaluationConfig(fid_autoencoder_epochs=fid_epochs)
    runs = [evaluate_all_metrics(real[:n], fake[:n], train[:n_train], mcfg, ecfg, verbose=False,
                                 device=dev) for dev in (device, "cpu")]
    worst = {}
    for k in EVAL_SCALARS:
        got, want = float(runs[0][k]), float(runs[1][k])
        if k.startswith("fid"):
            err, tol = abs(got - want), 0.05 * abs(want) + 1e-5
        elif k in ("precision", "recall"):
            err, tol = abs(got - want), 1.0 / n + 1e-6
        else:
            err, tol = abs(got - want) / max(1.0, abs(want)), 2e-3
        worst[k] = err
        if not err <= tol:
            raise AssertionError(f"small evaluation, {k}: {got} on the card vs {want} on the "
                                 f"CPU (error {err} > {tol})")
    line = {"check": "evaluate_all_metrics on the card vs CPU", "n": n, "n_train": n_train,
            "fid_epochs": fid_epochs, "errors": worst,
            "tolerances": {"fid*": "5% + 1e-5", "precision, recall": "1/n",
                           "others": "2e-3 of max(1, |value|)"}}
    print(json.dumps(line), flush=True)
    return line


# -- the scale metrics ---------------------------------------------------------------------

# 10⁵ gestures through ``eval_cli --large-scale``: kernel 1 serves them in
# chunks of 512 on its float32 path (eval_cli's default precision).
LARGE_N = 100_000
# The scale metrics on the card against the CPU at n = 2048 with injected
# draws, the Sinkhorn estimator cut to 2 repeats of 512 (and 256) so the CPU's
# 500 iterations per solve stay short. Relative tolerances, as the CPU parity
# tests hold the port to the JAX package: sliced W2 and energy distance 1e-5
# (float32 sums in another order); the Sinkhorn costs and FID 1e-4 (500
# log-domain iterations; a difference of traces); the spreads (std, stderr)
# 1e-4 of the raw cost; precision, recall and the sample count equal (TF32 is
# off, so both devices compute the same distances to the radii).
LARGE_VS_CPU_N, LARGE_VS_CPU_SUB, LARGE_VS_CPU_REPEATS = 2048, 512, 2
LARGE_TOL = {"sliced_w2": 1e-5, "energy_distance": 1e-5, "sinkhorn_matched_cost": 1e-4,
             "sinkhorn_matched_cost_std": 1e-4, "sinkhorn_matched_cost_extrapolated": 1e-4,
             "sinkhorn_matched_cost_extrapolated_stderr": 1e-4, "n_samples": 0.0,
             "precision": 0.0, "recall": 0.0, "fid": 1e-4}


def _check_large(name: str, results: dict) -> None:
    bad = [k for k, v in results.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{name}: non-finite metrics {bad}")
    if not (0.0 <= results["precision"] <= 1.0 and 0.0 <= results["recall"] <= 1.0):
        raise AssertionError(f"{name}: precision/recall outside [0, 1]")
    if results["fid"] < 0.0 or not results["sinkhorn_matched_cost"] > 0.0:
        raise AssertionError(f"{name}: FID {results['fid']}, Sinkhorn cost "
                             f"{results['sinkhorn_matched_cost']}")


def evaluate_large(device, workdir: Path, users=EVAL_USERS, n=LARGE_N,
                   fid_epochs=EVAL_FID_EPOCHS) -> dict:
    """Phase 7e: ``eval_cli.main --large-scale 100000`` on phase 7's generator
    checkpoint, corpus and cached FID autoencoder: 10⁵ gestures generated
    through kernel 1 (launches counted from 0: one per chunk of 512, every
    one on the float32 path), then the scale metrics. Every metric finite,
    precision and recall in [0, 1]; stage seconds and peak device memory."""
    data = ["--synthetic", "--synthetic-users", str(users), "--data",
            str(workdir / "swipelogs.zip"), "--checkpoint-dir", str(workdir / "checkpoints"),
            "--device", device.type]
    counters = {"dtw": dtw_matrix, "dtw_aligned_pairs": dtw_pairs, "bilstm_fused": fused_bilstm_fwd}
    reset_launches(*counters.values())
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = eval_cli.main(["--large-scale", str(n), "--fid-epochs", str(fid_epochs), *data])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    fused_by_path = dict(fused_bilstm_fwd.launches_by_path)
    if out["n"] != n or out["large_scale"]["n_samples"] != n:
        raise AssertionError(f"--large-scale {n} scored {out['large_scale']['n_samples']}")
    _check_large("large-scale", out["large_scale"])
    expected = {"dtw": 0, "dtw_aligned_pairs": 0, "bilstm_fused": chunk_layout(n, 512)[1]}
    if device.type == "cuda":
        if launches != expected:
            raise AssertionError(f"launches on the large-scale path {launches}, expected "
                                 f"{expected}")
        path = bilstm_fused.kernel_path(torch.float32, HIDDEN, SEQ, LAYERS)
        if fused_by_path != only_path(fused_bilstm_fwd, path, expected["bilstm_fused"]):
            raise AssertionError(f"bilstm_fused launches by path {fused_by_path}, expected all "
                                 f"on {path}")
    line = {"evaluation": "eval_cli.main --large-scale", "n": n, "synthetic_users": users,
            "fid_epochs": fid_epochs, "seconds": wall, "stage_seconds": out["stage_seconds"],
            "peak_device_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                                       if device.type == "cuda" else None),
            "launches": launches, "bilstm_fused_launches_by_path": fused_by_path,
            "results": out["large_scale"]}
    print(json.dumps(line), flush=True)
    if device.type == "cuda":   # where the time of the two largest stages goes
        real = torch.rand((n, 2 * SEQ), generator=torch.Generator().manual_seed(3)).numpy()
        line["profile_knn"] = device_profile(
            lambda: chunked_knn_precision_recall(real, real[::-1].copy(), device=device),
            "chunked_knn_precision_recall", n=n)
        sub = torch.from_numpy(real[:4096]).to(device)
        line["profile_sinkhorn"] = device_profile(
            lambda: sinkhorn_matching_cost(pairwise_l2(sub, sub.flip(0))),
            "sinkhorn_matching_cost", n_sub=4096, iterations=500)
    return line


def _large_draws(n: int, dims: int, n_sub: int, repeats: int, seed: int = 21) -> dict:
    """``evaluate_large_scale``'s draws, made in numpy: directions, the energy
    pairs (the within-set terms offset so no row pairs with itself), nested
    Sinkhorn subsamples."""
    rng = np.random.default_rng(seed)
    i, j = rng.integers(0, n, 1 << 20), rng.integers(0, n, 1 << 20)
    pairs = ((i, j), (i, (i + rng.integers(1, n, 1 << 20)) % n),
             (j, (j + rng.integers(1, n, 1 << 20)) % n))
    return {"dirs": rng.normal(size=(dims, 256)).astype(np.float32), "pairs": pairs,
            "sinkhorn": [(rng.permutation(n)[:n_sub], rng.permutation(n)[:n_sub])
                         for _ in range(repeats)]}


def large_scale_vs_cpu(device, workdir: Path, users=EVAL_USERS, n=LARGE_VS_CPU_N,
                       n_sub=LARGE_VS_CPU_SUB, repeats=LARGE_VS_CPU_REPEATS,
                       fid_epochs=EVAL_FID_EPOCHS) -> dict:
    """Phase 7f: ``evaluate_large_scale`` on n real test gestures and n
    generated ones, with the same injected draws and the same FID
    autoencoder, on the card and on the CPU."""
    ckpt = workdir / "checkpoints"
    args = eval_cli.build_parser().parse_args(
        ["--synthetic", "--synthetic-users", str(users), "--data", str(workdir / "swipelogs.zip"),
         "--checkpoint-dir", str(ckpt)])
    meta = json.loads((ckpt / "run_meta.json").read_text())
    mcfg = ModelConfig(time_head=meta["time_head"], gen_hidden_dim=meta["gen_hidden_dim"])
    train_ds, test_ds, _ = load_split(args, mcfg, TrainingConfig(), verbose=False)
    n = min(n, len(test_ds))
    model = load_generator(str(find_checkpoint(str(ckpt))), mcfg, device=device)
    fake = generate_gestures(model, test_ds.prototypes[:n], mcfg, seed=5, device=device)
    ae, _ = load_or_train_fid_autoencoder(train_ds.gestures, mcfg,
                                          EvaluationConfig(fid_autoencoder_epochs=fid_epochs),
                                          cache_dir=str(ckpt), verbose=False, device="cpu")
    draws = _large_draws(n, 2 * mcfg.seq_length, n_sub, repeats)
    runs, seconds = [], []
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        runs.append(evaluate_large_scale(
            test_ds.gestures[:n], fake, ae_params=tree_map(lambda t: t.to(dev), ae), device=dev,
            draws=draws, sinkhorn_n_sub=n_sub, sinkhorn_repeats=repeats))
        seconds.append(time.perf_counter() - t0)
    got, want = runs
    errors = {}
    for k, w in want.items():
        if k.endswith(("_std", "_stderr")):
            scale = want["sinkhorn_matched_cost"]
        else:
            scale = abs(w) if LARGE_TOL[k] else 1.0
        errors[k] = abs(got[k] - w) / scale
    line = {"check": "evaluate_large_scale on the card vs CPU", "n": n,
            "sinkhorn_n_sub": n_sub, "sinkhorn_repeats": repeats, "relative_errors": errors,
            "card_seconds": seconds[0], "cpu_seconds": seconds[1], "tolerances": LARGE_TOL}
    print(json.dumps(line), flush=True)
    bad = [k for k, err in errors.items() if not err <= LARGE_TOL[k]]
    if bad:
        raise AssertionError(f"evaluate_large_scale on the card vs CPU: {bad} "
                             f"{ {k: (got[k], want[k]) for k in bad} }")
    return line


# -- the contrastive encoder ---------------------------------------------------------------

CONTRASTIVE_EPOCHS = 2         # then one more, resumed
# One step on the card against the CPU (same weights, same batch of 32 words
# x 2 gestures at L=128, float32 with TF32 off): the loss 1e-5 relative;
# gradients 1e-4 of the tree's largest (the convolutions sum in another order
# on the card); BatchNorm's running statistics 1e-5; the parameters after the
# step within 1e-5, or within 2·lr where a gradient is ~0 (the conv biases in
# front of BatchNorm, whose sign Adam's first step maps to ±lr).
CONTRASTIVE_LR = 1e-3
CONTRASTIVE_TOL = {"loss": 1e-5, "grad": 1e-4, "bn": 1e-5, "param": 1e-5}


def contrastive(device, workdir: Path, users=EVAL_USERS, epochs=CONTRASTIVE_EPOCHS) -> dict:
    """Phase 7g: ``train_contrastive_cli.main`` for 2 epochs on the synthetic
    corpus, one more that resumes from the checkpoint (epoch and step carried
    over), then ``eval_contrastive_cli.main --centroids --query <a test
    word>``: losses finite, recall@k, mAP and the centroid table in [0, 1]."""
    data = ["--synthetic", "--synthetic-users", str(users), "--data",
            str(workdir / "swipelogs.zip"), "--checkpoint-dir",
            str(workdir / "checkpoints_contrastive"), "--device", device.type]
    t0 = time.perf_counter()
    state, history = train_contrastive_cli.main(["--epochs", str(epochs), *data])
    resumed, more = train_contrastive_cli.main(["--epochs", str(epochs + 1), *data])
    train_seconds = time.perf_counter() - t0
    steps = state["step"] // epochs
    if (state["epoch"] != epochs or steps < 1 or resumed["epoch"] != epochs + 1
            or resumed["step"] != (epochs + 1) * steps or len(more["train_loss"]) != 1):
        raise AssertionError(f"contrastive training did not train and resume: epoch/step "
                             f"{state['epoch']}/{state['step']}, then "
                             f"{resumed['epoch']}/{resumed['step']}")
    losses = history["train_loss"] + more["train_loss"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"contrastive losses {losses}")

    args = train_contrastive_cli.build_parser().parse_args(data)
    by_word, _ = load_dataset_from_zip(resolve_dataset_zip(args), QWERTYKeyboard(),
                                       ModelConfig(), TrainingConfig(), verbose=False)
    train, test = create_contrastive_datasets(by_word, 0.8, seed=args.seed, verbose=False)
    word = test.words[0]
    t0 = time.perf_counter()
    out = eval_contrastive_cli.main(["--centroids", "--query", word, *data])
    eval_seconds = time.perf_counter() - t0
    table = {**out["recall"], **out["centroids"]}
    if not all(0.0 <= v <= 1.0 for v in table.values()):
        raise AssertionError(f"contrastive metrics out of [0, 1]: {table}")
    if out["query"] is None or out["query"][0]["word"] != word:
        raise AssertionError(f"the query for '{word}' did not find its own gesture first")
    line = {"training": "train_contrastive_cli.main", "synthetic_users": users,
            "train_gestures": len(train), "steps_per_epoch": steps,
            "batch": ContrastiveConfig().batch_words * ContrastiveConfig().gestures_per_word,
            "epoch_seconds": history["epoch_seconds"] + more["epoch_seconds"],
            "train_cli_seconds": train_seconds, "losses": losses,
            "evaluation": "eval_contrastive_cli.main --centroids --query", "test_gestures": len(test),
            "eval_cli_seconds": eval_seconds, "recall": out["recall"],
            "centroids": out["centroids"], "query": word}
    print(json.dumps(line), flush=True)
    return line


def contrastive_step_vs_cpu(device, batch_words=32, per_word=2, seq=SEQ,
                            lr=CONTRASTIVE_LR) -> dict:
    """Phase 7h: one contrastive train step (SupCon, clip, Adam) on the card
    and on the CPU from the same weights and batch: the loss, the gradients,
    BatchNorm's running statistics and the parameters after the step."""
    ds = smoke_dataset(batch_words * per_word, seq, seed=6)
    batch = torch.from_numpy(ds.gestures)
    labels = torch.arange(batch_words).repeat_interleave(per_word)
    params, bn = contrastive_encoder_init(ContrastiveConfig(), prng.PRNGKey(4))
    runs = []
    for dev in (device, torch.device("cpu")):
        state = make_contrastive_state(params, bn, dev)
        x, y = batch.to(dev), labels.to(dev)
        emb, _ = contrastive_encoder_apply(state["params"], state["bn"], x, train=True)
        grads = torch.autograd.grad(supervised_contrastive_loss(emb, y),
                                    tree_leaves(state["params"]))
        loss = contrastive_train_step(state, x, y, lr)
        runs.append({"loss": loss.item(), "grads": [g.cpu() for g in grads],
                     "bn": [t.cpu() for t in tree_leaves(state["bn"])],
                     "params": [p.detach().cpu() for p in tree_leaves(state["params"])]})
    got, want = runs
    g_scale = max(g.abs().max().item() for g in want["grads"])
    worst = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
             "grad": max((a - b).abs().max().item() for a, b in zip(got["grads"], want["grads"]))
             / g_scale,
             "bn": max((a - b).abs().max().item() for a, b in zip(got["bn"], want["bn"])),
             "param": max(((a - b).abs() - 2 * lr * (g.abs() < 1e-4 * g_scale)).max().item()
                          for a, b, g in zip(got["params"], want["params"], want["grads"]))}
    line = {"check": "contrastive_train_step on the card vs CPU", "batch": len(batch),
            "dtype": "float32", "lr": lr, "errors": worst,
            "tolerances": {**CONTRASTIVE_TOL, "param_near_zero_grad": "2·lr"}}
    print(json.dumps(line), flush=True)
    bad = [k for k, v in worst.items() if not v <= CONTRASTIVE_TOL[k]]
    if bad:
        raise AssertionError(f"contrastive step on the card vs CPU: {bad} {worst}")
    return line


# -- data parallelism over torch.distributed ----------------------------------------------

# Phase 9a: train_cli on the corpus's first 120 logs (2560 gestures to train
# on: 5 steps of 512), flagship recipe, bf16, one epoch under the
# profiler and one more, resumed, timed and counted. One gradient all-reduce
# per gradient computation: 2 per critic iteration and 1 for G and E.
DP_CLI_FILES = 120
DP_COLLECTIVES_PER_STEP = 2 * FLAGSHIP_TRAIN["n_critic"] + 1
TRACE_KERNELS = ("bilstm_fused_mma_kernel", "train_fwd_mma_kernel", "train_bwd_sweep_mma_kernel",
                 "train_bwd_wgrad_mma_kernel")
# Phase 9b: two gloo ranks on the card against one process on the card, from
# the same state and noise: losses 1e-5 of max(1, |loss|); gradients (Adam's
# moments after a step at lr=0) 1e-5 of each model's largest; parameters
# after a step within 2·lr per Adam step; BatchNorm's running statistics 1e-6.
# The GAN step takes the reference recipe (measured 9.8e-7 on an H100): with
# the flagship auxiliaries, G's and E's gradients differ by up to 5.4e-4 of
# the largest, since the speed-profile and Pearson terms amplify the last-bit
# differences between the card's matrix products at B=16 and at B=32 (the
# reason phase 6 holds the flagship step to 1e-2 against the CPU); the
# CPU tests hold the flagship recipe's two-rank step to 1e-5.
DP_BATCH, DP_LR, DP_WORDS, DP_RECIPE = 32, 2e-4, 32, "reference"
DP_TOL = {"loss": 1e-5, "grad": 1e-5, "bn": 1e-6}
DP_WORKER_TIMEOUT = 600


def distributed_env(rank: int, world: int, port: int) -> dict:
    return {"WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def train_cli_nccl(device, workdir: Path, users=EVAL_USERS, files=DP_CLI_FILES,
                   batch_size=512, model_args=()) -> dict:
    """Phase 9a: ``train_cli.main`` as rank 0 of a one-rank NCCL process group
    (``WGG_DISTRIBUTED=1``) on phase 7's corpus: one epoch with
    ``--profile-dir``, then one more, resumed, with every count set to 0
    just before. Gradient all-reduces 11 per step, kernels 1-3 5/3/3 per step
    on their tensor-core paths, rank 0's checkpoints, a trace naming the
    kernels; ms per step. Then phase 9a': a third epoch, resumed, with
    ``RuntimeConfig.scan_epoch`` (the step and its 11 NCCL all-reduces
    captured as one CUDA graph, replayed per batch), counted the same way,
    one replay under the group profiled, and phase 5e's check (graphed
    against eager epochs, bit-equal) run under the group."""
    import os
    from unittest import mock

    from wordgesture_gan_tpu_torch.parallel import (all_reduce_gradients, create_mesh,
                                                    maybe_init_distributed,
                                                    shutdown_distributed)

    ckpt, traces = workdir / "checkpoints_dp", workdir / "trace_dp"
    args = ["--synthetic", "--synthetic-users", str(users), "--max-files", str(files),
            "--data", str(workdir / "swipelogs.zip"), "--checkpoint-dir", str(ckpt),
            "--device", device.type, "--batch-size", str(batch_size), "--precision", "bfloat16",
            "--lambda-speed", "2.0", "--lambda-div", "0.3", "--lambda-dtc", "4.0", *model_args]
    env = {"WGG_DISTRIBUTED": "1", **distributed_env(0, 1, free_port())}
    with mock.patch.dict(os.environ, env):
        if not maybe_init_distributed(device, verbose=False, timeout=300):
            raise AssertionError("WGG_DISTRIBUTED=1 did not start a process group")
        try:
            backend = torch.distributed.get_backend()
            if device.type == "cuda" and backend != "nccl":
                raise AssertionError(f"the process group runs {backend}, not NCCL")
            first = train_cli.main(["--epochs", "1", "--profile-dir", str(traces), *args])
            counters = {"bilstm_fused": fused_bilstm_fwd, "bilstm_train_fwd": bilstm_train_fwd,
                        "bilstm_train_bwd": bilstm_train_bwd}
            reset_launches(*counters.values(), all_reduce_gradients)
            second = train_cli.main(["--epochs", "2", *args])
            second_epoch = latest_epoch(str(ckpt))
            launches = {name: c.launches for name, c in counters.items()}
            by_path = {name: dict(c.launches_by_path) for name, c in counters.items()}
            collectives = all_reduce_gradients.launches
            reset_launches(*counters.values(), all_reduce_gradients)
            third = train_cli.main(["--epochs", "3", *args], scan_epoch=True)
            scan = {"launches": {name: c.launches for name, c in counters.items()},
                    "by_path": {name: dict(c.launches_by_path) for name, c in counters.items()},
                    "collectives": all_reduce_gradients.launches}
            still_up = torch.distributed.is_initialized()
            if device.type == "cuda":
                mcfg = ModelConfig(time_head="monotone", compute_dtype="bfloat16")
                tcfg = TrainingConfig(**dict(FLAGSHIP_TRAIN, batch_size=batch_size),
                                      div_margin=0.25)
                ds = smoke_dataset(batch_size, mcfg.seq_length)
                batch = {"gesture": torch.from_numpy(ds.gestures).to(device),
                         "prototype": torch.from_numpy(ds.prototypes).to(device)}
                mesh = create_mesh(device=device)
                scan["profile"] = profile_replay(
                    lambda s, eb, graph: gan_train_epoch(s, eb, 1e-5, mcfg, tcfg, mesh=mesh,
                                                         graph=graph),
                    third.state, batch, "gan_train_step under NCCL (CUDA graph replay)",
                    batch=batch_size, dtype="bfloat16")
                scan["check"] = graphed_vs_eager(device, "bfloat16", batch=batch_size, mesh=mesh)
        finally:
            shutdown_distributed()
    steps = second.gestures_per_epoch // batch_size
    if not still_up or second_epoch != 2 or len(second.history) != 1 or steps < 1:
        raise AssertionError("train_cli under the process group did not checkpoint 2 epochs")
    if first.throughput.n_chips != 1 or collectives != DP_COLLECTIVES_PER_STEP * steps:
        raise AssertionError(f"{collectives} gradient all-reduces in {steps} steps, expected "
                             f"{DP_COLLECTIVES_PER_STEP} a step")
    if latest_epoch(str(ckpt)) != 3 or len(third.history) != 1:
        raise AssertionError("the scan_epoch run under the process group did not resume")
    if scan["collectives"] != DP_COLLECTIVES_PER_STEP * steps:
        raise AssertionError(f"{scan['collectives']} gradient all-reduces in {steps} graphed "
                             f"steps, expected {DP_COLLECTIVES_PER_STEP} a step")
    if device.type == "cuda":
        expected = {name: per * steps for name, per in PER_STEP.items()}
        paths = {name: (bilstm_fused.kernel_path if name == "bilstm_fused" else kernel_path)(
            torch.bfloat16, HIDDEN, SEQ, 1) for name in counters}
        want = {name: only_path(counters[name], paths[name], expected[name]) for name in counters}
        if launches != expected or by_path != want:
            raise AssertionError(f"launches {launches} by path {by_path}, expected {want}")
        if scan["launches"] != expected or scan["by_path"] != want:
            raise AssertionError(f"graphed launches {scan['launches']} by path "
                                 f"{scan['by_path']}, expected {want}")
    trace_files = sorted(traces.glob("trace_rank0_*.json"))
    if len(trace_files) != 1:
        raise AssertionError(f"--profile-dir wrote {trace_files}")
    text = trace_files[0].read_text()
    named = {k: k in text for k in TRACE_KERNELS}
    if device.type == "cuda" and not all(named.values()):
        raise AssertionError(f"the trace does not name every kernel: {named}")
    for losses in first.history + second.history + third.history:
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses {losses}")
    scan_line = {"training": "train_cli.main, NCCL process group of 1 rank, scan_epoch",
                 "steps_per_epoch": steps, "dtype": "bfloat16",
                 "ms_per_step": third.epoch_seconds[0] / steps * 1e3,
                 "eager_ms_per_step": second.epoch_seconds[0] / steps * 1e3,
                 "gradient_all_reduces": scan["collectives"], "launches": scan["launches"],
                 "launches_by_path": scan["by_path"], "profile": scan.get("profile"),
                 "check_vs_eager": scan.get("check")}
    print(json.dumps(scan_line), flush=True)
    line = {"training": "train_cli.main, NCCL process group of 1 rank", "backend": backend,
            "gestures_per_epoch": second.gestures_per_epoch, "steps_per_epoch": steps,
            "dtype": "bfloat16", "ms_per_step": second.epoch_seconds[0] / steps * 1e3,
            "profiled_epoch_ms_per_step": first.epoch_seconds[0] / steps * 1e3,
            "gradient_all_reduces": collectives,
            "gradient_all_reduces_per_step": collectives / steps, "launches": launches,
            "trace_file_mb": trace_files[0].stat().st_size / 2 ** 20, "trace_names": named}
    print(json.dumps(line), flush=True)
    line["scan"] = scan_line
    return line


QUALITY_EPOCHS = 2


def quality_runner(device, workdir: Path, users=EVAL_USERS, files=DP_CLI_FILES,
                   epochs=QUALITY_EPOCHS, batch_size=512, train_args: str = "",
                   eval_args: str = f"--fid-epochs {EVAL_FID_EPOCHS}") -> dict:
    """Phase 12: ``tools/port_quality_runs.py`` on phase 9a's corpus, cut to
    ``epochs`` epochs: the flagship run trained through ``train_cli.main(...,
    scan_epoch=True)``, scored by ``eval_cli --model both`` and reported
    against the JAX package's runs. Launches counted from 0 just before:
    5/3/3 a training step on the tensor-core paths; the totals are the sums
    of what the runner recorded per call; ``results.json`` holds both
    columns, the bands and the checks."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_quality_runs", Path(__file__).resolve().parent / "tools" / "port_quality_runs.py")
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    out = workdir / "quality_runs"
    counters = {"bilstm_fused": fused_bilstm_fwd, "bilstm_train_fwd": bilstm_train_fwd,
                "bilstm_train_bwd": bilstm_train_bwd, "dtw": dtw_matrix,
                "dtw_aligned_pairs": dtw_pairs}
    reset_launches(*counters.values())
    t0 = time.perf_counter()
    runner.main(["--runs", "flag", "--out", str(out), "--device", device.type,
                 "--data", str(workdir / "swipelogs.zip"), "--epochs", str(epochs),
                 "--synthetic-users", str(users), "--max-files", str(files),
                 "--train-args", f"--batch-size {batch_size} {train_args}",
                 "--eval-args", eval_args])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    by_path = {name: dict(c.launches_by_path) for name, c in counters.items()
               if hasattr(c, "launches_by_path")}
    saved = json.loads((out / "results.json").read_text())
    flag = saved["runs"]["flag"]
    train_call, eval_call = flag["runner"]["train_calls"][0], flag["runner"]["eval_calls"][0]
    steps = epochs * (train_call["gestures_per_epoch"] // batch_size)
    for table in ("metrics", "minjerk"):
        if not all(np.isfinite(row["port"]) and (row["outside"] is None) == (
                       key in runner.NO_BAND)
                   for key, row in flag[table].items() if row["jax"] is not None
                   and row["port"] is not None):
            raise AssertionError(f"the report's {table} rows are not whole: {flag[table]}")
    if flag["epochs"] != epochs or not {"margin", "counts_flag", "minjerk_flag"} <= set(
            saved["checks"]):
        raise AssertionError(f"the report misses epochs or checks: {saved['checks']}")
    for name, c in counters.items():
        recorded = [call["launches"][name] for call in (train_call, eval_call)]
        total = sum(sum(r.values()) if isinstance(r, dict) else r for r in recorded)
        if total != launches[name]:
            raise AssertionError(f"{name}: {launches[name]} launches, the runner recorded "
                                 f"{recorded}")
    if device.type == "cuda":
        paths = {name: (bilstm_fused.kernel_path if name == "bilstm_fused" else kernel_path)(
            torch.bfloat16, HIDDEN, SEQ, 1) for name in PER_STEP}
        want = {name: {paths[name]: per * steps} for name, per in PER_STEP.items()}
        got = {name: train_call["launches"][name] for name in PER_STEP}
        if steps < 1 or got != want:
            raise AssertionError(f"training launches {got}, expected {want}")
        if eval_call["launches"]["dtw"] != 2:
            raise AssertionError(f"evaluation launches {eval_call['launches']}")
    line = {"runner": "tools/port_quality_runs.py --runs flag", "epochs": epochs,
            "steps": steps, "seconds": wall, "train_seconds": train_call["seconds"],
            "eval_seconds": eval_call["seconds"],
            "ms_per_step_replays": [t / (steps // epochs) * 1e3
                                    for t in train_call["epoch_seconds"]],
            "launches": launches, "launches_by_path": by_path,
            "train_launches": train_call["launches"], "eval_launches": eval_call["launches"],
            "checks": {k: v["ok"] for k, v in saved["checks"].items()},
            "outside": sorted(k for k, row in flag["metrics"].items() if row["outside"])}
    print(json.dumps(line), flush=True)
    return line


def _dp_inputs(model: dict = None, seq: int = SEQ, batch: int = DP_BATCH,
               words: int = DP_WORDS, recipe: str = DP_RECIPE) -> tuple:
    """Phase 9b's step inputs: ``recipe`` (STEP_RECIPES) in float32 at full
    width (``model`` overrides widths for a rehearsal on the CPU), a smoke
    batch, injected noise; the contrastive batch of ``words`` words x 2 gestures,
    each word's first gesture in the first half (rank 0) and its second in
    the second half (rank 1), and the encoder's seeded weights."""
    model = {k: tuple(v) if isinstance(v, list) else v for k, v in (model or {}).items()}
    mcfg = ModelConfig(**{"time_head": "monotone", "compute_dtype": "float32", **model})
    lambdas = STEP_RECIPES[recipe][0]
    tcfg = TrainingConfig(**dict(lambdas, batch_size=batch, n_critic=5), div_margin=0.25)
    ds = smoke_dataset(batch, mcfg.seq_length, seed=3)
    data = {"gesture": torch.from_numpy(ds.gestures), "prototype": torch.from_numpy(ds.prototypes)}
    noise = _step_noise(batch, mcfg.latent_dim, tcfg.n_critic, seed=6)
    gestures = torch.from_numpy(smoke_dataset(2 * words, seq, seed=6).gestures)
    labels = torch.arange(words).repeat(2)
    params, bn = contrastive_encoder_init(ContrastiveConfig(), prng.PRNGKey(4))
    return mcfg, tcfg, data, noise, gestures, labels, (params, bn)


def _snapshot(state: dict, metrics: dict) -> dict:
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    for m in (MODELS if "g" in state else ("c",)):
        s = state[m] if m != "c" else state
        out[m] = {part: [t.detach().cpu() for t in tree_leaves(s["opt"][part])]
                  for part in ("mu", "nu")}
        out[m]["params"] = [p.detach().cpu() for p in tree_leaves(s["params"])]
    if "bn" in state:
        out["bn"] = [t.cpu() for t in tree_leaves(state["bn"])]
    return out


def dp_steps(device, mesh, **inputs) -> dict:
    """One GAN step and one contrastive step at lr=0 and at lr > 0, each from
    a fresh state, on ``mesh``'s ranks (None: this process alone)."""
    from wordgesture_gan_tpu_torch.parallel import all_reduce_gradients

    mcfg, tcfg, data, noise, gestures, labels, (params, bn) = _dp_inputs(**inputs)
    out = {}
    for lr in (0.0, DP_LR):
        state = init_gan_state(0, mcfg, device=device)
        before = all_reduce_gradients.launches
        _, metrics = gan_train_step(state, {k: v.to(device) for k, v in data.items()}, lr, mcfg,
                                    tcfg, noise={k: v.to(device) for k, v in noise.items()},
                                    mesh=mesh)
        out[f"gan/{lr}"] = {**_snapshot(state, metrics),
                            "collectives": all_reduce_gradients.launches - before}
    for lr in (0.0, CONTRASTIVE_LR):
        state = make_contrastive_state(params, bn, device)
        before = all_reduce_gradients.launches
        loss = contrastive_train_step(state, gestures.to(device), labels.to(device), lr, mesh=mesh)
        out[f"contrastive/{lr}"] = {**_snapshot(state, {"loss": loss}),
                                    "collectives": all_reduce_gradients.launches - before}
    return out


def dp_worker(out_dir: str) -> int:
    """One rank of phase 9b (``chip_smoke.py --dp-worker OUT_DIR``, started by
    ``data_parallel_vs_single`` with torchrun's variables): joins the gloo
    group on the card, runs ``dp_steps`` and, on rank 0, saves the result."""
    import os

    from wordgesture_gan_tpu_torch.parallel import (create_mesh, maybe_init_distributed,
                                                    rank_device, shutdown_distributed)

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    inputs = json.loads(os.environ.get("WGG_SMOKE_DP_INPUTS", "{}"))
    device = rank_device(inputs.pop("device", "cuda"))
    maybe_init_distributed(device, backend="gloo", verbose=False, timeout=DP_WORKER_TIMEOUT)
    try:
        mesh = create_mesh(2, device=device)
        result = dp_steps(device, mesh, **inputs)
        if mesh.rank == 0:
            torch.save(result, Path(out_dir) / "dp.pt")
    finally:
        shutdown_distributed()
    return 0


def _dp_errors(got: dict, want: dict, lr: float, adam_steps: dict) -> dict:
    err = {"loss": max(abs(got["metrics"][k] - v) / max(1.0, abs(v))
                       for k, v in want["metrics"].items()),
           "grad": 0.0, "param_in_lr_per_adam_step": 0.0, "bn": 0.0, "grad_by_model": {}}
    for m in (k for k in want if k not in ("metrics", "bn", "collectives")):
        if lr == 0.0:
            for part in ("mu", "nu"):
                scale = max(t.abs().max().item() for t in want[m][part]) or 1.0
                e = max((a - b).abs().max().item() for a, b in zip(got[m][part],
                                                                  want[m][part])) / scale
                err["grad_by_model"][f"{m}/{part}"] = e
                err["grad"] = max(err["grad"], e)
        else:
            moved = max((a - b).abs().max().item() for a, b in zip(got[m]["params"],
                                                                   want[m]["params"]))
            err["param_in_lr_per_adam_step"] = max(err["param_in_lr_per_adam_step"],
                                                   moved / lr / adam_steps.get(m, 1))
    for a, b in zip(got.get("bn", []), want.get("bn", [])):
        err["bn"] = max(err["bn"], (a - b).abs().max().item())
    return err


def data_parallel_vs_single(device, workdir: Path, inputs: dict = None) -> dict:
    """Phase 9b: ``dp_steps`` on two gloo ranks sharing the card (NCCL refuses
    two ranks on one GPU), started as ``chip_smoke.py --dp-worker``, against
    ``dp_steps`` in this process alone on the same card, with DP_TOL; one
    gradient all-reduce per gradient computation. ``inputs`` overrides
    ``_dp_inputs``' widths (and the device) for a rehearsal on the CPU."""
    import os

    inputs = dict(inputs or {})
    port = free_port()
    env_inputs = json.dumps({**inputs, "device": device.type})
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-worker",
                               str(workdir)],
                              env={**os.environ, **distributed_env(rank, 2, port),
                                   "WGG_SMOKE_DP_INPUTS": env_inputs},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        t0 = time.perf_counter()
        want = dp_steps(device, None, **inputs)
        outs = [p.communicate(timeout=DP_WORKER_TIMEOUT)[0] for p in procs]
        seconds = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"data-parallel rank {rank} failed:\n{out[-4000:]}")
    got = torch.load(workdir / "dp.pt", weights_only=False)
    n_critic = FLAGSHIP_TRAIN["n_critic"]
    line = {"check": "two gloo ranks on the card vs one process on the card", "batch": DP_BATCH,
            "contrastive_batch": 2 * DP_WORDS, "dtype": "float32", "seconds": seconds,
            "tolerances": {**DP_TOL, "param_in_lr_per_adam_step": 2}, "errors": {},
            "collectives": {}}
    for key in want:
        kind, lr = key.split("/")
        adam_steps = {"d1": n_critic, "d2": n_critic} if kind == "gan" else {}
        line["errors"][key] = err = _dp_errors(got[key], want[key], float(lr), adam_steps)
        line["collectives"][key] = got[key]["collectives"]
        expected = DP_COLLECTIVES_PER_STEP if kind == "gan" else 1
        if got[key]["collectives"] != expected or want[key]["collectives"] != 0:
            raise AssertionError(f"{key}: {got[key]['collectives']} gradient all-reduces on two "
                                 f"ranks, expected {expected}")
    print(json.dumps(line), flush=True)
    bad = {key: err for key, err in line["errors"].items()
           if not (err["loss"] <= DP_TOL["loss"] and err["grad"] <= DP_TOL["grad"]
                   and err["bn"] <= DP_TOL["bn"] and err["param_in_lr_per_adam_step"] <= 2)}
    if bad:
        raise AssertionError(f"two ranks vs one process: {bad}")
    return line


# -- the realism report ----------------------------------------------------------------------

REALISM_USERS = 200


def realism_pairs(zip_path: Path, users: int) -> tuple:
    """The (trace, prototype) pairs the realism report hands its batched DTW,
    rebuilt from the same logs: (P, 64, 2) each."""
    import zipfile

    from wordgesture_gan_tpu_torch.data import realism

    kb, cache, batch = QWERTYKeyboard(), {}, []
    with zipfile.ZipFile(zip_path) as zf:
        for name in sorted(n for n in zf.namelist() if n.endswith(".log"))[:users]:
            realism._scan_log_sentences(zf.read(name).decode("utf-8", errors="replace"), kb,
                                        cache, batch)
    return (torch.from_numpy(np.stack([t for t, _ in batch]).astype(np.float32)),
            torch.from_numpy(np.stack([p for _, p in batch]).astype(np.float32)))


def realism_report(device, workdir: Path, users=REALISM_USERS) -> dict:
    """Phase 10: ``python -m wordgesture_gan_tpu_torch.data.realism --users
    200`` on the card (its one batched DTW is kernel 4 at L=64, D=2; launches
    counted from 0), then the same command with ``--device cpu``: the four
    exact statistics equal, ``dtw_w`` 1e-4 relative. Then kernel 4 on the
    report's own pairs against its plain version, and timed beside it."""
    from wordgesture_gan_tpu_torch.data import realism

    zip_path = workdir / f"synthetic_swipelogs_{users}.zip"
    runs = {}
    for dev in ("cpu", device.type):    # the first run writes the corpus
        reset_launches(dtw_pairs)
        t0 = time.perf_counter()
        code = realism.main(["--users", str(users), "--zip", str(zip_path), "--device", dev,
                             "--save-stats", str(workdir / f"realism_{dev}.npz")])
        runs[dev] = {"exit_code": code, "seconds": time.perf_counter() - t0,
                     "dtw_launches": dtw_pairs.launches}
    stats = {dev: dict(np.load(workdir / f"realism_{dev}.npz")) for dev in (device.type, "cpu")}
    got, want = stats[device.type], stats["cpu"]
    exact = all(np.array_equal(got[k], want[k]) for k in realism.STATS if k != "dtw_w")
    dtw_rel = float(np.max(np.abs(got["dtw_w"] - want["dtw_w"]) / np.abs(want["dtw_w"])))
    if not exact or not dtw_rel <= DTW_TOL_REL:
        raise AssertionError(f"realism statistics on the card vs CPU: exact {exact}, dtw_w "
                             f"{dtw_rel}")
    if device.type == "cuda" and runs["cuda"]["dtw_launches"] != 1:
        raise AssertionError(f"the realism report launched kernel 4 "
                             f"{runs['cuda']['dtw_launches']} times, expected 1")
    x, y = realism_pairs(zip_path, users)
    pairs = x.shape[0]
    x, y = x.to(device), y.to(device)
    rel, err = _dtw_rel(dtw_pairs(x, y), dtw_pairs_plain(x, y))
    if not rel <= DTW_TOL_REL:
        raise AssertionError(f"kernel 4 on the realism pairs vs plain: {rel}")
    line = {"realism": "python -m wordgesture_gan_tpu_torch.data.realism", "users": users,
            "runs": runs, "sentences": int(len(got["time_ms"])), "dtw_pairs": pairs,
            "seq": REALISM_SEQ, "dims": 2, "dtw_w_max_rel_err": dtw_rel,
            "kernel_max_rel_err": rel, "kernel_max_abs_err": err}
    if device.type == "cuda":
        line.update(ms=time_ms(lambda: dtw_pairs(x, y), iters=20),
                    plain_ms=time_ms(lambda: dtw_pairs_plain(x, y), iters=3, warmup=1),
                    **dtw_bound_ms(pairs, pairs, pairs, REALISM_SEQ, 2), library_ms=None)
    print(json.dumps(line), flush=True)
    return {**line, "launches": runs[device.type]["dtw_launches"]}


# -- reference weights ------------------------------------------------------------------------


def reference_layout(state: dict) -> dict:
    """A train state's four models as the CHI'23 reference implementation's
    ``state_dict``s (numpy): Linear weights (out, in), LSTM gates (4H, in),
    Conv1d (out, in, k), spectral-norm ``weight_orig`` and ``weight_u``."""
    def a(t):
        return t.detach().cpu().numpy()

    def linear(sd, prefix, p, u=None):
        sd[f"{prefix}.weight_orig" if u is not None else f"{prefix}.weight"] = a(p["w"]).T.copy()
        sd[f"{prefix}.bias"] = a(p["b"])
        if u is not None:
            sd[f"{prefix}.weight_u"] = a(u)

    g = state["g"]["params"]
    gen = {}
    for k, layer in enumerate(g["lstm"]):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            for name in ("w_ih", "w_hh"):
                gen[f"lstm.weight_{name[2:]}_l{k}{suffix}"] = a(layer[d][name]).T.copy()
            for name in ("b_ih", "b_hh"):
                gen[f"lstm.bias_{name[2:]}_l{k}{suffix}"] = a(layer[d][name])
    linear(gen, "output_layer", g["out"])
    e = state["e"]["params"]
    enc = {}
    for i, p in enumerate(e["mlp"]):
        linear(enc, f"encoder.{2 * i}", p)
    linear(enc, "fc_mu", e["mu"])
    linear(enc, "fc_log_var", e["log_var"])
    discs = {}
    for m in ("d1", "d2"):
        p, u, sd = state[m]["params"], state[m]["sn"], {}
        for idx, conv, cu in zip((0, 2, 4), p["convs"], u["convs"]):
            sd[f"temporal_conv.{idx}.weight_orig"] = a(conv["w"]).transpose(2, 1, 0).copy()
            sd[f"temporal_conv.{idx}.bias"] = a(conv["b"])
            sd[f"temporal_conv.{idx}.weight_u"] = a(cu)
        for idx, lin, lu in zip((0, 2), p["mlp"], u["mlp"]):
            linear(sd, f"mlp.{idx}", lin, lu)
        linear(sd, "output_layer", p["out"], u["out"])
        discs[m] = sd
    return {"generator": gen, "encoder": enc, "discriminator_1": discs["d1"],
            "discriminator_2": discs["d2"]}


def serve_reference_weights(device, workdir: Path, n=512, batch=SERVE_BATCH, seed=11) -> dict:
    """Phase 11: seeded full-width weights in the reference implementation's
    layout through ``interop.torch_weights.trainer_state_from_torch`` (which
    must give back the same trees), saved as a checkpoint and served through
    ``generate.main --checkpoint-dir`` (bf16, 512 gestures, kernel 1 counted
    from 0), then a small batch with injected noise against the CPU."""
    from wordgesture_gan_tpu_torch.interop.torch_weights import trainer_state_from_torch
    from wordgesture_gan_tpu_torch.train.checkpoint import save_checkpoint, save_run_metadata

    mcfg = ModelConfig(time_head="tanh")
    source = init_gan_state(seed, mcfg, device="cpu")
    state = trainer_state_from_torch(reference_layout(source), mcfg, seed=seed, device="cpu")
    for m in MODELS:
        trees = [(state[m]["params"], source[m]["params"])]
        if m in ("d1", "d2"):
            trees.append((state[m]["sn"], source[m]["sn"]))
        for got, want in trees:
            if not all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want))):
                raise AssertionError(f"trainer_state_from_torch changed {m}'s weights")
    ckpt = workdir / "reference_weights"
    save_checkpoint(state, str(ckpt), 0)
    save_run_metadata(str(ckpt), generator_type="bilstm", time_head="tanh",
                      gen_hidden_dim=HIDDEN)
    out = workdir / "reference_gestures.npz"
    reset_launches(fused_bilstm_fwd)
    stats = generate.main(["--words", ",".join(WORDS), "--n", str(n), "--batch", str(batch),
                           "--precision", "bfloat16", "--checkpoint-dir", str(ckpt),
                           "--out", str(out), "--device", device.type])
    launches, by_path = fused_bilstm_fwd.launches, dict(fused_bilstm_fwd.launches_by_path)
    with np.load(out) as data:
        gestures = data["gestures"]
    if gestures.shape != (n, SEQ, 3) or not np.isfinite(gestures).all():
        raise AssertionError(f"served {gestures.shape} gestures, finite "
                             f"{np.isfinite(gestures).all()}")
    expected = chunk_layout(n, batch)[1]
    path = bilstm_fused.kernel_path(torch.bfloat16, HIDDEN, SEQ, LAYERS)
    if device.type == "cuda" and by_path != only_path(fused_bilstm_fwd, path, expected):
        raise AssertionError(f"kernel 1 launches {by_path}, expected {expected} on {path}")
    config = ModelConfig(time_head="tanh", compute_dtype="bfloat16")
    rng = np.random.default_rng(8)
    kb = QWERTYKeyboard()
    protos = np.stack([kb.get_word_prototype(WORDS[i], SEQ) for i in rng.integers(0, 40, 48)])
    z = rng.normal(size=(len(protos), LATENT)).astype(np.float32)
    path_ckpt = str(find_checkpoint(str(ckpt)))
    got = generate_gestures(load_generator(path_ckpt, config, device=device), protos, config,
                            batch=32, device=device, z=z)
    want = generate_gestures(load_generator(path_ckpt, config, device="cpu"), protos, config,
                             batch=32, device="cpu", z=z)
    err = float(np.abs(got - want).max())
    line = {"serving": "generate.main on reference-layout weights", "n": n,
            "gestures_per_s": stats["gestures_per_s"], "launches": launches,
            "launches_by_path": by_path, "max_abs_err_vs_cpu": err,
            "tolerance": TOLERANCE["bfloat16"]}
    print(json.dumps(line), flush=True)
    if not err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"reference weights served on the card differ from the CPU by {err}")
    return line


# -- the MLP and transformer generators, and the variable-length path ---------------------

FAMILIES = ("mlp", "transformer")
VL_TRAIN_EPOCHS = 2            # variable-length training: 2 epochs at batch 512
VL_STEP_LENGTHS = (8, 128)     # true lengths of the masked step's batch, drawn in this range
# The masked step against the CPU: the reference recipe (no auxiliaries),
# float32; gradients (Adam's moments at lr=0) within 1e-3 of each leaf's
# largest, as for the BiLSTM step; losses and parameters as STEP_*.
VL_STEP_GRAD_TOL = 1e-3
# Card vs CPU arc-length resampling, abs: the float32 cumulative arc length
# of up to 127 segments sums in another order on the card (measured 9.2e-6
# on an H100 over 2000 traces), which moves the targets' fractions.
RESAMPLE_TOL = 1e-4


def serve_family(device, workdir: Path, family: str, n=SERVE_N, batch=SERVE_BATCH,
                 runs=2) -> dict:
    """Phase 4b: the MLP or transformer generator through ``generate.main`` at
    full width (seeded PyTorch-default weights written as a JAX-layout npz),
    bfloat16, monotone time head: the gestures' shape, range and clock, then
    a small request with injected noise against the CPU. These families run
    no BiLSTM kernel: the first run's kernel-1 launches must be 0; the
    transformer's attention takes ``csrc/attention.cu``, one forward a layer
    a chunk, no plain call."""
    config = ModelConfig(generator_type=family, time_head="monotone", compute_dtype="bfloat16")
    tree = generator_init(config, prng.PRNGKey(0))
    weights = workdir / f"{family}.npz"
    write_generator_npz(tree_map(lambda t: t.detach().numpy(), tree), str(weights))
    out = workdir / f"{family}_gestures.npz"
    argv = ["--words", ",".join(WORDS), "--n", str(n), "--batch", str(batch),
            "--precision", "bfloat16", "--time-head", "monotone", "--generator", family,
            "--seed", "0", "--weights", str(weights), "--checkpoint-dir", str(workdir),
            "--out", str(out), "--device", device.type]
    stats = []
    for run in range(runs):
        reset_launches(fused_bilstm_fwd, attention_launches)
        stats.append(generate.main(argv))
        if run == 0 and fused_bilstm_fwd.launches:
            raise AssertionError(f"the {family} generator launched the BiLSTM kernel")
        attention_calls = {f"{op}/{p}": n for (op, p), n
                           in attention_launches.launches_by_path.items() if n}
        layers_n = config.tfm_num_layers if family == "transformer" else 0
        want = {"attention_fwd/cuda": chunk_layout(n, batch)[1] * layers_n} if layers_n else {}
        if device.type == "cuda" and run == 0 and attention_calls != want:
            raise AssertionError(f"{family}: attention calls {attention_calls}, expected {want}")
    with np.load(out) as data:
        check_gestures(data["gestures"], n, SEQ)

    rng = np.random.default_rng(7)
    kb = QWERTYKeyboard()
    protos = np.stack([kb.get_word_prototype(WORDS[i], SEQ)
                       for i in rng.integers(0, len(WORDS), 48)])
    z = rng.normal(size=(len(protos), LATENT)).astype(np.float32)
    got, want = [generate_gestures(load_generator(str(weights), config, device=dev), protos,
                                   config, batch=32, device=dev, z=z) for dev in (device, "cpu")]
    err = float(np.abs(got - want).max())
    line = {"serving": "generate.main", "generator": family, "n": n, "batch": batch,
            "dtype": "bfloat16", "chunks": chunk_layout(n, batch)[1],
            "gestures_per_s_first_run": stats[0]["gestures_per_s"],
            "gestures_per_s": stats[-1]["gestures_per_s"], "seconds": stats[-1]["seconds"],
            "attention_calls_last_run": attention_calls,
            "vs_cpu": {"n": len(protos), "max_abs_err": err,
                       "tolerance": TOLERANCE["bfloat16"]}}
    print(json.dumps(line), flush=True)
    if not err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"{family}: served gestures differ from the CPU path by {err}")
    if device.type == "cuda":
        model = load_generator(str(weights), config, device=device)
        kb_protos = np.stack([kb.get_word_prototype(WORDS[i % len(WORDS)], SEQ) for i in range(n)])
        generate_gestures(model, kb_protos, config, batch=batch, device=device)     # warm
        line["profile"] = device_profile(
            lambda: generate_gestures(model, kb_protos, config, batch=batch, device=device),
            "generate_gestures", generator=family, n=n, batch=batch)
    return line


def variable_data(workdir: Path, users=EVAL_USERS, checkpoint_dir: str = "checkpoints_vl") -> list:
    """The CLI flags of the variable-length phases: the evaluation's synthetic
    corpus (written there by phase 7, read from its cache here)."""
    return ["--synthetic", "--synthetic-users", str(users), "--data",
            str(workdir / "swipelogs.zip"), "--checkpoint-dir", str(workdir / checkpoint_dir)]


def train_variable(device, workdir: Path, users=EVAL_USERS, epochs=VL_TRAIN_EPOCHS,
                   batch_size=512) -> dict:
    """Phase 9: ``train_cli.main --variable-length`` (the masked transformer
    step, bfloat16, default recipe) on the synthetic corpus; losses finite,
    every epoch checkpointed; one steady masked step profiled."""
    data = [*variable_data(workdir, users), "--device", device.type]
    t0 = time.perf_counter()
    result = train_cli.main(["--variable-length", "--epochs", str(epochs),
                             "--batch-size", str(batch_size), *data])
    wall = time.perf_counter() - t0
    ckpt = data[data.index("--checkpoint-dir") + 1]
    if latest_epoch(ckpt) != epochs or len(result.history) != epochs:
        raise AssertionError("train_cli --variable-length did not train the requested epochs")
    for losses in result.history:
        bad = [k for k, v in losses.items() if not np.isfinite(v)]
        if bad or set(losses) != set(MASKED_METRIC_KEYS) | {"lr"}:
            raise AssertionError(f"variable-length losses {losses}")
    steps = result.gestures_per_epoch // batch_size
    seconds = result.epoch_seconds
    line = {"training": "train_cli.main --variable-length", "synthetic_users": users,
            "n": result.gestures_per_epoch, "batch": batch_size, "steps_per_epoch": steps,
            "dtype": "bfloat16", "epoch_seconds": seconds,
            "gestures_per_s": [result.gestures_per_epoch / t for t in seconds],
            "ms_per_step": [t / steps * 1e3 for t in seconds], "wall_seconds": wall,
            "seconds_outside_epochs": wall - sum(seconds), "losses_last_epoch": result.history[-1]}
    print(json.dumps(line), flush=True)
    if device.type == "cuda":
        args = train_cli.build_parser().parse_args(data)
        mcfg = ModelConfig(generator_type="transformer", time_head="monotone",
                           compute_dtype="bfloat16")
        tcfg = TrainingConfig(batch_size=batch_size)
        by_word, _ = load_variable_dataset_from_zip(resolve_dataset_zip(args), QWERTYKeyboard(),
                                                    seed=args.seed, verbose=False)
        train_ds, _ = create_variable_split(by_word, QWERTYKeyboard(), seed=args.seed,
                                            verbose=False)
        batch = {"gesture": train_ds.gestures[:batch_size],
                 "prototype": train_ds.prototypes[:batch_size],
                 "mask": train_ds.masks()[:batch_size]}
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        gan_train_step_masked(result.state, batch, 1e-5, mcfg, tcfg)        # warm
        line["profile"] = device_profile(
            lambda: gan_train_step_masked(result.state, batch, 1e-5, mcfg, tcfg),
            "gan_train_step_masked", batch=batch_size, dtype="bfloat16")
    return line


def train_variable_scan(device, workdir: Path, users=EVAL_USERS, epochs=VL_TRAIN_EPOCHS,
                        batch_size=512) -> dict:
    """Phase 7b': ``train_variable_gan`` with ``RuntimeConfig(scan_epoch=True)``
    (the masked step captured once as a CUDA graph, replayed per batch) on
    phase 7b's corpus and recipe (bfloat16), ``epochs`` epochs checkpointed;
    losses finite; one replay profiled."""
    data = variable_data(workdir, users, checkpoint_dir="checkpoints_vl_scan")
    args = train_cli.build_parser().parse_args([*data, "--device", device.type])
    by_word, _ = load_variable_dataset_from_zip(resolve_dataset_zip(args), QWERTYKeyboard(),
                                                seed=args.seed, verbose=False)
    train_ds, _ = create_variable_split(by_word, QWERTYKeyboard(), seed=args.seed, verbose=False)
    mcfg = ModelConfig(generator_type="transformer", time_head="monotone",
                       compute_dtype="bfloat16")
    tcfg = TrainingConfig(batch_size=batch_size)
    ckpt = data[data.index("--checkpoint-dir") + 1]
    result = train_variable_gan(train_ds, mcfg, tcfg, RuntimeConfig(scan_epoch=True),
                                num_epochs=epochs, checkpoint_dir=ckpt, device=device)
    if latest_epoch(ckpt) != epochs or len(result.history) != epochs:
        raise AssertionError("train_variable_gan with scan_epoch did not train the epochs")
    for losses in result.history:
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"variable-length losses {losses}")
    steps = result.gestures_per_epoch // batch_size
    line = {"training": "train_variable_gan, scan_epoch", "synthetic_users": users,
            "n": result.gestures_per_epoch, "batch": batch_size, "steps_per_epoch": steps,
            "dtype": "bfloat16", "epoch_seconds": result.epoch_seconds,
            "ms_per_step": [t / steps * 1e3 for t in result.epoch_seconds],
            "losses_last_epoch": result.history[-1]}
    print(json.dumps(line), flush=True)
    if device.type == "cuda":
        batch = {"gesture": train_ds.gestures[:batch_size],
                 "prototype": train_ds.prototypes[:batch_size],
                 "mask": train_ds.masks()[:batch_size]}
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        line["profile"] = profile_replay(
            lambda s, eb, graph: gan_train_epoch_masked(s, eb, 1e-5, mcfg, tcfg, graph=graph),
            result.state, batch, "gan_train_step_masked (CUDA graph replay)", batch=batch_size,
            dtype="bfloat16")
    return line


def masked_step_vs_cpu(device, batch=STEP_BATCH, model: dict = None) -> dict:
    """Phase 10: one float32 masked step (full-width transformer, n_critic 5,
    the reference recipe) on the card and on the CPU from the same state,
    batch, mask and injected noise. ``model`` overrides configuration fields
    (a rehearsal on the CPU at a tiny size)."""
    mcfg = ModelConfig(**{"generator_type": "transformer", "time_head": "monotone",
                          **(model or {})})
    tcfg = TrainingConfig(batch_size=batch, n_critic=5)
    data, noise = _step_inputs("masked", batch, mcfg)
    lengths = data["mask"].sum(dim=1)
    worst = compare_step(device, gan_train_step_masked, mcfg, tcfg, data, noise, VL_STEP_GRAD_TOL)
    line = {"check": "gan_train_step_masked on the card vs CPU", "batch": batch,
            "dtype": "float32", "lengths": [int(lengths.min()), int(lengths.max())], **worst,
            "tolerances": {"loss": STEP_LOSS_TOL, "grad": VL_STEP_GRAD_TOL,
                           "param_in_lr_per_adam_step": 2}}
    print(json.dumps(line), flush=True)
    return line


def evaluate_variable(device, workdir: Path, users=EVAL_USERS, n=EVAL_N,
                      fid_epochs=EVAL_FID_EPOCHS) -> dict:
    """Phase 11: ``eval_cli.main --variable-length --n-samples 2000`` with DTW
    on, on phase 9's checkpoint: masked sampling, resampling onto the
    128-point grid on the card, the metric suite. Launches counted from 0:
    one kernel-4 matrix, no BiLSTM kernel. Every metric finite, precision and
    recall in [0, 1], DTW-Wasserstein > 0; the card's resampling against the
    CPU's on the real side."""
    data = [*variable_data(workdir, users), "--device", device.type]
    counters = {"dtw": dtw_matrix, "dtw_aligned_pairs": dtw_pairs, "bilstm_fused": fused_bilstm_fwd}
    reset_launches(*counters.values())
    t0 = time.perf_counter()
    out = eval_cli.main(["--variable-length", "--n-samples", str(n), "--fid-epochs",
                         str(fid_epochs), *data])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    if out["n"] != n:
        raise AssertionError(f"the variable-length test split gave {out['n']} samples, not {n}")
    _check_results("variable-length gan", out["gan"])
    expected = {"dtw": 1, "dtw_aligned_pairs": 0, "bilstm_fused": 0}
    if device.type == "cuda" and launches != expected:
        raise AssertionError(f"launches on the variable-length evaluation {launches}, "
                             f"expected {expected}")

    args = eval_cli.build_parser().parse_args(data)
    by_word, _ = load_variable_dataset_from_zip(resolve_dataset_zip(args), QWERTYKeyboard(),
                                                seed=args.seed, verbose=False)
    _, test_ds = create_variable_split(by_word, QWERTYKeyboard(), seed=args.seed, verbose=False)
    real, lengths = torch.from_numpy(test_ds.gestures[:n]), torch.from_numpy(test_ds.lengths[:n])
    got = batched_arclength_resample(real.to(device), lengths.to(device), SEQ).cpu()
    err = (got - batched_arclength_resample(real, lengths, SEQ)).abs().max().item()
    if not err <= RESAMPLE_TOL:
        raise AssertionError(f"resampling on the card differs from the CPU by {err}")
    line = {"evaluation": "eval_cli.main --variable-length", "n": n, "pairs_per_matrix": n * n,
            "synthetic_users": users, "generator": "train_cli.main --variable-length",
            "fid_epochs": fid_epochs, "seconds": wall, "stage_seconds": out["stage_seconds"],
            "launches": launches, "lengths": [int(test_ds.lengths[:n].min()),
                                              int(test_ds.lengths[:n].max())],
            "resample_vs_cpu_max_abs_err": err, "resample_tolerance": RESAMPLE_TOL,
            "gan": {k: out["gan"][k] for k in EVAL_SCALARS}}
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    if sys.argv[1:2] == ["--dp-worker"]:     # one rank of phase 9b
        return dp_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 references in full float32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0],
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}), flush=True)

    t0 = time.perf_counter()
    logs = kernel_build.build(["bilstm_fused", "bilstm_train", "dtw", "threefry", "activations",
                               "attention", "layernorm", "bias"])
    for name, log in logs.items():
        kernel = ""
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '\w*?\d+((?:train|bilstm|dtw|threefry|"
                              r"activation|attn|layernorm|bias)_?\w*?kernel)"
                              r"(?:ILi(\d+)E(?:Li(\d)E)?|I(f|13__nv_bfloat16))?", line)
            if entry:   # the mangled name: kernel, then its template arguments
                kernel = entry.group(1) + "".join(f"<{g.replace('13__nv_', '')}>"
                                                  for g in entry.groups()[1:] if g)
            if "registers" in line or "spill" in line:
                print(f"[{name}] {kernel}: {line.strip()}", flush=True)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"occupancy": "bilstm_train tensor-core kernels", "hidden": HIDDEN,
                      **mma_kernel_info(HIDDEN)}), flush=True)
    print(json.dumps({"occupancy": "bilstm_fused tensor-core and float32 kernels",
                      "hidden": HIDDEN, **fused_kernel_info(HIDDEN)}), flush=True)
    print(json.dumps({"occupancy": "bilstm_train float32 kernels", "hidden": HIDDEN,
                      **fp32_kernel_info(HIDDEN)}), flush=True)

    checks = check_kernel(device)
    checks += check_kernel(device, **GENERAL_SHAPE)
    train_checks = check_train_kernels(device)
    check_train_kernels(device, **GENERAL_SHAPE)    # the general training pair, H=8
    count_small_launches(device)
    dtw_checks = check_dtw(device)
    with tempfile.TemporaryDirectory() as tmp:
        served = serve(device, Path(tmp))
    steady = served["runs"][-1]
    print(json.dumps({"serving": "generate.main", "n": steady["n"], "batch": SERVE_BATCH,
                      "dtype": "bfloat16", "launches_first_run": served["launches"],
                      "chunks": served["chunks"],
                      "gestures_per_s_first_run": served["runs"][0]["gestures_per_s"],
                      "gestures_per_s": steady["gestures_per_s"],
                      "seconds": steady["seconds"]}), flush=True)
    for family in FAMILIES:
        with tempfile.TemporaryDirectory() as tmp:
            serve_family(device, Path(tmp), family)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train(device, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        trained_fp32 = train(device, Path(tmp), model={"compute_dtype": "float32"})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        graphed = train(device, Path(tmp), scan=True)
    with tempfile.TemporaryDirectory() as tmp:
        graphed_fp32 = train(device, Path(tmp), model={"compute_dtype": "float32"}, scan=True)
    adam_forms(device)
    for kind in ("bfloat16", "float32", "masked"):
        graphed_vs_eager(device, kind)
    eager_determinism(device)
    draw_check = check_threefry(device)
    draws_card_vs_cpu(device)
    activation_check = check_activations(device)
    activation_times = time_activations(device)
    activation_steps = activation_paths_bit_equal(device)
    attention_checks = check_attention(device)
    attention_times = time_attention(device)
    layernorm_checks = check_layernorm(device)
    layernorm_times = time_layernorm(device)
    bias_checks = check_bias(device)
    bias_times = time_bias(device)
    bias_steps = bias_paths_bit_equal(device)
    for kind in ("flagship", "masked"):
        bf16_step_vs_cpu(device, kind)
    precision_flags(device)
    graphed_step = time_graphed_step(device)
    # Per epoch: the graphed run's first epoch and its resumed third (a new
    # train_gan call) each pay one eager warm-up step and the capture; its
    # second epoch is all replays.
    print(json.dumps({"comparison": "ms per flagship step, B=512, eager vs CUDA graph",
                      "bfloat16": {"eager": trained["ms_per_step"],
                                   "graphed": graphed["ms_per_step"]},
                      "float32": {"eager": trained_fp32["ms_per_step"],
                                  "graphed": graphed_fp32["ms_per_step"]}}), flush=True)
    print(json.dumps({"phase": "graphed_training", "seconds": time.perf_counter() - t0}),
          flush=True)
    step_vs_cpu(device)
    with tempfile.TemporaryDirectory() as tmp:
        evaluated = evaluate(device, Path(tmp))
        eager_vl = train_variable(device, Path(tmp))
        graphed_vl = train_variable_scan(device, Path(tmp))
        print(json.dumps({"comparison": "ms per masked step, B=512, eager vs CUDA graph",
                          "eager": eager_vl["ms_per_step"],
                          "graphed": graphed_vl["ms_per_step"]}), flush=True)
        masked_step_vs_cpu(device)
        evaluated_vl = evaluate_variable(device, Path(tmp))
        t0 = time.perf_counter()
        large = evaluate_large(device, Path(tmp))
        print(json.dumps({"phase": "large_scale", "seconds": time.perf_counter() - t0}), flush=True)
        t0 = time.perf_counter()
        large_scale_vs_cpu(device, Path(tmp))
        print(json.dumps({"phase": "large_scale_vs_cpu", "seconds": time.perf_counter() - t0}),
              flush=True)
        t0 = time.perf_counter()
        contrastive(device, Path(tmp))
        contrastive_step_vs_cpu(device)
        print(json.dumps({"phase": "contrastive", "seconds": time.perf_counter() - t0}), flush=True)
        t0 = time.perf_counter()
        dp_cli = train_cli_nccl(device, Path(tmp))
        print(json.dumps({"comparison": "ms per flagship bf16 step, B=512",
                          "single_process_train_gan_phase5": trained["ms_per_step"][-1],
                          "nccl_one_rank_train_cli_phase9a": dp_cli["ms_per_step"],
                          "single_process_graphed_phase5c_replays_only": graphed["ms_per_step"][1],
                          "nccl_one_rank_graphed_phase9a_with_capture": dp_cli["scan"]["ms_per_step"],
                          "nccl_one_rank_graphed_replay_profiled": dp_cli["scan"]["profile"]["wall_ms"]}),
              flush=True)
        data_parallel_vs_single(device, Path(tmp))
        print(json.dumps({"phase": "data_parallel", "seconds": time.perf_counter() - t0}),
              flush=True)
        t0 = time.perf_counter()
        realism_line = realism_report(device, Path(tmp))
        serve_reference_weights(device, Path(tmp))
        print(json.dumps({"phase": "realism_and_reference_weights",
                          "seconds": time.perf_counter() - t0}), flush=True)
        quality = quality_runner(device, Path(tmp))
        print(json.dumps({"phase": "quality_runner", "seconds": quality["seconds"]}), flush=True)
    timings = {name: time_kernel(device, name) for name in ("bfloat16", "float32")}
    for name in ("bfloat16", "float32"):
        time_kernel(device, name, batch=TRAIN_CALL_BATCH)
    pair = {name: time_train_pair(device, name) for name in ("bfloat16", "float32")}
    profile_train_pair(device)
    profile_train_pair(device, "float32")
    profile_train_pair(device, "float32", depths=(LAYERS,), path="general")
    dtw_t = time_dtw(device)
    time_dtw(device, dims=3)    # (x, y, t) gestures: not on the evaluation's path, timed beside it

    main_t, main_p, fp32_p = timings["bfloat16"], pair["bfloat16"], pair["float32"]
    # The launches of the eager and the graphed resumed epochs (phases 5, 5c;
    # 5b, 5d); a replay counts what its capture counted.
    launches = {k: trained["launches"][k] + graphed["launches"][k] for k in PER_STEP}
    launches_fp32 = {k: trained_fp32["launches"][k] + graphed_fp32["launches"][k]
                     for k in PER_STEP}

    def graphed_launches(name: str, fp32: bool = False) -> dict:
        """A kernel's launches in the graphed resumed epochs, by phase."""
        if fp32:
            return {"train_gan_scan_epoch_fp32": graphed_fp32["launches"][name]}
        return {"train_gan_scan_epoch": graphed["launches"][name],
                "train_cli_nccl_scan_epoch": dp_cli["scan"]["launches"][name],
                "quality_runner_train_cli_scan_epoch": sum(
                    quality["train_launches"][name].values())}

    kernels = [{
        "name": "bilstm_fused", "route": "cuda", "path": main_t["path"],
        "launches_by_path": {k: served["launches_by_path"][k] + sum(
            run["launches_by_path"]["bilstm_fused"][k] for run in (trained, trained_fp32, graphed,
                                                          graphed_fp32))
            + evaluated["bilstm_fused_launches_by_path"][k]
            + large["bilstm_fused_launches_by_path"][k]
            + quality["launches_by_path"]["bilstm_fused"][k] for k in served["launches_by_path"]},
        "graphed_launches": {**graphed_launches("bilstm_fused"),
                             **graphed_launches("bilstm_fused", fp32=True)},
        "source": "wordgesture_gan_tpu_torch/csrc/bilstm_fused.cu",
        "replaces": "wordgesture_gan_tpu/ops/bilstm_fused.py:54",
        "launches": served["launches"] + launches["bilstm_fused"] + launches_fp32["bilstm_fused"]
        + evaluated["launches"]["bilstm_fused"] + large["launches"]["bilstm_fused"]
        + quality["launches"]["bilstm_fused"],
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"], "library_ms": main_t["library_ms"],
    }, {
        "name": "bilstm_train_fwd", "route": "cuda", "path": main_p["path"],
        "source": "wordgesture_gan_tpu_torch/csrc/bilstm_train.cu",
        "replaces": "wordgesture_gan_tpu/ops/bilstm_train.py:57",
        "launches": launches["bilstm_train_fwd"] + quality["launches"]["bilstm_train_fwd"],
        "graphed_launches": graphed_launches("bilstm_train_fwd"),
        "max_abs_err": max(c["fwd_max_abs_err"] for c in train_checks),
        "ms": main_p["fwd_ms"], "plain_ms": main_p["plain_fwd_ms"],
        "bound_ms": main_p["fwd_bound_ms"], "bound_by": main_p["fwd_bound_by"],
        "library_ms": main_p["cudnn_fp32_fwd_ms"],
    }, {
        "name": "bilstm_train_bwd", "route": "cuda", "path": main_p["path"],
        "source": "wordgesture_gan_tpu_torch/csrc/bilstm_train.cu",
        "replaces": "wordgesture_gan_tpu/ops/bilstm_train.py:206",
        "launches": launches["bilstm_train_bwd"] + quality["launches"]["bilstm_train_bwd"],
        "graphed_launches": graphed_launches("bilstm_train_bwd"),
        "max_abs_err": max(c["bwd_max_abs_err"] for c in train_checks),
        "ms": main_p["bwd_ms"], "plain_ms": main_p["plain_bwd_ms"],
        "bound_ms": main_p["bwd_bound_ms"], "bound_by": main_p["bwd_bound_by"],
        "library_ms": main_p["cudnn_fp32_bwd_ms"],
    }, {
        # The float32 path (train_gan with compute_dtype float32, phase 5b).
        "name": "bilstm_train_fwd_fp32", "route": "cuda", "path": fp32_p["path"],
        "source": "wordgesture_gan_tpu_torch/csrc/bilstm_train.cu",
        "replaces": "wordgesture_gan_tpu/ops/bilstm_train.py:57",
        "launches": launches_fp32["bilstm_train_fwd"],
        "graphed_launches": graphed_launches("bilstm_train_fwd", fp32=True),
        "max_abs_err": max(c["fwd_max_abs_err"] for c in train_checks
                           if c["dtype"] == "float32"),
        "ms": fp32_p["fwd_ms"], "plain_ms": fp32_p["plain_fwd_ms"],
        "bound_ms": fp32_p["fwd_bound_ms"], "bound_by": fp32_p["fwd_bound_by"],
        "library_ms": fp32_p["cudnn_fp32_fwd_ms"], "general_ms": fp32_p["general_fwd_ms"],
    }, {
        "name": "bilstm_train_bwd_fp32", "route": "cuda", "path": fp32_p["path"],
        "source": "wordgesture_gan_tpu_torch/csrc/bilstm_train.cu",
        "replaces": "wordgesture_gan_tpu/ops/bilstm_train.py:206",
        "launches": launches_fp32["bilstm_train_bwd"],
        "graphed_launches": graphed_launches("bilstm_train_bwd", fp32=True),
        "max_abs_err": max(c["bwd_max_abs_err"] for c in train_checks
                           if c["dtype"] == "float32"),
        "ms": fp32_p["bwd_ms"], "plain_ms": fp32_p["plain_bwd_ms"],
        "bound_ms": fp32_p["bwd_bound_ms"], "bound_by": fp32_p["bwd_bound_by"],
        "library_ms": fp32_p["cudnn_fp32_bwd_ms"], "general_ms": fp32_p["general_bwd_ms"],
    }, {
        # No single PyTorch call computes DTW: the bound is the yardstick.
        "name": "dtw", "route": "cuda",
        "source": "wordgesture_gan_tpu_torch/csrc/dtw.cu",
        "replaces": "wordgesture_gan_tpu/ops/dtw_pallas.py:53",
        "launches": evaluated["launches"]["dtw"] + evaluated_vl["launches"]["dtw"]
        + realism_line["launches"] + quality["launches"]["dtw"],
        "max_abs_err": max(max(c["max_abs_err"] for c in dtw_checks),
                           dtw_t["max_abs_err_all_pairs"]),
        "max_rel_err": max(max(c["max_rel_err"] for c in dtw_checks),
                           dtw_t["max_rel_err_all_pairs"]),
        "ms": dtw_t["ms"], "plain_ms": dtw_t["plain_ms"], "bound_ms": dtw_t["bound_ms"],
        "bound_by": dtw_t["bound_by"], "library_ms": None,
        # The realism report's one call: aligned pairs at L=64, D=2.
        "realism": {k: realism_line[k] for k in ("dtw_pairs", "seq", "dims", "ms", "plain_ms",
                                                 "bound_ms", "bound_by", "kernel_max_rel_err")},
    }, {
        # The JAX package's random draws (no pl.pallas_call: XLA's lowering of
        # jax.random). Timed at a flagship step's draw, 14 keys x 512 x 32
        # normals; the plain version runs on the host; no PyTorch call
        # computes threefry2x32 (torch.randn, another generator, is printed
        # beside it in phase 5h as a yardstick only).
        "name": "threefry_draw", "route": "cuda",
        "source": "wordgesture_gan_tpu_torch/csrc/threefry.cu",
        "replaces": "wordgesture_gan_tpu/train/gan_step.py:135",
        "launches": sum(run["threefry_launches"] for run in (trained, trained_fp32, graphed,
                                                             graphed_fp32)),
        "launches_per_graphed_step": graphed_step["threefry_launches_per_graphed_step"],
        "max_abs_err": max(c["max_abs_err"] for c in draw_check["checks"]),
        "max_ulp": max(c["max_ulp"] for c in draw_check["checks"]),
        "ms": draw_check["timing"]["step"]["ms"],
        "plain_ms": draw_check["timing"]["step"]["plain_host_ms"],
        "bound_ms": draw_check["timing"]["step"]["bound_ms"],
        "bound_by": draw_check["timing"]["step"]["bound_by"], "library_ms": None,
        "ms_5x512x32": draw_check["timing"]["5x512x32"]["ms"],
    }] + [{
        # gelu's two directions and leaky_relu's backward, one pass each (no
        # pl.pallas_call: XLA fuses them into their neighbours); timed at the
        # transformer's critic-loop call in bfloat16; calls a graphed step of
        # the flag and varlen2 recipes; the error: phase 5i's against either
        # plain chain, and phase 5l's largest loss and state differences.
        "name": t["timing"].split()[-1], "route": "cuda",
        "source": "wordgesture_gan_tpu_torch/csrc/activations.cu", "replaces": None,
        "calls_per_graphed_step": {line["recipe"]: line["calls_per_step"].get(
            t["timing"].split()[-1] + "/cuda", 0) for line in activation_steps},
        "max_abs_err": max([activation_check["max_abs_err"][t["timing"].split()[-1]]]
                           + [line[k] for line in activation_steps
                              for k in ("max_abs_loss_diff", "max_abs_state_diff")]),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
    } for t in activation_times if t["route"] == "cuda"] + [{
        # The transformer's attention core, one launch each way (no
        # pl.pallas_call: XLA fuses the JAX package's einsums and softmax);
        # timed at the masked step's calls in bfloat16, beside
        # F.scaled_dot_product_attention (the port never calls it); calls a
        # graphed step of either recipe (phase 5l); the error: phase 5m's
        # largest relative distance from the plain chain on the card.
        "name": "attention_" + t["timing"].split()[-1], "route": "cuda",
        "source": "wordgesture_gan_tpu_torch/csrc/attention.cu", "replaces": None,
        "shape": t["shape"],
        "calls_per_graphed_step": {line["recipe"]: line["attention_calls_per_step"].get(
            "attention_" + t["timing"].split()[-1] + "/cuda", 0) for line in activation_steps},
        "max_rel_l2": max(max(c["rel_l2"].values()) for c in attention_checks),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for t in attention_times] + [{
        # The transformer's layer norm, one launch forward and two backward
        # (no pl.pallas_call: XLA fuses the JAX package's jnp ops); timed at
        # the masked step's calls beside F.layer_norm (the port never calls
        # it); calls a graphed varlen2 step (phase 5l); the error: phase
        # 5n's largest relative distance from the plain chain on the card.
        "name": "layernorm_" + t["timing"].split()[-1], "route": "cuda",
        "source": "wordgesture_gan_tpu_torch/csrc/layernorm.cu", "replaces": None,
        "shape": t["shape"], "dtype": t["dtype"],
        "calls_per_graphed_step": {line["recipe"]: line["layernorm_calls_per_step"].get(
            "layernorm_" + t["timing"].split()[-1] + "/cuda", 0) for line in activation_steps},
        "max_rel_l2": max(max(c["rel_l2"].values()) for c in layernorm_checks
                          if c["dtype"] == t["dtype"]),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for t in layernorm_times] + [{
        # The models' bias adds, a transformer block's residual add folded
        # in, one launch (no pl.pallas_call: XLA fuses the JAX package's
        # adds); timed at the masked step's calls beside the plain chain;
        # calls a graphed step of either recipe (phase 5o); the error: bits
        # that differ from the chain in phase 5o's checks and steps.
        "name": t["timing"], "route": "cuda", "path": t["path"],
        "source": "wordgesture_gan_tpu_torch/csrc/bias.cu", "replaces": None,
        "shape": t["shape"], "dtype": t["dtype"], "layout": t["layout"],
        "calls_per_graphed_step": {line["recipe"]: line["calls_per_step"].get(
            t["timing"] + "/cuda", 0) for line in bias_steps},
        "bits_differ": sum(sum(c["bits_differ"].values()) for c in bias_checks),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
    } for t in bias_times]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
