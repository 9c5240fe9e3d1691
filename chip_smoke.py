#!/usr/bin/env python3
"""Drive the PyTorch port (``mca_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each asserted; any failure exits non-zero):

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
   build every kernel from ``mca_tpu_torch/csrc`` (one ``nvcc`` each, in
   parallel) and print ptxas's registers, spills and wgmma serialisation
   warnings; the SASS (``cuobjdump``) of K1, K5, K2, K3a and K3b must hold
   HGMMA (wgmma) and UTMALDG (TMA) and no HMMA (mma.sync), with no spills
   and no serialisation, and UTMAREDG (TMA reduce-add) in K2 alone; K6's
   fwdpair, bwd5 and big kernels must hold HGMMA and no HMMA, its vpu and
   exp sweeps neither; K7's mxu and both kernels must hold HGMMA and no
   HMMA, its vpu kernel neither, its both and vpu kernels MUFU.EX2 and
   its mxu kernel none, with no spills and no serialisation.
2. K1, the flash-attention forward, against its plain version at
   TCGA_config1 shapes (B 8, H 8, T 2548, D 64, bf16, the real MCA
   mask, ragged key padding and a missing modality): live rows within
   bf16 tolerance, dead rows exactly 0 with lse NEG_INF; a planted fault
   (the plain forward with one partly masked tile dropped) must fail the
   same check.  Times: kernel, plain version, and
   ``F.scaled_dot_product_attention`` with the same mask as a yardstick
   (the port never calls it).
3. K5, the fused GEGLU feed-forward, against its plain version at
   N = 20384, D 512, inner 1365, bf16; a planted fault (the plain FF with
   one 64-wide inner chunk's W2 rows zeroed) must fail the same check.
   Yardsticks: the matmul -> gelu -> matmul chain on the unpadded W1
   (rows of 5460 bytes, not 16-byte aligned) and on the padded halves;
   the faster is ``library_ms``.
4. K2 (fused backward) and K3a + K3b (split backward) against the
   plain backward at K1's shapes and inputs with a random ``do``:
   dq, dk, dv within bf16 tolerance entry by entry and in relative L2
   per gradient, dead-row dq and padded-key dk / dv exactly 0, the two
   routes against each other, K3a's dq bitwise equal over two runs; two
   planted faults (the plain backward with one partly masked tile
   dropped, or the second kv tile of a pair item) must fail the
   relative-L2 check.
   Times: each kernel (queued behind a spin kernel, so that the host's
   enqueueing stays out), the plain backward, and the backward alone of
   ``F.scaled_dot_product_attention`` with the same mask as a yardstick;
   then the same mask at H 4 (a rank's heads at ``mesh_model: 2``) and
   at B 2 (phase 15's pipeline microbatch: rows 2:4 of the batch of 8,
   its key padding copied from that row offset as ``pipeline_layers``
   copies it): K1 as in 2 (its planted fault too), K2, K3a and K3b as
   above, held and timed again.
5. the serving slice: ``EmbeddingService`` at TCGA_config1 width (dim
   512, depth 5, 8 x 64 heads, T 2548, bf16, max_batch 8) on the GPU
   with weights from a fixed seed answers ``embed`` (20 rows, three
   pipelined chunks), ``submit`` from several threads and ``POST
   /embed`` over localhost HTTP; the three agree; K1 and K5 each
   launched 5 times per forward; the embeddings agree with the same
   weights run in fp32 on the CPU through the plain versions.
6. the training slice: the TCGA_config1 model (same widths and depth,
   bf16 compute, fp32 params, seed 0) takes 6 steps on a synthetic
   batch of 8 TCGA-shaped rows through ``mca_tpu_torch.train``, first
   with the fused backward (the main path: K1 and K2 5 times per step,
   K5 never), then with the split one (K3a and K3b 5 times per step);
   finite metrics, per-step losses of the two agree; from the same
   weights, the first step's q / kv-projection gradients of the two
   routes agree leaf by leaf (and a planted dq error fails that check),
   and the first step's loss, whole gradient and attention-projection
   gradients agree with fp32 on the CPU.  Prints the host, the ms of
   each step and training tokens/s.
7. the measurement slice: K6 (roofline counter, read twice and both
   readings printed; the first goes to the kernels line), K7 (overlap probe, on
   wgmma, its exp steps between the issues of its products) and K8 (its
   control) against their plain versions, mode by mode, every
   block's output after a few iterations from seeded inputs under which
   every product moves the chain, within bf16 tolerance (fp32 for the
   fp32 chains); planted faults must fail that check: each mode's plain
   chain one iteration (K7: one step of each chain, K8: one step) short,
   and the plain ``bwd5`` without dq, dv or dk.  Times of each mode,
   kernel and plain (K7's short launches queued behind a spin kernel, so
   that the device alone is timed), and its bound.  Then the tools' main
   path, with the launch counts at 0 just before it:
   ``tools.roofline.measure_rates``'s short pass (every rate above 0 and
   within 105% of its published ceiling, each with the SM clock) and
   ``tools.probe_overlap.run`` at a short length (both verdicts printed;
   the control must read OVERLAPS, or the instrument cannot see
   overlap).
8. the training run: ``mca_tpu_torch.train.train`` at TCGA_config1
   width and depth (``num_warmup_steps`` 2) on 40 synthetic TCGA-shaped
   rows (p_missing 0.25) held in memory, ``split`` 0.2, so 4 train
   batches and 1 eval batch an epoch, into a temporary directory.
   (a) The main path, launch counts at 0 just before it: 2 epochs,
   ``n_step_checkpoint`` 2, ``checkpoint_keep`` 1, the eval pass, fused
   backward: 8 finite step records with ``tokens_per_sec`` and
   ``epoch``, finite ``val_epoch_*`` records after each epoch, K1 5
   times per step and per eval forward, K2 5 per step; ``1/`` kept,
   ``0/`` pruned, ``model/`` and ``model.safetensors`` (read back equal
   to the final parameters); the first eval's ``val_epoch_total_loss``
   against the same eval in fp32 on the CPU from the epoch-0 weights.
   (b) Restart, on the split (deterministic) backward with
   ``torch.use_deterministic_algorithms``: 2 epochs straight against
   epoch 0 then ``restart:`` from ``0/``, and against a SIGTERM at step
   2 then ``restart:`` from the root checkpoint (mid-epoch resume); the
   final parameters equal bit for bit.  (c) ``remat`` + ``grad_accum``
   2 + ``moment_dtype: bf16`` for one epoch: finite records, K1 20 and
   K2 10 times per step, bf16 moments in the checkpoint; from the same
   weights and batch, a ``remat`` step's gradients against a plain
   step's.  (d) Prints ms per step, per eval pass and per checkpoint
   save (synchronous and asynchronous), peak memory with and without
   ``remat`` and the optimizer state's bytes, fp32 and bf16 moments.
9. the evaluation path, on phase 8's rows and run directory. (a) The
   main path, launch counts at 0 just before it: ``infer`` from phase
   8's final ``model/``: 4 train batches and 1 eval batch, K1 and K5 5
   times a batch and no backward kernel; six files with 4 + 11 + 1
   embedding keys (str, frozenset, ``fusion``), 32 and 8 rows, the rows'
   own labels; the eval split against the same weights in fp32 on the
   CPU (relative L2 per key); ``infer`` from ``1/`` (a train state)
   bitwise equal. (b) ``infer`` for MMA/Zorro (``tcga_mma_d40.yaml``,
   ``predrop``) and EAO (``tcga_eao.yaml``: ten unmasked passes, T 198
   to 1600) at full width, weights from seed 0: K1 and K5 25 and 250
   times, the eval split against fp32 on the CPU; K1 and K5 against
   their plain versions at every shape the family's infer gives them:
   K1 under the Zorro mask at MMA's T 2548 and unmasked at each of
   EAO's seven pass lengths (198, 662, 800, 860, 998, 1462, 1600),
   with ragged key padding and a sample without the modality, and K5
   on 8 x T rows of each; a planted fault (a dropped tile, a zeroed
   W2 chunk) must fail each check. (c)
   ``probe`` on (a)'s files with ``tcga_probe.yaml``'s settings (BCE,
   linear, 1024 epochs): the host and device loops agree on a full
   batch (losses and norms within 2e-4 relative, the rank metrics within
   one pair's or one prediction's share of the split, the last epoch's
   train rows, matched by their logits, carry the same labels and logits
   within 2e-4; a planted fault, the device loop's labels rolled by one
   row, must fail that), the card's host loop agrees with the CPU's
   every epoch; EAO's
   files probed on ``combo:0,1`` give finite metrics. (d) Prints wall
   and device ms per ``infer`` batch and rows/s for each family, ms to
   write a split's files, and probe ms per epoch for each loop.
10. CMU_config1 (``configs/cmu_mca.yaml``: four EmbeddedSequence
   modalities, COVAREP 1500 x 74, FACET 450 x 35, OpenFace 450 x 713,
   glove_vectors 50 x 300, 88 fusion tokens, T 2538) at full width and
   depth, on ``make_cmu_like`` rows (p_missing 0.25, seed 0). (a) K1, K2,
   K3a and K3b against their plain versions under the CMU mask (segment
   boundaries inside tiles, ragged key padding, a sample missing a
   modality), K3a's dq bitwise equal over two runs, K5 on 8 x 2538 rows;
   phase 2-4's tolerances and planted faults (a dropped partial tile, the
   second kv tile of a pair item, a zeroed W2 chunk). (b) Serving, as
   phase 5, on 20 CMU rows: ``embed`` / ``submit`` / HTTP agree, K1 and
   K5 5 a forward, bf16 GPU vs fp32 CPU. (c) Training, as phase 6 (its
   gates and exact launches) at depth 2 (since PR 16, for the script's
   time), and one step staged at bf16 beside one at fp32 (``total_loss``
   and bytes copied). (d) ``infer`` over 40 rows
   from the seed-0 weights: 4 train and 1 eval batch, K1 and K5 25 each,
   no backward; six files, 16 keys, the 7 float labels, the eval split
   against fp32 on the CPU. (e) Prints host ms to collate a batch,
   host-to-device ms and bytes at fp32 and bf16 staging, and a fused step's
   wall ms against the device's busy ms under the profiler; then, each
   pair of arms in turns: the C++ collate (``mca_tpu_torch.native``)
   against its numpy plain versions, the batches bitwise equal; the
   pageable blocking copy (``train.to_device``) against a pinned
   non-blocking one, with and without the pinning; a fused step's wall
   over an epoch of 40 rows with ``prefetch_batches`` 0 and 1.
11. the EAO training step (``configs/tcga_eao.yaml`` at full width: ten
   unmasked passes a block, T 800, 198, 800, 662, 998, 1600, 1462, 998,
   860, 1462). (a) K2, K3a and K3b against the plain backward at each of
   the seven lengths, unmasked, ragged key padding (sample 0 at full
   length) and a sample without the modality; planted faults: a dropped
   tile, a pair item's second kv tile and, at an odd tile count, a tile of
   the lone last kv pair and of the lone last q pair; K3a's dq bitwise
   equal over two runs at T 1600. (b) Phase 6 on the EAO model at depth
   2 (since PR 16, for the script's time): 6 steps on each backward, K1
   20 and K2 20 (or K3a 20 + K3b 20) a step, the first-step gates
   against fp32 on the CPU, fused against split; a full-depth step's
   wall and device ms.
12. the MoE family: TCGA_config1 at full width and depth with
   ``moe_experts: 2``, ``moe_capacity_factor: 2.0`` (C = T = 2548) set in
   code. (a) Serving, as phase 5: ``embed`` / ``submit`` / HTTP agree, K1
   5 a forward and K5 never, a row alone equals the row inside a batch,
   bf16 GPU vs fp32 CPU. (b) Training, as phase 6 with 3 steps a
   backward (K1 5 + K2 5, or K3a 5 + K3b 5, a step; the first-step gates;
   the router and expert gradients gated leaf by leaf beside the attention
   leaves, against a planted fault, and read again with the MoE computing
   in fp32 on the card). (c) The module alone at 4 experts, capacity
   factor 1.0 (C = 637, tokens dropped) on x [8, 2548, 512] with ragged
   padding: bf16 against fp32 on the card where both chose the same
   experts for a token (the choices that flipped are counted), and the
   port's gather / scatter-add against the one-hot dispatch and combine
   products of ``onehot_forward``, its plain reference. (d) Wall and
   device ms a fused step and the peak memory for the port's MoE, the
   one-hot reference and the dense model, in turns, beside the card and
   the host. (e) ``tools.moe_stats`` from (b)'s weights on 40 rows: K1 5
   launches, one row a layer, every real token covered, each layer's
   expert probability mass summing to 1.
13. int8 serving and the exported serving forward at TCGA_config1 width
   and depth, from the seed-0 weights with each block projection's output
   channels scaled by factors drawn log-uniform in [1/2, 2] (so that the
   per-channel int8 scales differ, as a trained model's do). (a)
   ``EmbeddingService(quantize="int8")`` as phase 5: ``embed`` /
   ``submit`` / HTTP agree, K1 5 a forward and K5 never (the int8
   feed-forward is unfused, as in the JAX package), bf16 GPU against the
   same int8 weights (bitwise equal on both sides) in fp32 on the CPU;
   cosine to the fp32-weight service above 0.98 for every live row and
   key; ``int8_matmul`` on the card bitwise equal to the CPU at the five
   projections' shapes; a planted fault (block 0's ``to_q`` scales
   reversed on the CPU) must fail the CPU gate. (b)
   ``tools.export_aot``: the fp and the int8 forwards exported at batch
   8 on the card, saved, and served through
   ``EmbeddingService.from_aot``: embeddings against the eager service's
   (bound 1e-3), K1 5 + K5 5 (fp) and K1 5 + K5 0 (int8) launches for one
   forward of the loaded program; a fresh process that imports only the
   service serves a row from the fp artifact (K1 and K5 5 each, no
   model, config, encoder or mask module imported); the artifacts' and
   the int8 projections' bytes; phase 12's MoE model exported on the card
   and served through ``serve --aot`` (the CLI's service from its
   artifact), against its eager service, K1 5 and K5 0 a forward. (c)
   ms per batch-8 forward (CUDA events) for eager fp, eager int8, loaded
   fp and loaded int8, beside the card's name and power limit.
14. data and tensor parallelism (``mca_tpu_torch.parallel``) at
   TCGA_config1 width and depth, 3 steps (warm-up 2) on a batch of 8
   from the seed-0 weights. (a) Through ``init_multihost`` with a
   one-rank NCCL group (``MCA_MULTIHOST=auto``), ``mesh_data: 0``,
   ``fsdp: true``, on the split backward with deterministic algorithms:
   bitwise equal to the same steps without a process group, K1 + K3a +
   K3b 5 each a step; its checkpoint served (``EmbeddingService``
   ``restart=``) for one batch, K1 and K5 5. (b) Two ranks on the one card
   over gloo (NCCL refuses two ranks on one device), started by
   ``mca_tpu_torch.parallel.launch`` with a hard timeout: (i) ``mesh_data:
   2, fsdp: true``, (ii) ``mesh_data: 2`` without fsdp, (iii)
   ``mesh_model: 2, seq_shard: true``; on each rank K1 5 and K2 5 a
   step, at H 4 under (iii) (from the heads of every launch); per-step
   total_loss, grad_norm and param_norm and the final parameters'
   update held to the unsharded steps on the card (fused backward);
   planted faults must fail their gate: on (i) the loss gather with
   ``BackpropType.NONE`` (the update) and the gradient summed, not
   averaged, over ``data`` (grad_norm), on (iii) rank 1 keeping its own
   partial of block 0's ``to_out`` (the update). Each rank's peak
   device memory and optimizer state, with and without fsdp; after the
   runs, which collectives gloo accepts on CUDA tensors (and FSDP2's
   ``fully_shard`` on one ``nn.Linear``). (c) ``python -m mca_tpu_torch.infer``'s ``main`` at 2 ranks
   against 1 from (a)'s checkpoint on 40 rows: keys, row order, masks and
   labels equal, embeddings within ``AGREE_ATOL``. Prints wall ms a step
   for (a) and (b) beside the host and the card: two processes sharing
   one card through host-staged gloo, not a scaling number.
15. GPipe and expert parallelism (``mca_tpu_torch.parallel.pipeline``,
   ``models/moe.py``), two ranks on the one card over gloo as in phase 14
   (b), 3 steps (warm-up 2) on a batch of 8 from the seed-0 weights, each
   layout held to the same model's unsharded steps on the card (fused
   backward) with phase 14's gates, and each planted fault past the bound
   of each of its gates. (a) ``mesh_pipe: 2``, ``pipeline_microbatches:
   4`` at TCGA_config1's width cut to depth 4 (5 does not divide by 2):
   K1 and K2 exactly (L / S) x M = 8 a step on each rank at H 8; faults:
   stage 1 one microbatch late (loss and update), the final-norm, pool and
   logit-scale gradients summed over ``pipe`` (grad_norm). (b)
   ``mesh_model: 2`` with phase 12's MoE (2 experts, capacity factor 2.0,
   one expert a rank) at full depth, with and without ``seq_shard``: K1
   and K2 5 a step on each rank at H 4; each expert leaf's and router
   leaf's update gated too; faults: every rank computing rank 0's expert
   (update and expert leaves), the router's gradient not summed over
   ``model`` (router leaves). (c) Each layout's wall ms a step and peak
   MiB a rank beside the card's name and power limit; which collectives
   gloo takes on CUDA tensors, and ``send`` / ``recv`` and
   ``batch_isend_irecv`` on CUDA tensors, each in two processes of its
   own (a reading, not a gate).
16. ZeRO-3 and the memory tools at TCGA_config1 width and depth (bf16,
   batch 8). (a) Two ranks on the one card over gloo as in phase 14 (b),
   3 steps (warm-up 2) from the seed-0 weights: ``mesh_data: 2, fsdp:
   true`` (ZeRO-3), the same with ``grad_accum: 2``, and PR 14's
   optimizer-state-only layout rebuilt on ``mesh_data: 2``
   (``moments_only``), each held to the unsharded steps with phase 14's
   gates; K1 and K2 5 a step (a microbatch) on each rank; after the steps
   each ZeRO-3 rank's resident bytes (what deleting its trainer frees)
   equal ``plan_parallel``'s state bytes for the layout but for the
   allocator's rounding, and its peak below ``moments_only``'s; planted
   faults past their gates: the slices gathered in reverse rank order
   (update), every gathered group's weights kept (resident bytes), the
   gradient reduce-scattered without the 1 / data (grad_norm). Every
   layout of phases 14, 15 and ``--parallel-cards`` takes the resident
   gate too. (b) ``tools.memory_report.step_memory`` on one process:
   ``grad_accum: 4``'s temp below 0.6 x the base's with equal
   ``argument_size_in_bytes``, ``remat``'s temp below the base's; every
   field printed, and from ``PROFILED_STEPS`` steps plain and under
   ``remat`` (``profiled_steps``) the remat step's device and wall time
   over the plain step's and the plain step's model FLOPs utilisation:
   ``plan_parallel``'s two measured figures. (c) ``python -m
   mca_tpu_torch.tools.plan_parallel --devices 2 --exact --json`` in a
   process of its own, as a user runs it (its activation model read
   there at the fewest rows a plan gives a microbatch, 1, and at (b)'s
   batch of 8, with what ``grad_accum: 2`` over one row adds): each top
   plan without a pipe
   measured on its own ranks, each rank's resident bytes equal to the
   plan's state bytes as in (a), and its measured peak at most the
   predicted one, which is at most 1.25 x the measured; the accumulation
   reading printed fresh and in this process. (d) ``trace_dir``:
   a 3-step ``train`` writes the second step's ``torch.profiler`` trace,
   in which K1's and K2's kernels each run 5 times.
17. ``attention_impl: segmented`` and the last tools, at full width. (a)
   The segmented serving forward at TCGA_config1 (batch 8, seed-0
   weights): K1 once a segment a block (4 x 5 = 20) and K5 5, the
   embeddings against the monolithic K1 forward on the same weights and
   against fp32 on the CPU; ms a forward, segmented and monolithic. (b)
   The segmented training step, 3 steps on each backward: K1 and K2 20
   a step (or K3a 20 + K3b 20); the first step's loss, gradient and
   attention leaves against the monolithic step from the same weights
   with phase 6's bounds, split against fused; wall and device ms a
   step, segmented and monolithic. (c) K1, K2, K3a and K3b against their
   plain versions unmasked at CMU_config1's segment lengths (1500, 450
   and 50, the last under one tile), each with its planted faults; the
   segmented CMU_config1 forward against the monolithic one. (d)
   ``tools.attention_maps`` on two rows: every row sums to 1, blocked
   entries of rows with a live key exactly 0, layer 0 against fp32 on
   the CPU. (e) ``tools.import_checkpoint --with-optimizer`` from an
   Accelerate directory written from a trainer's state after 2 steps:
   one step restarted from the import equals one step continued, bit
   for bit, on the split backward with deterministic algorithms. (f) One
   ``tools.sweep`` cell at TCGA_config1 scale and a small
   ``tools.reproduce`` pipeline, each on rows held in memory: finite
   probe metrics and every file each stage writes.
18. one ``{"kernels": [...]}`` line (eight kernels; launches from phases
   2-7, phase 9's MCA, MMA and EAO infer runs, phase 10's serving,
   training and infer, phase 11's training, phase 12's serving,
   training and ``moe_stats``, phase 13's serving and loaded programs,
   phase 14's steps, serving and infer ranks, phase 15's ranks, phase
   16's ranks, ``memory_report`` step and traced run, and phase 17's
   segmented forwards and steps and restarted step, each counted from 0),
   then the last line ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM's published peaks (989 TFLOP/s dense bf16,
67 TFLOP/s fp32, i.e. 33.5 T fp32 instructions/s, 16 MUFU operations a
clock per SM on 132 SMs at 1980 MHz, 3.35 TB/s HBM3); the card's power
limit is printed beside them.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from unittest import mock
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import yaml

import mca_tpu_torch
from mca_tpu_torch import _build
from mca_tpu_torch import infer as infer_lib
from mca_tpu_torch import native
from mca_tpu_torch import probe as probe_lib
from mca_tpu_torch.checkpoint import (Checkpointer, load_params, load_state, read_safetensors,
                                      save_params)
from mca_tpu_torch.config import (embedding_eval_config, get_model_config, load_yaml,
                                   training_config)
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.dataset import BatchedLoader, setup_data
from mca_tpu_torch.masks import adjusted_powerset, build_masks
from mca_tpu_torch.metrics import binary_metrics
from mca_tpu_torch.models import build_model
from mca_tpu_torch.models.mca import init_weights
from mca_tpu_torch.models import moe
from mca_tpu_torch.models.moe import MoEFeedForward, expert_capacity
from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.ops import fused_ff as ff
from mca_tpu_torch.ops import probes
from mca_tpu_torch.ops import quant
from mca_tpu_torch.parallel import collectives as coll
from mca_tpu_torch.parallel import launch as launch_lib
from mca_tpu_torch.parallel import pipeline
from mca_tpu_torch.parallel.sharding import FSDP_MIN_SIZE
from mca_tpu_torch.parallel.multihost import init_multihost, make_stager
from mca_tpu_torch.serve import EmbeddingService, make_server, parse_args, service_from_args
from mca_tpu_torch.tools import (host_batch_costs, host_description, host_probe_ms,
                                 median_host_ms, request_rows, sample_tokens)
from mca_tpu_torch.tools import probe_overlap as overlap_tool
from mca_tpu_torch.tools import roofline as roofline_tool
from mca_tpu_torch.tools import export_aot
from mca_tpu_torch.tools import sass_counts
from mca_tpu_torch.tools import memory_report
from mca_tpu_torch.tools import plan_parallel as plan_tool
from mca_tpu_torch.tools.moe_stats import extract_moe_stats
from mca_tpu_torch.tools import attention_maps
from mca_tpu_torch.tools import import_checkpoint as import_tool
from mca_tpu_torch.tools import reproduce as reproduce_tool
from mca_tpu_torch.tools import sweep as sweep_tool
from mca_tpu_torch import interop
from mca_tpu_torch.ops import segmented_attention as segmented
from mca_tpu_torch.train import (
    PreemptedError,
    build_trainer,
    forward_backward,
    load_train_state,
    narrow_for_staging,
    run_eval_epoch,
    staging_sentinels,
    synthetic_rows,
    to_device,
    train,
    train_step,
    training_mesh,
)

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "tcga_mca.yaml"
PEAK_BF16 = 989e12  # FLOP/s, dense
PEAK_BYTES = 3.35e12  # bytes/s
# bf16 results: two units in the last place relative, plus an absolute
# floor for values near zero where the operands' own rounding dominates
BF16_RTOL = 2.0**-6
FLASH_ATOL = 4e-3  # p is rounded to bf16 against different running maxima
FF_ATOL = 1e-3
# backward: kernel and plain version round p and ds to bf16 before the
# products that take them, but from fp32 values computed in another
# order (exp2 against exp, other running sums), so a few of those
# roundings land one unit (2^-8) apart; K2 also adds dq's fp32
# partials in an atomic order that changes from run to run; the
# gradients sum hundreds of such terms, so the gap is bounded by a
# fraction of the gradient's own largest entry: 1% of max |plain|, on
# top of BF16_RTOL
BWD_ATOL = 1e-2
# the same, over a whole gradient: relative L2 of kernel against plain.
# The few one-unit roundings apart give ~1.2e-4 (measured on an H100,
# fused and split alike); one partly masked 64 x 64 tile dropped from
# the plain backward (the tile with the median live count), the planted
# fault, gives ~2.9e-2, and must exceed the bound, as must the second
# planted fault, the second kv tile of a pair item dropped (2.9-3.0e-2,
# measured on an H100); 2e-3 sits ~15x from each, and also catches a
# dropped tile with 1-3% of that live count (6-7e-3 at these shapes)
BWD_REL_L2 = 2e-3
# a softmax scale whose bf16 is not a power of two: K2 and K3b then read
# q_s = bf16(q * bf16(scale)) from the wrapper instead of scaling in fp32
SCALE_NOT_POW2 = 0.1
TP_HEADS = 4  # heads a rank holds at mesh_model 2 (8 / 2)
# the rows of the batch of 8 that phase 15's pipe (4 microbatches) gives
# K1 and K2 at once: microbatch 1, whose [2, T] key padding starts 8
# bytes off 16-byte alignment in the batch's [8, T] bools
MICRO_ROWS = slice(2, 4)
# modality widths that give an odd number of 64-key tiles (T 160 with 22
# fusion tokens, two for each of the 11 modality combinations)
ODD_DIMS = (48, 30, 40, 20)
# embeddings, bf16 on the GPU vs fp32 on the CPU: relative L2 gap per key
# (bf16 rounds each activation to 8 significant bits, ~2e-3 relative;
# the final fp32 norm and pool average much of it out)
SLICE_REL_L2 = 1e-2
COS_MIN = 0.98  # int8 against fp weights: the JAX package's pin (tests/test_quant.py)
AGREE_ATOL = 1e-3  # embed vs submit vs HTTP: same kernels, batch-mates differ
TRAIN_STEPS = 6
TRAIN_WARMUP = 2  # lr is 0 at step 0 (as in the JAX schedule), then rises
# fused vs split backward, per-step total_loss: the two routes compute
# the same bf16 products and differ only in the order of dq's fp32 sums
# (step 0 agrees exactly), but one bf16 unit of dq moves near-zero
# gradient entries across 0, AdamW's early updates are about lr in size
# whatever the gradient's size, and the loss falls fourfold in these 6
# steps: the trajectories part by up to ~1% (measured 8.9e-3 at step 5
# on an H100), so 3e-2 relative.  AdamW's normalised updates also hide
# a dq that is off by a few percent here; the first-step gradient check
# (TRAIN_ROUTE_GRAD_REL_L2) is the one that tells the routes apart
TRAIN_SPLIT_RTOL = 3e-2
# first step, bf16 on the GPU vs fp32 on the CPU: the loss is an average
# of log-softmax terms of O(1) logits, which bf16 activations (8
# significant bits) move by well under 1%; the gradient carries the
# bf16 rounding of every activation and product through 5 blocks and the
# backward, so its relative L2 gap is a few percent at most
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
# leaf by leaf for the attention projections (to_q, to_kv, to_out of
# every block), which the flash backward feeds, so that a fault there
# cannot hide under the larger leaves of the flat vector: each leaf
# carries about the flat vector's gap (measured 8.0e-3 to 1.0e-2 on an
# H100), so 2e-2; the planted dq fault below must exceed it too
TRAIN_ATTN_GRAD_REL_L2 = 2e-2
# fused against split backward from the same weights, q / kv-projection
# gradients leaf by leaf: the routes differ only in the order of dq's
# fp32 sums, which moves a few bf16 roundings (measured at most 1.6e-3,
# in the first block, on an H100); dq wrong by a factor (1 + e) moves
# every block's to_q gradient by about e, so the planted fault (K3a's
# dq scaled by PLANTED_DQ_SCALE, measured 5.0e-2) must exceed the bound
TRAIN_ROUTE_GRAD_REL_L2 = 1e-2
PLANTED_DQ_SCALE = 1.05
# the MoE's leaves, bf16 on the GPU vs fp32 on the CPU, leaf by leaf
# (phase 12 (b)): each expert matrix carries about the flat vector's gap
# (measured 8.9e-3 to 1.07e-2 on an H100), so 2e-2 as for the attention
# projections; the router's gradient sums x * d(logits) over the batch's
# tokens, where d(logits) = s1 * s2 * (g1 - g2) is a difference of the
# two experts' gate gradients (measured 7.8e-3 to 2.37e-2, the last block
# highest), so 5e-2.  Each leaf's gradient scaled by PLANTED_MOE_SCALE
# on its way to the optimiser (a planted fault, ~1e-1) must exceed its bound
TRAIN_EXPERT_GRAD_REL_L2 = 2e-2
TRAIN_ROUTER_GRAD_REL_L2 = 5e-2
PLANTED_MOE_SCALE = 1.1
# phase 8: 40 rows, 8 of them the eval split, so 4 train batches and 1
# eval batch of 8 an epoch
RUN_ROWS = 40
RUN_SPLIT = 0.2
# the first eval's val_epoch_total_loss, bf16 on the GPU against fp32 on
# the CPU from the same weights: an average of pair losses, as phase 6's
# first-step loss (TRAIN_LOSS_RTOL)
RUN_EVAL_RTOL = 1e-2
# phase 9: the families it runs infer for, at full width, with weights
# from seed 0; K1 and K5 are held against their plain versions at every
# shape each family's infer gives them (family_shapes)
EVAL_CONFIGS = {"mma": ROOT / "configs" / "tcga_mma_d40.yaml",
                "eao": ROOT / "configs" / "tcga_eao.yaml"}
# phases 10 and 11: CMU_config1 (serving, training, infer) and EAO training
CMU_CONFIG = ROOT / "configs" / "cmu_mca.yaml"
EAO_CONFIG = ROOT / "configs" / "tcga_eao.yaml"
# phases 10 (c) and 11 (b): the training check's depth (the fp32 CPU step
# costs most of their time; the serving, infer and profiled steps keep 5)
CHECK_DEPTH = 2
PROFILED_STEPS = 3
TOP_KERNELS = 6
# phase 12: TCGA_config1 with the MoE feed-forward at the JAX package's
# default capacity factor (C = T = 2548: every token reaches both
# experts), 3 steps on each backward; (c) holds the module alone where
# tokens are dropped (4 experts, capacity factor 1.0, C = 637)
MOE_EXPERTS = 2
MOE_CF = 2.0
MOE_STEPS = 3
ROUTING_EXPERTS = 4
ROUTING_CF = 1.0
# (c) outputs, bf16 against fp32 on the tokens both runs route alike:
# relative L2.  bf16 rounds x, the weights, the experts' hidden, gated
# and output activations, the gates and the weighted outputs to 8
# significant bits (~1e-3 RMS each); ten such roundings gave ~6e-3
# through the plain PyTorch products on a CPU, so 2e-2; a token routed
# to a wrong expert, or a wrong gate, moves its row by O(1)
MOE_REL_L2 = 2e-2
# (c) the port's gather / scatter-add against the one-hot reference, both
# bf16 from the same choices: they differ only where a token's weighted
# outputs are summed (the one-hot combine sums in fp32 inside its
# product and rounds once, index_add rounds each add to bf16; measured
# 5.3e-4 on an H100), so 2e-3; one expert's gates scaled by 1 + 2^-6
# (the planted combine fault) moves the output by ~8e-3 and must exceed it
MOE_ARM_REL_L2 = 2e-3
PLANTED_GATE_SCALE = 1 + 2**-6
# (e) moe_stats: the router's probabilities sum to 1 over the experts
MOE_MASS_ATOL = 1e-4
PROBE_CONFIG = ROOT / "configs" / "tcga_probe.yaml"
# phase 14: 3 steps of TCGA_config1 at full width and depth on each layout,
# two ranks on the one card over gloo; a fault planted on each layout
PAR_STEPS = 3
PAR_LAYOUTS = {"dp_fsdp": {"mesh_data": 2, "fsdp": True},
               "dp": {"mesh_data": 2},
               "tp_seq": {"mesh_model": 2, "seq_shard": True}}
PAR_FAULTS = {"dp_fsdp": ["none_gather", "unscaled_grads"], "dp": [],
              "tp_seq": ["skip_out_reduce"]}
PAR_TIMEOUT = 600  # seconds for the two ranks of one launch
# sharded against unsharded on the card, both bf16 on the fused backward:
# per-step total_loss, grad_norm and param_norm (relative), and the
# relative L2 of the final parameters' update (final - initial) against
# the unsharded update; set from a CPU rehearsal at tiny shapes in bf16
# (loss 1.2e-4, grad_norm 1.8e-4, param_norm 2e-7, update 1.2e-2 and
# 3.0e-2; the planted faults' updates 1.0 and 0.68, the summed gradient's
# grad_norm 1.0 with its update at 1.2e-2)
PAR_LOSS_RTOL = 2e-3
PAR_NORM_RTOL = 1e-2
PAR_UPDATE_REL_L2 = 0.15
# each MoE expert leaf's and router leaf's update (relative L2 against the
# unsharded update), phase 14's update bound; a CPU rehearsal at tiny
# shapes in bf16 read experts 4.3e-2 and router 7.7e-3 at model 2, 6.9e-2
# and 7.6e-2 at data 2 x model 2 with 4 experts, and the planted faults
# 0.58 (experts) and 0.84 (router)
PAR_LEAF_UPDATE_REL_L2 = 0.15
PAR_BOUNDS = {"loss": PAR_LOSS_RTOL, "grad_norm": PAR_NORM_RTOL, "param_norm": PAR_NORM_RTOL,
              "update": PAR_UPDATE_REL_L2, "experts": PAR_LEAF_UPDATE_REL_L2,
              "router": PAR_LEAF_UPDATE_REL_L2,
              # bytes a rank holds beyond the plan's state and the allocator's rounding
              "resident": 0}
# the gate each planted fault must fail: a gradient summed, not averaged,
# over data scales every gradient alike, which AdamW's update and the
# clipped step do not see, so only grad_norm shows it
FAULT_GATES = {"none_gather": ("update",), "skip_out_reduce": ("update",),
               "unscaled_grads": ("grad_norm",),
               # phase 15: stage 1 one microbatch late; the pool, final-norm and
               # logit-scale gradients summed over pipe (S times too large, which
               # AdamW does not see); every rank computing model rank 0's experts;
               # the router's gradient left partial over model
               "late_stage": ("loss", "update"), "summed_replicated": ("grad_norm",),
               "first_experts": ("update", "experts"), "router_not_summed": ("router",),
               # phase 16: the gathered slices in reverse rank order; every
               # gathered group's whole weights kept after its backward; the
               # whole gradient reduce-scattered without the 1 / data
               "reversed_gather": ("update",), "kept_wholes": ("resident",),
               "unscaled_scatter": ("grad_norm",)}
# phase 15: GPipe over two stages (TCGA_config1 cut to depth 4: 5 does not
# divide by 2) and expert parallelism over two model ranks (phase 12's MoE,
# full depth), two ranks on the one card over gloo
PIPE_EP_LAYOUTS = {
    "pipe": {"layers": 4, "mesh_pipe": 2, "pipeline_microbatches": 4},
    "ep": {"moe_experts": MOE_EXPERTS, "moe_capacity_factor": MOE_CF, "mesh_model": 2},
    "ep_seq": {"moe_experts": MOE_EXPERTS, "moe_capacity_factor": MOE_CF, "mesh_model": 2,
               "seq_shard": True},
}
PIPE_EP_FAULTS = {"pipe": ["late_stage", "summed_replicated"],
                  "ep": ["first_experts", "router_not_summed"], "ep_seq": []}
# the keys of a layout that change the model or its step (and so its
# reference steps)
MODEL_KEYS = ("layers", "moe_experts", "moe_capacity_factor", "grad_accum")
# each rank's resident bytes (what deleting its trainer frees, counted in
# the bytes its tensors asked the caching allocator for) against
# plan_parallel's state bytes for the layout: at most ALLOC_ROUND bytes a
# tensor apart (the allocator's small-block rounding; the bytes asked for
# carry none), and nothing else.  memory_allocated itself may add up to
# 1 MiB a large tensor, where a tensor takes a cached block whole.
ALLOC_ROUND = 512
# phase 16: ZeRO-3 (fsdp) at TCGA_config1, two ranks on the one card over
# gloo, held to the unsharded steps with phase 14's gates; the optimizer-
# state-only layout of PR 14 (moments_only) runs beside it for its peak
ZERO3_LAYOUTS = {"zero3": {"mesh_data": 2, "fsdp": True},
                 "zero3_accum": {"mesh_data": 2, "fsdp": True, "grad_accum": 2},
                 "moments_only": {"mesh_data": 2}}
ZERO3_FAULTS = {"zero3": ["reversed_gather", "kept_wholes", "unscaled_scatter"],
                "zero3_accum": [], "moments_only": []}
# a layout run with a plant of its own (not a fault): held to the unsharded
# steps, not to the plan's resident bytes
ZERO3_PLANTS = {"moments_only": "moments_only"}
# memory_report's grad_accum claim (the JAX package's tests/test_memory_report.py)
MEMREPORT_ACCUM = 4
ACCUM_TEMP_SHARE = 0.6
# plan_parallel --devices 2 --exact: the top plans measured
PLAN_DEVICES = 2
PLAN_TOPK = 1
PLAN_TIMEOUT = 600  # seconds for the tool's process, its ranks included
PLAN_READING_JOBS = 6  # its six readings at once, each in a process of its own
# trace_dir: a run of this many steps traces its second
TRACE_STEPS = 3
TRACE_KERNELS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd": "flash_bwd_kv_kernel<true>"}
# phase 16 (c): every plan measured lies under its predicted peak, and
# the prediction within this factor of the measurement
PLAN_PEAK_OVER = 1.25
PAR_INFER_ROWS = 40
# phase 17: attention_impl segmented; CMU_config1's segment lengths at
# which K1 and K2 run unmasked (glove's 50 under one tile)
SEG_LENGTHS = (1500, 450, 50)
SEG_STEPS = 3
# attention_maps at full width on two rows of a split of four
MAPS_ROWS, MAPS_SPLIT, MAPS_BATCH = 4, 0.5, 2
MAPS_SUM_ATOL = 1e-5
# layer 0's probabilities, bf16 on the card against fp32 on the CPU
# (relative L2): q and k round to bf16 before the scores, which moves a
# score by ~2^-9 of its terms and its softmax entry by about as much
MAPS_REL_L2 = 2e-2
# import_checkpoint --with-optimizer: a trainer's state after this many
# steps, of a run this long, written as an Accelerate directory
IMPORT_STEPS, IMPORT_HORIZON = 2, 10
# one sweep cell at TCGA_config1 (the grid's canonical scale; head dim
# 64, which the kernels take), on rows held in memory: 79 train rows
# (9 steps of 8) and 9 test rows (one batch) at the grid's split of 0.1
SWEEP_ROWS, SWEEP_CELL, SWEEP_PROBE_EPOCHS = 88, "mca_d00", 20
# a small reproduce pipeline: 16 train and 8 test rows, one epoch
REPRO_ROWS, REPRO_SPLIT, REPRO_PROBE_EPOCHS = 24, 1 / 3, 20
# the probe's host and device loops on one full batch: order cannot
# matter, so they differ only in the order of their fp32 sums (the JAX
# package's pin for its scanned loop, tests/test_e2e.py): losses, norms
# and the final logits within 2e-4 (of the largest logit); a rank metric
# (AUROC, F1) moves by a whole pair or sample where two nearly equal
# scores swap, so within one pair's (one prediction's) share of the split,
# computed from its class counts (a train_auroc 1/4096 apart at 64
# positive x 64 negative entries, relative 3.7023e-4, passes)
PROBE_LOOPS_RTOL = 2e-4
PROBE_RANK_KEYS = ("train_auroc", "eval_auroc", "eval_f1")
# the probe's host loop on the card against the CPU from the same head:
# fp32 products and sums in another order, carried through 1024 AdamW
# steps (normalised updates, so a rounding gap moves a step by about lr)
PROBE_CPU_RTOL = 1e-3
PEAK_FP32 = 67e12  # FLOP/s, outside the tensor cores (an FFMA counts 2)
PEAK_FP32_ISSUE = PEAK_FP32 / 2  # fp32 instructions/s: 128 lanes a clock per SM
PEAK_MUFU = roofline_tool.rate_ceilings(1980.0, 132)["exp_elems_s"]  # 132 SMs at 1980 MHz
# measurement kernels against their plain versions, from seeded inputs
# under which every product moves the chain by several bf16 units
# (probes.counter_check_inputs; K7's b far from the exp chain's fixed
# point).  An entry passes within PROBE_RTOL of itself plus PROBE_RTOL of
# the tile's largest entry.  bf16: 2^-6, as the kernels round the same
# products to bf16 from fp32 sums taken in another order, so a few
# entries land one unit apart and the chain carries that on (float64
# sums in the plain chain, a stand-in for another order, reach 0.42 of
# it in bwd5).  fp32 (the vpu and exp chains): 1e-5, as both chains
# contract and ex2.approx is good to about 2^-22.  The planted faults
# put 56-100% of each mode's entries outside (one iteration or step
# short), and bwd5 without dq, dv or dk 36%, 66% and 72% (measured on
# an H100)
CHECK_ITERS = 4
PROBE_RTOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5}
TIMED_ITERS = 256  # iterations of each K6 mode in its timed launch
TIMED_PROBE_ITERS = 8
TIMED_PROBE_LAUNCHES = 10
QUEUE_CYCLES = 20_000_000  # about 10 ms at 1980 MHz, to enqueue the timed launches
TIMED_CTL_STEPS = 64
CTL_DOTS = 1


def cuda_ms(fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean milliseconds of ``fn`` on the current stream (CUDA events).
    ``queued``: a spin kernel holds the stream while the launches are
    enqueued, so that launches shorter than the host's work to enqueue
    them (K7's 8-iteration launches, 25-40 us) run back to back and
    the events time the device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    """The larger of bytes over the HBM rate and ``n_ops`` bf16
    tensor-core operations over their peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm())


def outside_bf16(kernel: torch.Tensor, plain: torch.Tensor, atol: float) -> int:
    """Entries of ``kernel`` outside bf16 tolerance of ``plain``."""
    k, p = kernel.float(), plain.float()
    return int(((k - p).abs() > atol + BF16_RTOL * p.abs()).sum())


def bf16_err(kernel: torch.Tensor, plain: torch.Tensor, atol: float) -> float:
    """Max |kernel - plain|; asserts it is within bf16 tolerance."""
    diff = float((kernel.float() - plain.float()).abs().max())
    n_out = outside_bf16(kernel, plain, atol)
    assert n_out == 0, f"{n_out} entries outside tolerance, max abs err {diff}"
    return diff


def flash_inputs(device, b=8, h=8, dims=(800, 198, 800, 662), fusion=88, seed=0,
                 masked=True, combos=(4, 3, 2), zorro=False, full_rows=(), missing_row=1):
    """q, k, v at the model's shapes, the real MCA mask (MMA's with
    ``zorro``), and key padding with ragged modality tails and sample
    ``missing_row`` missing a modality (the second, or the only one).
    ``masked=False``: one EAO pass over the modalities ``dims``, no
    static mask (None) and no fusion tokens.  ``full_rows``: samples
    whose modalities keep their whole length (no ragged tail), so that
    the last tile of a pass has live keys."""
    if masked:
        ms = build_masks(list(dims), fusion, list(combos), zorro=zorro, fcl=True)
        mask, t = ms.attn_mask, ms.seq_len
    else:
        mask, t = None, sum(dims)
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (
        torch.randn((b, h, t, 64), generator=g, device=device).to(torch.bfloat16)
        for _ in range(3)
    )
    pad = torch.zeros((b, t), dtype=torch.bool)
    starts = np.concatenate([[0], np.cumsum(dims)])
    rng = np.random.default_rng(seed)
    for i in range(b):
        for m in range(len(dims)):
            cut = int(rng.integers(dims[m] // 2, dims[m] + 1))
            if i not in full_rows:
                pad[i, starts[m] + cut : starts[m + 1]] = True
    missing = min(1, len(dims) - 1)
    pad[missing_row, starts[missing] : starts[missing + 1]] = True  # that sample misses it
    return mask, q, k, v, pad.to(device)


def microbatch_inputs(device, h=8, rows=MICRO_ROWS) -> tuple:
    """One pipeline microbatch of :func:`flash_inputs`' batch of 8:
    ``rows`` of q, k, v and the key padding (one of them missing a
    modality), each copied, as ``pipeline_layers`` copies its
    microbatches' padding from a row offset into the batch's."""
    mask, q, k, v, pad = flash_inputs(device, h=h, missing_row=rows.stop - 1)
    return (mask, *(x[rows].clone() for x in (q, k, v, pad)))


def hold_flash(mask, q, k, v, pad) -> dict:
    """K1 on ``(q, k, v)`` against its plain version: live rows within
    bf16 tolerance, dead rows exactly 0 with lse NEG_INF, and a planted
    fault (the plain forward with one 64 x 64 tile dropped: of the tiles
    off the ragged edge that the padding leaves some entry live, and
    that the static mask leaves partly blocked where it blocks any, the
    one with the median live count) outside the same tolerance.
    ``mask`` None is the unmasked call, as EAO's passes make it."""
    b, h, t, d = q.shape
    scale = d**-0.5
    static = flash.all_live_mask(t) if mask is None else mask
    with torch.inference_mode():
        out, lse = flash.flash_attention(q, k, v, mask, pad, scale)
        ref, ref_lse = flash.flash_attention_reference(q, k, v, mask, pad, scale)
        torch.cuda.synchronize()
        blocked = torch.from_numpy(static).to(q.device)[None] | pad[:, None, :]
        live = ~blocked.all(dim=2)  # [B, T]
        live_bh = live[:, None, :].expand(b, h, t)
        err = bf16_err(out[live_bh], ref[live_bh], FLASH_ATOL)
        assert bool((out[~live_bh] == 0).all()), "dead rows are not zero"
        assert bool((lse[~live_bh] == flash.NEG_INF).all())
        lse_err = float((lse[live_bh] - ref_lse[live_bh]).abs().max())
        assert lse_err < 1e-3, lse_err
        # the check covered dead rows (unmasked, only a sample that misses
        # every modality of the pass has them)
        assert int((~live).sum()) > 0 or not bool(pad.all(dim=1).any()) and mask is None
        qi, kj, n_live = planted_tile(static, pad, partial=mask is not None)
        faulty_mask = static.copy()
        faulty_mask[qi * flash.BLOCK : (qi + 1) * flash.BLOCK,
                    kj * flash.BLOCK : (kj + 1) * flash.BLOCK] = True
        faulty = flash.flash_attention_reference(q, k, v, faulty_mask, pad, scale)[0]
        flagged = outside_bf16(out[live_bh], faulty[live_bh], FLASH_ATOL)
        del faulty
        assert flagged > 0, "planted fault passes: a dropped tile"
    return {"err": err, "lse_err": lse_err, "blocked": blocked, "lse": lse,
            "planted": (qi, kj, n_live, flagged)}


def shape_label(b: int, h: int) -> str:
    """How phase 4 names a shape other than the batch of 8 at 8 heads."""
    return "".join(f" at {k} {v}" for k, v, full in (("B", b, 8), ("H", h, 8)) if v != full)


def check_flash(device, h=8, rows=None) -> dict:
    """K1 against its plain version at TCGA_config1's mask, timed beside
    SDPA; at ``h`` 8 (the model's heads) or 4 (a rank's under mesh_model 2),
    on the batch of 8 or on its ``rows`` (:func:`microbatch_inputs`)."""
    mask, q, k, v, pad = (flash_inputs(device, h=h) if rows is None
                          else microbatch_inputs(device, h, rows))
    b, h, t, d = q.shape
    scale = d**-0.5
    held = hold_flash(mask, q, k, v, pad)
    err, lse_err, blocked, lse = held["err"], held["lse_err"], held["blocked"], held["lse"]
    qi, kj, n_live, flagged = held["planted"]
    with torch.inference_mode():
        sdpa_mask = ~blocked[:, None]  # True = may attend
        ms = cuda_ms(lambda: flash.flash_attention(q, k, v, mask, pad, scale), 20)
        plain_ms = cuda_ms(
            lambda: flash.flash_attention_reference(q, k, v, mask, pad, scale), 3, 1
        )
        lib_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, scale=scale
            ),
            20,
        )
    # this run's work: every (query, key) pair the static mask and the
    # padding leave, two products of depth 64 each, over all heads
    pairs = float((~blocked).sum()) * h
    n_ops = 4.0 * d * pairs
    n_bytes = 4 * q.numel() * 2 + lse.numel() * 4 + mask.size + pad.numel()
    bms, by = bound_ms(n_bytes, n_ops)
    print(
        f"K1 flash_fwd{shape_label(b, h)}: max_abs_err {err:.3e} (lse {lse_err:.3e}), "
        f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, {lib_ms:.4f} ms sdpa, "
        f"bound {bms:.4f} ms ({by}), {pairs:.4g} live score entries; planted fault "
        f"(tile q{qi} x kv{kj}, {n_live} live entries over the batch, dropped) puts "
        f"{flagged} entries outside tolerance",
        flush=True,
    )
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "mca_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mca_tpu/ops/flash_attention.py:196",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": lib_ms,
    }


def median_tile(tiles: list):
    """The (q tile, kv tile, live entries) with the median live count of
    ``tiles`` ``[(count, q tile, kv tile)]``."""
    cnt, i, j = sorted(tiles)[len(tiles) // 2]
    return i, j, cnt


def tile_live(mask: np.ndarray, pad: torch.Tensor, i: int, j: int) -> int:
    """Live entries of tile (q tile i, kv tile j) over the batch."""
    bl = flash.BLOCK
    live = ~torch.from_numpy(mask[i * bl : (i + 1) * bl, j * bl : (j + 1) * bl])[None]
    return int((live & ~pad.cpu()[:, None, j * bl : (j + 1) * bl]).sum())


def planted_tile(mask: np.ndarray, pad: torch.Tensor, partial: bool = True):
    """The (q tile, kv tile) that the planted fault drops, and its live
    entries over the batch: of the tiles that the static mask leaves
    partly blocked (any tile, without ``partial``) off the ragged edge
    and the padding leaves some entry live, the one with the median
    count of live entries; a pass of one tile drops that tile."""
    row_ptr, col_idx, full = flash.tile_schedule(mask)
    nt = len(row_ptr) - 1
    edge = max(nt - 1, 1)
    tiles = []
    for i in range(edge):
        for n in range(row_ptr[i], row_ptr[i + 1]):
            j = int(col_idx[n])
            if (not full[n] or not partial) and j < edge:
                cnt = tile_live(mask, pad, i, j)
                if cnt:
                    tiles.append((cnt, i, j))
    return median_tile(tiles)


def planted_pair_half(mask: np.ndarray, pad: torch.Tensor, partial: bool = True):
    """The second planted fault's tile, one that a pair walk could drop
    while its first half still runs: of the kv_pair_schedule items whose
    SECOND kv tile (2j + 1) is live but not full (any, without
    ``partial``), off the ragged edge, and has some entry the padding
    leaves live, the one with the median count of live entries."""
    pair_ptr, pair_q, flags, _ = flash.kv_pair_schedule(mask)
    nt = -(-mask.shape[0] // flash.BLOCK)
    tiles = []
    for p in range(len(pair_ptr) - 1):
        j = 2 * p + 1
        for n in range(pair_ptr[p], pair_ptr[p + 1]):
            i = int(pair_q[n])
            if flags[n] & 2 and (not flags[n] & 8 or not partial) and max(i, j) < nt - 1:
                cnt = tile_live(mask, pad, i, j)
                if cnt:
                    tiles.append((cnt, i, j))
    return median_tile(tiles)


def planted_lone_half(mask: np.ndarray, pad: torch.Tensor, kv: bool = True):
    """With an odd number of tiles, the last pair of a pair walk has one
    tile: the last kv tile for K2 / K3b's walk (``kv``), the last q tile
    for K3a's.  Of the tiles on that lone half that the schedule visits
    and the padding leaves some entry of, the one with the median count
    of live entries."""
    row_ptr, col_idx, _ = flash.tile_schedule(mask)
    nt = len(row_ptr) - 1
    assert nt % 2 == 1, nt
    tiles = []
    for i in range(nt):
        for n in range(row_ptr[i], row_ptr[i + 1]):
            j = int(col_idx[n])
            if (j if kv else i) == nt - 1:
                cnt = tile_live(mask, pad, i, j)
                if cnt:
                    tiles.append((cnt, i, j))
    return median_tile(tiles)


def planted_bwd_faults(mask: np.ndarray, pad: torch.Tensor, partial: bool = True) -> dict:
    """The backward's planted faults, each a tile the plain backward
    drops: a tile of the q-major walk (partly masked where ``partial``),
    the second kv tile of a pair item (past two tiles) and, where the
    tile count is odd, a tile on the lone half of the last kv pair and of
    the last q pair."""
    nt = -(-mask.shape[0] // flash.BLOCK)
    faults = {"tile": planted_tile(mask, pad, partial=partial)}
    if nt > 2:  # a second kv tile off the ragged edge
        faults["pair half"] = planted_pair_half(mask, pad, partial=partial)
    if nt % 2:
        faults["lone kv half"] = planted_lone_half(mask, pad, kv=True)
        faults["lone q half"] = planted_lone_half(mask, pad, kv=False)
    return faults


def hold_flash_bwd(mask, q, k, v, pad, do, label: str, determinism: bool = False,
                   verbose: bool = False) -> dict:
    """K2 (fused) and K3a + K3b (split) on ``(q, k, v, do)`` against the
    plain backward: every gradient within bf16 tolerance entry by entry
    and within BWD_REL_L2 relative L2, dead-row dq and padded-key dk / dv
    exactly 0, the two routes within BWD_REL_L2 of each other; each
    planted fault (:func:`planted_bwd_faults`) must exceed BWD_REL_L2 on
    every gradient; with ``determinism``, K3a's dq bitwise equal over two
    runs.  ``mask`` None is the unmasked call, as EAO's passes make it.
    Returns the errors, and what :func:`check_flash_bwd` times with."""
    b, h, t, d = q.shape
    scale = d**-0.5
    static = flash.all_live_mask(t) if mask is None else mask
    names = ("dq", "dk", "dv")
    say = print if verbose else (lambda *_, **__: None)
    with torch.inference_mode():
        out, lse = flash.flash_attention(q, k, v, mask, pad, scale)
        ref = flash.flash_attention_bwd_reference(q, k, v, mask, pad, out, lse, do, scale)
        fused = flash.flash_attention_backward(q, k, v, mask, pad, out, lse, do, scale, "fused")
        split = flash.flash_attention_backward(q, k, v, mask, pad, out, lse, do, scale, "split")
        torch.cuda.synchronize()
        blocked = torch.from_numpy(static).to(q.device)[None] | pad[:, None, :]
        dead = blocked.all(dim=2)[:, None, :].expand(b, h, t)  # dead query rows
        padded = pad[:, None, :].expand(b, h, t)  # padded keys
        planted = {}
        for fault, (qi, kj, n_live) in planted_bwd_faults(static, pad, mask is not None).items():
            faulty_mask = static.copy()
            tq, tk = (slice(x * flash.BLOCK, (x + 1) * flash.BLOCK) for x in (qi, kj))
            faulty_mask[tq, tk] = True
            faulty = flash.flash_attention_bwd_reference(
                q, k, v, faulty_mask, pad, out, lse, do, scale
            )
            planted[fault] = (qi, kj, n_live, [rel_l2(f, r) for f, r in zip(faulty, ref)])
            for name, r, f in zip(names, ref, faulty):
                a = r.float().abs()
                atol = BWD_ATOL * float(a.max())
                flagged = int(((f.float() - r.float()).abs() > atol + BF16_RTOL * a).sum())
                say(
                    f"{label} backward {name}: max |plain| {float(a.max()):.4e}, median "
                    f"|plain| {float(a.median()):.4e}, entry tolerance {atol:.3e} + "
                    f"2^-6 relative; planted {fault} fault (tile q{qi} x kv{kj}, "
                    f"{n_live} live entries over the batch, dropped): "
                    f"relative L2 {rel_l2(f, r):.3e}, {flagged} entries past the "
                    f"entry tolerance",
                    flush=True,
                )
                assert rel_l2(f, r) > BWD_REL_L2, (label, fault, name, "planted fault passes")
            del faulty
        errs, rels = {}, {}
        for impl, grads in (("fused", fused), ("split", split)):
            for name, x, r in zip(names, grads, ref):
                rels[impl, name] = rel_l2(x, r)
            say(
                f"{label} backward {impl}: relative L2 against plain "
                + ", ".join(f"{n} {rels[impl, n]:.3e}" for n in names),
                flush=True,
            )
            for name, x, r in zip(names, grads, ref):
                errs[impl, name] = bf16_err(x, r, BWD_ATOL * float(r.abs().max()))
                assert rels[impl, name] <= BWD_REL_L2, (label, impl, name, rels[impl, name])
            assert bool((grads[0][dead] == 0).all()), f"{label} {impl}: dead-row dq is not 0"
            assert bool((grads[1][padded] == 0).all()), f"{label} {impl}: padded-key dk is not 0"
            assert bool((grads[2][padded] == 0).all()), f"{label} {impl}: padded-key dv is not 0"
        # both were covered (unmasked, only a sample that misses every
        # modality of the pass has dead rows)
        assert int(padded.sum()) > 0
        assert int(dead.sum()) > 0 or mask is None and not bool(pad.all(dim=1).any())
        if determinism:
            # K3a is the deterministic route: its dq sums in a fixed
            # order, so a second run on the same inputs gives the same bits
            again = flash.flash_attention_backward(q, k, v, mask, pad, out, lse, do, scale,
                                                   "split")
            torch.cuda.synchronize()
            assert torch.equal(again[0], split[0]), f"{label} K3a: two runs give different dq"
            del again
        # K2 against K3a + K3b: dk and dv come from the same kernel body;
        # dq sums the same bf16 products, in fp32, in another order
        fused_vs_split = max(
            bf16_err(x, y, BWD_ATOL * float(y.abs().max())) for x, y in zip(fused, split)
        )
        route_rel = max(rel_l2(x, y) for x, y in zip(fused, split))
        assert route_rel <= BWD_REL_L2, (label, route_rel)
    return {"errs": errs, "rels": rels, "fused_vs_split": fused_vs_split,
            "route_rel": route_rel, "planted": planted, "blocked": blocked,
            "out": out, "lse": lse, "dead": int(dead.sum()), "padded": int(padded.sum())}


def check_flash_bwd(device) -> list:
    """K2 (fused) and K3a + K3b (split) against the plain backward and
    against each other, at the shapes and mask of ``check_flash``."""
    mask, q, k, v, pad = flash_inputs(device)
    b, h, t, d = q.shape
    scale = d**-0.5
    g = torch.Generator(device=device).manual_seed(1)
    do = torch.randn(q.shape, generator=g, device=device).to(torch.bfloat16)
    held = hold_flash_bwd(mask, q, k, v, pad, do, "phase 4", determinism=True, verbose=True)
    errs, blocked, out, lse = held["errs"], held["blocked"], held["out"], held["lse"]
    fused_vs_split, route_rel = held["fused_vs_split"], held["route_rel"]
    names = ("dq", "dk", "dv")
    with torch.inference_mode():
        args = (q, k, v, do, lse, flash.attention_delta(out, do), mask, pad, scale)
        # K2 and K3b take q_s from the wrapper where bf16(scale) is not a
        # power of two (ops/flash_attention.py _q_operand)
        out_b, lse_b = flash.flash_attention(q, k, v, mask, pad, SCALE_NOT_POW2)
        ref_b = flash.flash_attention_bwd_reference(
            q, k, v, mask, pad, out_b, lse_b, do, SCALE_NOT_POW2
        )
        for impl in ("fused", "split"):
            got = flash.flash_attention_backward(
                q, k, v, mask, pad, out_b, lse_b, do, SCALE_NOT_POW2, impl
            )
            rel_b = [rel_l2(x, r) for x, r in zip(got, ref_b)]
            print(
                f"backward {impl}, scale {SCALE_NOT_POW2}: relative L2 against "
                "plain " + ", ".join(f"{n} {x:.3e}" for n, x in zip(names, rel_b)),
                flush=True,
            )
            assert max(rel_b) <= BWD_REL_L2, (impl, SCALE_NOT_POW2, rel_b)
        del out_b, lse_b, ref_b, got
        # an odd number of kv tiles (T 160, 3 tiles): the last pair's
        # second tile lies past T, where its k and v load as zeros
        m_odd, q_o, k_o, v_o, pad_o = flash_inputs(device, b=2, h=2, dims=ODD_DIMS, fusion=22)
        assert -(-m_odd.shape[0] // flash.BLOCK) % 2 == 1
        do_o = torch.randn(q_o.shape, generator=g, device=device).to(torch.bfloat16)
        out_o, lse_o = flash.flash_attention(q_o, k_o, v_o, m_odd, pad_o, scale)
        ref_o = flash.flash_attention_bwd_reference(
            q_o, k_o, v_o, m_odd, pad_o, out_o, lse_o, do_o, scale
        )
        for impl in ("fused", "split"):
            got = flash.flash_attention_backward(
                q_o, k_o, v_o, m_odd, pad_o, out_o, lse_o, do_o, scale, impl
            )
            rel_o = [rel_l2(x, r) for x, r in zip(got, ref_o)]
            print(
                f"backward {impl}, T {m_odd.shape[0]} (odd kv tiles): relative L2 "
                "against plain " + ", ".join(f"{n} {x:.3e}" for n, x in zip(names, rel_o)),
                flush=True,
            )
            assert max(rel_o) <= BWD_REL_L2, (impl, "odd kv tiles", rel_o)
            padded_o = pad_o[:, None, :].expand(got[1].shape[:3])
            assert bool((got[1][padded_o] == 0).all() and (got[2][padded_o] == 0).all()), impl

        ms = bwd_kernel_ms(args, q)
        plain_ms = cuda_ms(
            lambda: flash.flash_attention_bwd_reference(q, k, v, mask, pad, out, lse, do, scale),
            3, 1,
        )
    # the yardstick: the backward alone of SDPA with the same boolean mask
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=~blocked[:, None], scale=scale
    )
    lib_ms = cuda_ms(
        lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do, retain_graph=True), 10
    )
    del sdpa_out

    # this run's work: every live (query, key) pair, over all heads
    pairs = float((~blocked).sum()) * h
    entries = []
    for name, (_, _, tpu_name, line, src) in BWD_WORK.items():
        bms, by = bwd_bound(name, q, lse, mask, pad, pairs)
        impl = "fused" if name == "flash_bwd" else "split"
        outs = BWD_OUTS[name]
        err = max(errs[impl, o] for o in outs)
        print(
            f"{name} ({tpu_name}): max_abs_err {err:.3e} "
            f"({', '.join(f'{o} {errs[impl, o]:.3e}' for o in outs)}), "
            f"{ms[name]:.4f} ms kernel, {plain_ms:.4f} ms plain (dq, dk, dv), "
            f"{lib_ms:.4f} ms sdpa backward, bound {bms:.4f} ms ({by})",
            flush=True,
        )
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"mca_tpu_torch/csrc/{src}",
            "replaces": f"mca_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err,
            "ms": ms[name],
            "plain_ms": plain_ms,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": lib_ms,
        })
    print(
        f"backward: fused vs split max abs gap {fused_vs_split:.3e}, "
        f"relative L2 {route_rel:.3e}; "
        f"{held['dead']} dead query rows, {held['padded']} padded keys "
        f"(all heads); {pairs:.4g} live score entries",
        flush=True,
    )
    # the shapes the parallel phases give the kernels besides the batch
    # of 8 at 8 heads: a rank's heads under mesh_model 2 (phases 14, 15)
    # and a microbatch of the pipe (phase 15), with the same mask; K1 and
    # the backward held and timed as above
    del held, args, do
    for h2, rows in ((TP_HEADS, None), (h, MICRO_ROWS)):
        check_flash(device, h=h2, rows=rows)
        _, q2, k2, v2, pad2 = (flash_inputs(device, h=h2) if rows is None
                               else microbatch_inputs(device, h2, rows))
        label = shape_label(q2.shape[0], h2)
        do2 = torch.randn(q2.shape, generator=g, device=device).to(torch.bfloat16)
        held2 = hold_flash_bwd(mask, q2, k2, v2, pad2, do2, f"phase 4 ({label.strip()})")
        with torch.inference_mode():
            out2, lse2 = held2["out"], held2["lse"]
            ms2 = bwd_kernel_ms((q2, k2, v2, do2, lse2, flash.attention_delta(out2, do2), mask,
                                 pad2, scale), q2)
        pairs2 = float((~held2["blocked"]).sum()) * h2
        planted2 = "; ".join(
            f"{fault} (tile q{qi} x kv{kj}, {n_live} live entries) relative L2 "
            + ", ".join(f"{x:.3e}" for x in rel) for fault, (qi, kj, n_live, rel)
            in held2["planted"].items())
        for name in BWD_WORK:
            bms2, by2 = bwd_bound(name, q2, lse2, mask, pad2, pairs2)
            impl = "fused" if name == "flash_bwd" else "split"
            print(
                f"{name}{label}: {ms2[name]:.4f} ms kernel (queued), bound {bms2:.4f} ms "
                f"({by2}); max_abs_err "
                + ", ".join(f"{o} {held2['errs'][(impl, o)]:.3e}" for o in BWD_OUTS[name])
                + "; relative L2 against plain "
                + ", ".join(f"{o} {held2['rels'][(impl, o)]:.3e}" for o in ("dq", "dk", "dv")),
                flush=True,
            )
        print(f"backward{label}: planted faults (dq, dk, dv) {planted2}", flush=True)
        del held2, do2, q2, k2, v2
    return entries


#: per backward kernel: products of depth 64 a live (query, key) pair
#: (K2 five: s, dp, dv, dk, dq; K3a three: s, dp, dq; K3b four: s, dp,
#: dv, dk), the gradients it writes, the TPU kernel and its line, the source
BWD_WORK = {
    "flash_bwd": (5, 3, "_fused_bwd_kernel", 337, "flash_bwd.cu"),
    "flash_bwd_dq": (3, 1, "_dq_kernel", 281, "flash_bwd_dq.cu"),
    "flash_bwd_dkv": (4, 2, "_dkv_kernel", 523, "flash_bwd_dkv.cu"),
}
BWD_OUTS = {"flash_bwd": ("dq", "dk", "dv"), "flash_bwd_dq": ("dq",), "flash_bwd_dkv": ("dk", "dv")}


def bwd_bound(name, q, lse, mask, pad, pairs):
    """``bound_ms`` of backward kernel ``name`` on this run's inputs: the
    inputs read once (q, k, v, do bf16; lse, delta fp32; mask; padding),
    its gradients written once (bf16), and its products on ``pairs`` live
    (query, key) pairs over all heads."""
    products, n_out, *_ = BWD_WORK[name]
    n_in = 4 * q.numel() * 2 + 2 * lse.numel() * 4 + mask.size + pad.numel()
    return bound_ms(n_in + n_out * q.numel() * 2, 2.0 * q.shape[-1] * products * pairs)


def bwd_kernel_ms(args, q) -> dict:
    """K2, K3a and K3b each timed over 10 launches queued behind the spin
    kernel (:func:`cuda_ms`), so that the host's enqueueing stays out of
    the reading; ``args`` as :func:`flash.flash_bwd` takes them."""
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    return {
        "flash_bwd": cuda_ms(lambda: flash.flash_bwd(*args, dq_acc, dk, dv), 10, queued=True),
        "flash_bwd_dq": cuda_ms(lambda: flash.flash_bwd_dq(*args, dq), 10, queued=True),
        "flash_bwd_dkv": cuda_ms(lambda: flash.flash_bwd_dkv(*args, dk, dv), 10, queued=True),
    }


def ff_inputs(device, n, dim=512, inner=1365, seed=0) -> tuple:
    """x [n, dim] and the GEGLU weights W1 [dim, 2 inner], W2 [inner,
    dim] at the model's init scale, bf16, and K5's prepared weights."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device=device).to(torch.bfloat16)
    w1 = ((torch.rand((dim, 2 * inner), generator=g, device=device) * 2 - 1)
          * dim**-0.5).to(torch.bfloat16)
    w2 = ((torch.rand((inner, dim), generator=g, device=device) * 2 - 1)
          * inner**-0.5).to(torch.bfloat16)
    return x, w1, w2, ff.prepare_geglu_weights(w1, w2, torch.bfloat16)


def hold_ff(x, w1, w2, prepared) -> dict:
    """K5 on ``x`` against its plain version within bf16 tolerance, and a
    planted fault (the plain FF with one 64-wide inner chunk's W2 rows
    zeroed) outside the same tolerance."""
    with torch.inference_mode():
        out = ff.geglu_ff(x, *prepared)
        ref = ff.geglu_ff_reference(x, w1, w2)
        torch.cuda.synchronize()
        err = bf16_err(out, ref, FF_ATOL)
        chunk = prepared[1].shape[1] // ff.INNER_MULTIPLE // 2
        w2_fault = prepared[1].clone()
        w2_fault[:, chunk * ff.INNER_MULTIPLE : (chunk + 1) * ff.INNER_MULTIPLE] = 0
        flagged = outside_bf16(out, ff.geglu_ff_plain(x, prepared[0], w2_fault), FF_ATOL)
        assert flagged > 0, "planted fault passes: a W2 chunk zeroed"
    return {"err": err, "out": out, "planted": (chunk, flagged)}


def check_ff(device, n=20384, dim=512, inner=1365, seed=0) -> dict:
    x, w1, w2, prepared = ff_inputs(device, n, dim, inner, seed)
    # the padded halves, contiguous: rows of 2816 bytes, 16-byte aligned
    w1u, w1g, w2p = (w.contiguous() for w in ff.split_geglu_weights(*prepared))
    held = hold_ff(x, w1, w2, prepared)
    err, out, (chunk, flagged) = held["err"], held["out"], held["planted"]
    with torch.inference_mode():
        def chain():  # the unpadded [512, 2730] W1: rows of 5460 bytes
            u, gate = (x @ w1).chunk(2, dim=-1)
            return (torch.nn.functional.gelu(gate) * u) @ w2

        def chain_aligned():
            return (torch.nn.functional.gelu(x @ w1g) * (x @ w1u)) @ w2p

        ms = cuda_ms(lambda: ff.geglu_ff(x, *prepared), 20)
        plain_ms = cuda_ms(lambda: ff.geglu_ff_reference(x, w1, w2), 5)
        chain_ms = cuda_ms(chain, 20)
        aligned_ms = cuda_ms(chain_aligned, 20)
    n_ops = 6.0 * n * dim * inner
    n_bytes = 2.0 * (x.numel() + w1.numel() + w2.numel() + out.numel())
    bms, by = bound_ms(n_bytes, n_ops)
    print(
        f"K5 geglu_ff: max_abs_err {err:.3e}, {ms:.4f} ms kernel, "
        f"{plain_ms:.4f} ms plain, matmul-gelu-matmul {chain_ms:.4f} ms (unpadded W1) "
        f"and {aligned_ms:.4f} ms (padded halves), bound {bms:.4f} ms ({by}); planted "
        f"fault (W2 rows of inner chunk {chunk} zeroed) puts {flagged} entries outside "
        f"tolerance",
        flush=True,
    )
    return {
        "name": "geglu_ff",
        "route": "cuda",
        "source": "mca_tpu_torch/csrc/geglu_ff.cu",
        "replaces": "mca_tpu/ops/fused_ff.py:75",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": min(chain_ms, aligned_ms),
    }


def check_slice(config, device, cpu_device="cpu", n_rows=20, label="slice", params=None,
                quantize="none", keep=None) -> dict:
    """The serving slice (phase 5 for TCGA_config1, phase 10 (b) for
    CMU_config1, phase 12 (a) for the MoE model, phase 13 (a) for int8):
    ``embed``, ``submit`` and ``POST /embed`` on request rows shaped as
    the config's modalities, K1 once a block and forward, K5 too unless
    the blocks' feed-forward is the MoE or int8, a row embedded alone
    against the same row inside a batch, and bf16 on the GPU against
    fp32 on the CPU (int8: the same int8 weights, quantised on each side
    from the fp32 ``params`` and held bitwise equal).  ``keep``, a dict,
    receives the service, the rows, ``embed``'s answer and the CPU
    service."""
    svc = EmbeddingService(config, params=params, device=device, seed=0, max_batch=8,
                           quantize=quantize)
    forwards = [0]
    svc.model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1)
    )
    rows = request_rows(config, n_rows)

    # the main path, with every launch count at 0 just before it
    flash.launches = 0
    ff.launches = 0
    forwards[0] = 0
    via_embed = svc.embed(rows)
    svc.start()
    try:
        futs = []
        threads = [
            threading.Thread(target=lambda r=r: futs.append((r, svc.submit(rows[r]))))
            for r in range(8)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        via_submit = {r: f.result(timeout=120) for r, f in futs}
    finally:
        svc.stop()
    server = make_server(svc, port=0)
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    try:
        port = server.server_address[1]
        payload = {"rows": [{m: {f: None if x is None else x.tolist() for f, x in d.items()}
                             for m, d in row.items()} for row in rows[:3]]}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/embed",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            via_http = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
    counts = {"flash_fwd": flash.launches, "geglu_ff": ff.launches}
    depth = len(svc.model.layers)
    ff_depth = 0 if int(config.get("moe_experts", 0) or 0) or quantize != "none" else depth
    print(f"{label}: {forwards[0]} forwards, launches {counts}", flush=True)
    assert forwards[0] >= 4, forwards  # 3 chunks of embed + >= 1 batch
    assert counts == {"flash_fwd": depth * forwards[0],
                      "geglu_ff": ff_depth * forwards[0]}, (counts, forwards[0])

    # the three request paths agree
    agree = 0.0
    for k in svc.emb_keys:
        e = via_embed["embeddings"][k]
        assert e.shape == (n_rows, config.hidden_size) and np.isfinite(e).all(), k
        for r, res in via_submit.items():
            agree = max(agree, float(np.abs(res["embeddings"][k] - e[r]).max()))
        for r in range(3):
            agree = max(agree, float(np.abs(np.asarray(via_http["embeddings"][r][k]) - e[r]).max()))
    for r, res in via_submit.items():
        assert res["present"] == {k: bool(via_embed["present"][k][r]) for k in svc.mask_keys}
    assert agree <= AGREE_ATOL, agree
    assert not all(via_embed["present"][k].all() for k in svc.mask_keys)
    # a row alone (its batch-mates the all-pad template) against the same
    # row inside the batch: nothing in a forward mixes samples
    alone = 0.0
    for r in (0, 5):
        single = svc.embed([rows[r]])
        alone = max(alone, max(float(np.abs(single["embeddings"][k][0]
                                            - via_embed["embeddings"][k][r]).max())
                               for k in svc.emb_keys))
    assert alone <= AGREE_ATOL, alone

    # the same weights in fp32 on the CPU through the plain versions
    cfg32 = type(config)(config)
    cfg32.precision = "fp32"
    cpu_svc = EmbeddingService(
        cfg32, params=svc.model.state_dict() if params is None else params,
        device=cpu_device, max_batch=8, warmup=False, quantize=quantize,
    )
    for k, v in cpu_svc.model.state_dict().items():
        if v.dtype == torch.int8 or k.endswith(".scale"):
            assert torch.equal(v, svc.model.state_dict()[k].cpu()), k
    ref = cpu_svc.embed(rows[:8])
    rel = max(
        float(np.linalg.norm(via_embed["embeddings"][k][:8] - ref["embeddings"][k])
              / np.linalg.norm(ref["embeddings"][k]))
        for k in svc.emb_keys
    )
    for k in svc.mask_keys:
        np.testing.assert_array_equal(via_embed["present"][k][:8], ref["present"][k])
    assert rel <= SLICE_REL_L2, rel

    # steady-state forward time at max_batch 8
    batch_rows = rows[:8]
    iters = 10
    svc._materialise(svc._dispatch(batch_rows), 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dev = svc._dispatch(batch_rows)
    svc._materialise(dev, 8)
    fwd_ms = (time.perf_counter() - t0) / iters * 1e3
    t0 = time.perf_counter()
    svc.embed(rows)
    embed_s = time.perf_counter() - t0
    print(
        f"{label}: embed/submit/http max disagreement {agree:.3e}; a row alone vs "
        f"inside a batch {alone:.3e}; "
        f"bf16 GPU vs fp32 CPU relative L2 {rel:.3e}; "
        f"{fwd_ms:.3f} ms per batch-8 forward ({8e3 / fwd_ms:.1f} rows/s); "
        f"embed of {n_rows} rows {embed_s * 1e3:.1f} ms ({n_rows / embed_s:.1f} rows/s)",
        flush=True,
    )
    if keep is not None:
        keep.update(svc=svc, rows=rows, via_embed=via_embed, cpu_svc=cpu_svc)
    return counts


def attention_leaves(grads: dict, projections=("to_q", "to_kv", "to_out")) -> list:
    """Names of the transformer blocks' attention-projection weights."""
    return [n for n in grads if n.startswith("layers.")
            and n.split(".")[-2] in projections]


def moe_leaves_fp32(model) -> None:
    """Every MoE feed-forward of ``model`` computing in fp32 (its
    router already does), the rest of the model as it was."""
    for m in model.modules():
        if isinstance(m, MoEFeedForward):
            m.dtype = torch.float32


def check_moe_leaves(label, gpu: dict, cpu: dict, gpu_grads) -> None:
    """Phase 12 (b)'s MoE leaves, the first step's router and expert
    gradients leaf by leaf, bf16 on the GPU against fp32 on the CPU: each
    under its bound; each over it with every MoE leaf's gradient scaled
    by PLANTED_MOE_SCALE (a planted fault); and, to show where the gap
    comes from, read again with the MoE computing in fp32 on the card.
    ``gpu_grads(plant)`` is the step's gradients on the GPU after
    ``plant(model)``."""
    bound = {n: TRAIN_ROUTER_GRAD_REL_L2 if ".ff.router." in n else TRAIN_EXPERT_GRAD_REL_L2
             for n in gpu if ".ff.router." in n or ".ff.experts." in n}

    def scaled(model):
        for n, p in model.named_parameters():
            if n in bound:
                p.register_hook(lambda g: g * PLANTED_MOE_SCALE)

    readings = {"bf16": gpu, f"gradients x {PLANTED_MOE_SCALE}": gpu_grads(scaled),
                "MoE in fp32": gpu_grads(moe_leaves_fp32)}
    rel = {arm: {n: rel_l2(g[n], cpu[n]) for n in bound} for arm, g in readings.items()}
    for arm, r in rel.items():
        print(f"{label}: first-step MoE gradients vs fp32 CPU, relative L2, {arm} on the "
              f"GPU: {', '.join(f'{n} {x:.3e}' for n, x in r.items())}", flush=True)
    for n, b in bound.items():
        assert rel["bf16"][n] <= b, (n, rel["bf16"][n], b)
        assert rel[f"gradients x {PLANTED_MOE_SCALE}"][n] > b, (n, b)


def check_train(config, device, cpu_device="cpu", steps=TRAIN_STEPS, label="train") -> dict:
    """The training slice: the config's model (TCGA_config1, CMU_config1,
    EAO) at full width and depth on the GPU, on one batch of
    ``synthetic_rows``, ``steps`` steps through the fused backward (the
    main path) and again through the split one from the same weights;
    from those weights, the first step's gradients of the two routes
    against each other, and its loss and gradients against fp32 on the
    CPU.  K1 and K2 (or K3a + K3b) run once a block and pass: 10 passes
    for EAO.  Returns the backward launches and the initial weights."""
    config = type(config)(config)
    print(
        f"{label}: num_warmup_steps set to {TRAIN_WARMUP} (the config's "
        f"{config.num_warmup_steps} would keep lr near 0 for these {steps} steps)",
        flush=True,
    )
    config.num_warmup_steps = TRAIN_WARMUP
    rows = synthetic_rows(config, int(config.batch_size))
    collated = MultimodalCollator(config.modality_config.to_plain())(rows)
    init = seed_model(config)
    params = {k: v.clone() for k, v in init.state_dict().items()}
    depth, tokens = len(init.layers), int(config.batch_size) * sample_tokens(config, init)
    passes = len(init.channels) if config.eao else 1

    print(host_description(), flush=True)
    runs, counts = {}, {}
    for impl in ("fused", "split"):
        flash.default_bwd_impl = impl
        model, opt, sched = build_trainer(
            config, device, num_training_steps=steps, params=params
        )
        batch = to_device(collated, device)
        # each path with every launch count at 0 just before it
        flash.launches = 0
        ff.launches = 0
        flash.bwd_launches.update(dict.fromkeys(flash.bwd_launches, 0))
        history, step_s, step_cpu_s = [], [], []
        probe = host_probe_ms()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            history.append(train_step(model, opt, sched, batch, clip=float(config.clip)))
            step_s.append(time.perf_counter() - t0)  # train_step ends in a sync
            step_cpu_s.append(time.process_time() - c0)
        counts[impl] = {
            "flash_fwd": flash.launches, "geglu_ff": ff.launches, **flash.bwd_launches,
        }
        runs[impl] = (history, step_s, step_cpu_s, probe)
        print(f"{label} ({impl} backward): launches {counts[impl]}", flush=True)
        del model, opt, sched
    flash.default_bwd_impl = "fused"

    fused_c, split_c = counts["fused"], counts["split"]
    n = depth * passes * steps
    assert fused_c == {"flash_fwd": n, "geglu_ff": 0, "flash_bwd": n,
                       "flash_bwd_dq": 0, "flash_bwd_dkv": 0}, fused_c
    assert split_c == {"flash_fwd": n, "geglu_ff": 0, "flash_bwd": 0,
                       "flash_bwd_dq": n, "flash_bwd_dkv": n}, split_c
    for impl, (history, *_) in runs.items():
        for m in history:
            for k in ("total_loss", "fcl_loss", "no-fcl_loss", "param_norm", "grad_norm"):
                assert math.isfinite(m[k]), (impl, k, m)
            # a pair whose presence mask is empty in this batch is NaN by
            # design (excluded from total_loss); nothing may be infinite
            assert not any(math.isinf(v) for v in m.values()), (impl, m)
    fused_loss = [m["total_loss"] for m in runs["fused"][0]]
    split_loss = [m["total_loss"] for m in runs["split"][0]]
    gap = max(abs(a - b) / abs(b) for a, b in zip(fused_loss, split_loss))
    assert gap <= TRAIN_SPLIT_RTOL, (fused_loss, split_loss)
    assert runs["fused"][0][-1]["lr"] > 0

    # the first step from the same weights: the loss and every gradient
    # (on the CPU, fp32), through each route on the GPU, through the
    # split route with a planted dq fault, and in fp32 on the CPU
    # through the plain versions
    def first_step(cfg, dev, impl="fused", plant=None):
        flash.default_bwd_impl = impl
        model = build_trainer(cfg, dev, params=params)[0]
        if plant is not None:
            plant(model)
        loss = float(forward_backward(model, to_device(collated, dev))["total_loss"])
        flash.default_bwd_impl = "fused"
        return loss, {n: p.grad.float().cpu() for n, p in model.named_parameters()}

    gpu_loss, gpu = first_step(config, device, "fused")
    _, split = first_step(config, device, "split")
    real_dq = flash.flash_bwd_dq
    flash.flash_bwd_dq = lambda *a: (real_dq(*a), a[-1].mul_(PLANTED_DQ_SCALE))
    _, planted = first_step(config, device, "split")
    flash.flash_bwd_dq = real_dq
    cfg32 = type(config)(config)
    cfg32.precision = "fp32"
    t0 = time.perf_counter()
    cpu_loss, cpu = first_step(cfg32, cpu_device)
    cpu_step_s = time.perf_counter() - t0

    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    grad_rel = rel_l2(torch.cat([g.reshape(-1) for g in gpu.values()]),
                      torch.cat([g.reshape(-1) for g in cpu.values()]))
    attn = attention_leaves(gpu)
    qkv = attention_leaves(gpu, ("to_q", "to_kv"))
    attn_rel = {n: rel_l2(gpu[n], cpu[n]) for n in attn}
    route_rel = {n: rel_l2(split[n], gpu[n]) for n in qkv}
    planted_rel = {n: rel_l2(planted[n], gpu[n]) for n in qkv}
    planted_cpu = max(rel_l2(planted[n], cpu[n]) for n in qkv)
    print(
        f"{label}: first-step gradients, relative L2 per leaf; bf16 GPU vs fp32 "
        f"CPU: {', '.join(f'{n} {x:.3e}' for n, x in attn_rel.items())}; "
        f"split vs fused: {', '.join(f'{n} {x:.3e}' for n, x in route_rel.items())}; "
        f"split with dq x {PLANTED_DQ_SCALE} vs fused: "
        f"{', '.join(f'{n} {x:.3e}' for n, x in planted_rel.items())}",
        flush=True,
    )
    if any(".ff.router." in n for n in gpu):
        check_moe_leaves(label, gpu, cpu, lambda plant: first_step(config, device, plant=plant)[1])
    assert loss_rel <= TRAIN_LOSS_RTOL, (gpu_loss, cpu_loss)
    assert grad_rel <= TRAIN_GRAD_REL_L2, grad_rel
    assert max(attn_rel.values()) <= TRAIN_ATTN_GRAD_REL_L2, attn_rel
    assert max(route_rel.values()) <= TRAIN_ROUTE_GRAD_REL_L2, route_rel
    assert max(planted_rel.values()) > TRAIN_ROUTE_GRAD_REL_L2, planted_rel
    assert planted_cpu > TRAIN_ATTN_GRAD_REL_L2, planted_cpu

    step_ms = 1e3 * float(np.mean(runs["fused"][1][1:]))
    split_ms = 1e3 * float(np.mean(runs["split"][1][1:]))
    def each(xs):
        return ", ".join(f"{1e3 * x:.3f}" for x in xs)

    print(
        f"{label}: total_loss fused {['%.5f' % x for x in fused_loss]}, "
        f"split {['%.5f' % x for x in split_loss]} (max relative gap {gap:.3e}); "
        f"first step bf16 GPU vs fp32 CPU: loss {gpu_loss:.6f} vs {cpu_loss:.6f} "
        f"(relative {loss_rel:.3e}), gradient relative L2 {grad_rel:.3e}, "
        f"attention projections at most {max(attn_rel.values()):.3e}; split vs "
        f"fused q / kv projections at most {max(route_rel.values()):.3e}, planted "
        f"dq fault {max(planted_rel.values()):.3e} (against fp32 CPU "
        f"{planted_cpu:.3e}) (CPU step {cpu_step_s:.1f} s, depth {depth})",
        flush=True,
    )
    for impl, (_, step_s, step_cpu_s, probe) in runs.items():
        print(
            f"{label} ({impl}): wall ms per step {each(step_s)}; process CPU ms "
            f"{each(step_cpu_s)}; Python loop probe before the run {probe:.1f} ms",
            flush=True,
        )
    print(host_description(), flush=True)
    print(
        f"{label}: {step_ms:.3f} ms per step with the fused backward, {split_ms:.3f} ms "
        f"with the split one (mean of steps 2-{steps}, host clock, synchronised); "
        f"{tokens / step_ms * 1e3:.1f} training tokens/s ({tokens} tokens per step)",
        flush=True,
    )
    return {"flash_bwd": fused_c["flash_bwd"], "flash_bwd_dq": split_c["flash_bwd_dq"],
            "flash_bwd_dkv": split_c["flash_bwd_dkv"]}, params


class StopRun(Exception):
    """Raised from a run's ``log`` callback to end the run there."""


def run_config(config, out_dir, **overrides):
    """The phase-8 run's config: ``config`` with 2 warm-up steps, the
    ``split`` of RUN_SPLIT and ``out_dir``, then ``overrides``."""
    cfg = type(config)(config)
    cfg.num_warmup_steps = TRAIN_WARMUP
    cfg.split = RUN_SPLIT
    cfg.output_dir = str(out_dir)
    cfg.update(overrides)
    return cfg


def run_records(out_dir) -> list:
    with open(Path(out_dir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def step_records(out_dir) -> list:
    # val_step_total_loss is another key: test membership, not substrings
    return [r for r in run_records(out_dir) if "total_loss" in r]


def reset_launches() -> None:
    flash.launches = 0
    ff.launches = 0
    flash.bwd_launches.update(dict.fromkeys(flash.bwd_launches, 0))


def launches_now() -> dict:
    return {"flash_fwd": flash.launches, "geglu_ff": ff.launches, **flash.bwd_launches}


def final_params(out_dir) -> dict:
    return torch.load(Path(out_dir) / "model" / "model.pt", map_location="cpu",
                      weights_only=True)


def assert_finite_steps(recs: list, n: int) -> None:
    assert [r["step"] for r in recs] == list(range(1, n + 1)), [r["step"] for r in recs]
    for r in recs:
        assert "tokens_per_sec" in r and "epoch" in r, r
        for k in ("total_loss", "fcl_loss", "no-fcl_loss", "param_norm", "grad_norm"):
            assert math.isfinite(r[k]), (k, r)
        # a pair absent from every row of a batch is NaN by design
        assert not any(isinstance(v, float) and math.isinf(v) for v in r.values()), r


def optimizer_state_bytes(opt) -> int:
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for k, t in st.items() if k != "step" and torch.is_tensor(t))


def check_run(config, device, tmp: Path, rows: list, cpu_device="cpu") -> dict:
    """Phase 8, the training run (module docstring), on ``rows`` into
    ``tmp``; returns what it measured."""
    depth, bs = int(config.layers), int(config.batch_size)
    data = setup_data(rows, split=RUN_SPLIT, ds_seed=int(config.ds_seed))
    collate = MultimodalCollator(config.modality_config.to_plain())
    n_train, n_eval = len(data["train"]) // bs, len(data["test"]) // bs
    assert (n_train, n_eval) == (4, 1), (n_train, n_eval)
    batch = to_device(collate(data["train"][:bs]), device)

    # (a) the main path, with every launch count at 0 just before it
    flash.default_bwd_impl = "fused"
    stamps, epoch0 = [], {}

    def log_a(rec):
        if "total_loss" in rec:
            stamps.append(time.perf_counter())
        if "val_epoch_total_loss" in rec and not epoch0:
            epoch0.update(load_params(tmp / "a" / "0"))  # what this eval ran on

    cfg = run_config(config, tmp / "a", epochs=2, n_step_checkpoint=2,
                     checkpoint_keep=1, run_eval_loop=True)
    reset_launches()
    out = train(cfg, device=device.type, rows=rows, log=log_a)
    counts = launches_now()
    n_steps = 2 * n_train
    print(f"run (a): launches {counts}", flush=True)
    assert counts == {"flash_fwd": depth * (n_steps + 2 * n_eval), "geglu_ff": 0,
                      "flash_bwd": depth * n_steps, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}, counts
    steps = step_records(out)
    assert_finite_steps(steps, n_steps)
    assert [r["epoch"] for r in steps] == [0] * n_train + [1] * n_train
    evals = [r for r in run_records(out) if "val_epoch_total_loss" in r]
    assert len(evals) == 2 and [r["step"] for r in evals] == [n_train, n_steps], evals
    for r in evals:
        bad = {k: v for k, v in r.items() if k.startswith("val_epoch_") and not math.isfinite(v)}
        assert not bad, bad
    assert (Path(out) / "1" / "state").is_dir() and not (Path(out) / "0").exists()
    final = final_params(out)
    st = read_safetensors(Path(out) / "model.safetensors")
    assert st.keys() == final.keys(), st.keys() ^ final.keys()
    assert all(torch.equal(st[k], final[k]) for k in final)
    # the first eval again, in fp32 on the CPU from the epoch-0 weights
    cfg32 = run_config(config, tmp / "cpu", precision="fp32")
    model32 = build_trainer(cfg32, cpu_device, params=epoch0)[0]
    cpu_evals = []
    t0 = time.perf_counter()
    run_eval_epoch(model32, BatchedLoader(data["test"], collate, bs),
                   lambda rec, at: cpu_evals.append(rec), n_train, torch.device(cpu_device))
    cpu_eval_s = time.perf_counter() - t0
    del model32
    gpu_loss, cpu_loss = evals[0]["val_epoch_total_loss"], cpu_evals[-1]["val_epoch_total_loss"]
    eval_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    print(f"run (a): first eval val_epoch_total_loss bf16 GPU {gpu_loss:.6f}, fp32 CPU "
          f"{cpu_loss:.6f} (relative {eval_rel:.3e}; CPU eval {cpu_eval_s:.1f} s)", flush=True)
    assert eval_rel <= RUN_EVAL_RTOL, eval_rel
    # wall ms of each step but an epoch's first (the stamps are the
    # step records, each after the step's sync); with
    # n_step_checkpoint 2, steps 3 and 7 also hold a save's copy to
    # the host, and its write runs on a thread beside the next steps
    step_ms = {s: 1e3 * (stamps[s - 1] - stamps[s - 2])
               for s in range(1, n_steps + 1) if (s - 1) % n_train}

    # (b) restart on the split backward, deterministic algorithms on
    base = dict(epochs=2, n_step_checkpoint=0, checkpoint_keep=2, run_eval_loop=True)

    def stop_after_first_eval(rec):
        if "val_epoch_total_loss" in rec:
            raise StopRun

    def sigterm_at_step_2(rec):
        if rec["step"] == 2 and "total_loss" in rec:
            signal.raise_signal(signal.SIGTERM)

    old_cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    flash.default_bwd_impl = "split"
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight = train(run_config(config, tmp / "b0", **base), device.type, rows=rows)
            try:
                train(run_config(config, tmp / "b1", **base), device.type, rows=rows,
                      log=stop_after_first_eval)
                raise AssertionError("the run went on past epoch 0")
            except StopRun:
                pass
            restarted = train(run_config(config, tmp / "b2", restart=str(tmp / "b1" / "0"),
                                         **base), device.type, rows=rows)
            try:
                train(run_config(config, tmp / "b3", **base), device.type, rows=rows,
                      log=sigterm_at_step_2)
                raise AssertionError("SIGTERM did not stop the run")
            except PreemptedError as e:
                assert e.step == 2, e.step
            assert json.loads((tmp / "b3" / "preempted.json").read_text())["step"] == 2
            resumed = train(run_config(config, tmp / "b4", restart=str(tmp / "b3"), **base),
                            device.type, rows=rows)
    finally:
        torch.use_deterministic_algorithms(False)
        flash.default_bwd_impl = "fused"
        if old_cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old_cublas
    notes = sorted({str(w.message).split("\n")[0] for w in caught})
    print(f"run (b): warnings under deterministic algorithms: {notes or 'none'}", flush=True)
    ref = final_params(straight)
    ref_steps = {r["step"]: r["total_loss"] for r in step_records(straight)}
    for name, out_b, first in (("epoch restart", restarted, n_train + 1),
                               ("mid-epoch resume", resumed, 3)):
        got = step_records(out_b)
        assert [r["step"] for r in got] == list(range(first, n_steps + 1)), (name, got)
        loss_gap = max(abs(r["total_loss"] - ref_steps[r["step"]]) for r in got)
        p = final_params(out_b)
        equal = all(torch.equal(p[k], ref[k]) for k in ref)
        rel = rel_l2(torch.cat([p[k].reshape(-1) for k in ref]),
                     torch.cat([ref[k].reshape(-1) for k in ref]))
        print(f"run (b): {name}: final parameters bitwise equal {equal} (relative L2 "
              f"{rel:.3e}), per-step total_loss max gap {loss_gap:.3e}", flush=True)
        assert equal and loss_gap == 0.0, (name, rel, loss_gap)

    # (c) remat + grad_accum 2 + bf16 moments, one epoch
    reset_launches()
    out_c = train(run_config(config, tmp / "c", epochs=1, remat=True, grad_accum=2,
                             moment_dtype="bf16", run_eval_loop=False),
                  device.type, rows=rows)
    counts_c = launches_now()
    print(f"run (c): launches {counts_c}", flush=True)
    assert counts_c == {"flash_fwd": 2 * 2 * depth * n_train, "geglu_ff": 0,
                        "flash_bwd": 2 * depth * n_train, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0}, counts_c
    assert_finite_steps(step_records(out_c), n_train)
    moments = load_state(Path(out_c) / "0")["optimizer"]["state"]
    assert moments and all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.bfloat16
                           for s in moments.values())

    def first_step(cfg):
        model = build_trainer(cfg, device.type, params=final)[0]
        reset_launches()
        loss = float(forward_backward(model, batch)["total_loss"])
        return loss, {n: p.grad.float().cpu() for n, p in model.named_parameters()}, flash.launches

    plain_loss, plain_g, plain_k1 = first_step(run_config(config, tmp / "g"))
    remat_loss, remat_g, remat_k1 = first_step(run_config(config, tmp / "g", remat=True))
    assert (plain_k1, remat_k1) == (depth, 2 * depth), (plain_k1, remat_k1)
    remat_rel = rel_l2(torch.cat([remat_g[n].reshape(-1) for n in plain_g]),
                       torch.cat([plain_g[n].reshape(-1) for n in plain_g]))
    remat_attn = max(rel_l2(remat_g[n], plain_g[n]) for n in attention_leaves(plain_g))
    print(f"run (c): remat vs plain first step: loss {remat_loss:.6f} vs {plain_loss:.6f}, "
          f"gradient relative L2 {remat_rel:.3e}, attention projections at most "
          f"{remat_attn:.3e}", flush=True)
    assert remat_rel <= TRAIN_GRAD_REL_L2 and remat_attn <= TRAIN_ATTN_GRAD_REL_L2

    # (d) times and memory, outside the counted runs
    def step_memory(cfg):
        model, opt, sched = build_trainer(cfg, device.type, num_training_steps=8, params=final)
        train_step(model, opt, sched, batch, clip=float(cfg.clip))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        train_step(model, opt, sched, batch, clip=float(cfg.clip))
        torch.cuda.synchronize()
        return model, opt, sched, before, torch.cuda.max_memory_allocated(), \
            optimizer_state_bytes(opt)

    model, opt, sched, before, peak, opt32 = step_memory(run_config(config, tmp / "m"))
    eval_dl = BatchedLoader(data["test"], collate, bs)
    eval_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_eval_epoch(model, eval_dl, lambda rec, at: None, 0, device)  # ends in a copy
        eval_ms.append(1e3 * (time.perf_counter() - t0))
    saver = Checkpointer()
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "schedule": sched.state_dict(), "step": 1, "epoch": 0}
    save_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        saver.save_state(state, tmp / "s", asynchronous=False)
        save_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    saver.save_state(state, tmp / "s", asynchronous=True)
    async_return_ms = 1e3 * (time.perf_counter() - t0)
    saver.wait_for_saves()
    async_ms = 1e3 * (time.perf_counter() - t0)
    del model, opt, sched, state, saver
    torch.cuda.empty_cache()
    *_, before_r, peak_r, _ = step_memory(run_config(config, tmp / "m", remat=True))
    torch.cuda.empty_cache()
    *_, opt16 = step_memory(run_config(config, tmp / "m", moment_dtype="bf16"))
    torch.cuda.empty_cache()
    assert 2 * opt16 == opt32, (opt16, opt32)
    assert peak_r - before_r < peak - before, (peak_r - before_r, peak - before)
    mib = 2.0**-20
    print(host_description(), flush=True)
    print(
        f"run: wall ms per step inside the run "
        f"{', '.join(f'step {k} {x:.3f}' for k, x in step_ms.items())} (median "
        f"{float(np.median(list(step_ms.values()))):.3f}; of the steps that follow no "
        f"save {float(np.median([x for k, x in step_ms.items() if k % 4 != 3])):.3f}; "
        f"host clock, each step ends in a sync); last tokens_per_sec "
        f"{steps[-1]['tokens_per_sec']:.1f}; "
        f"eval pass ({n_eval} batch) ms {', '.join(f'{x:.3f}' for x in eval_ms)}; checkpoint save "
        f"ms synchronous {', '.join(f'{x:.3f}' for x in save_ms)} (the first allocates the "
        f"host buffers), asynchronous returns in {async_return_ms:.3f}, written in "
        f"{async_ms:.3f}",
        flush=True,
    )
    print(
        f"run: peak memory of a step (max_memory_allocated) {peak * mib:.1f} MiB without "
        f"remat ({(peak - before) * mib:.1f} above the {before * mib:.1f} held before it), "
        f"{peak_r * mib:.1f} MiB with remat ({(peak_r - before_r) * mib:.1f} above "
        f"{before_r * mib:.1f}); optimizer state {opt32 * mib:.1f} MiB with fp32 moments, "
        f"{opt16 * mib:.1f} MiB with bf16",
        flush=True,
    )
    return {"step_ms": step_ms, "eval_ms": eval_ms, "save_ms": save_ms}


def eval_data(config, rows: list) -> dict:
    """The splits ``infer`` reads from ``rows`` under ``config`` (phase 8's
    split; the config's ``ds_seed`` and ``predrop``)."""
    return setup_data(rows, split=RUN_SPLIT, ds_seed=int(config.ds_seed),
                      predrop=bool(config.predrop),
                      predrop_config=config.modality_config.to_plain())


def eval_loader(config, part) -> BatchedLoader:
    collate = MultimodalCollator(config.modality_config.to_plain(), labels=config.label_col)
    return BatchedLoader(part, collate, int(config.batch_size))


def read_eval_files(directory) -> dict:
    """The six files of an ``infer`` output directory."""
    return {f"{split}_{kind}": (infer_lib.load_label_file if kind == "labels"
                                else infer_lib.load_embedding_file)(
                os.path.join(directory, f"{split}_{kind}"))
            for split in ("train", "eval") for kind in ("embeddings", "masks", "labels")}


def check_eval_files(files: dict, config, data: dict, n_keys: int, cpu_eval: dict) -> float:
    """An ``infer`` output against the rows it read: ``n_keys`` finite
    embeddings a split (str, frozenset and ``fusion`` keys as the
    family has them), 4 train batches and 1 eval batch of rows, the
    rows' own labels and a presence mask per modality; the eval split's
    embeddings against ``cpu_eval`` (fp32 on the CPU from the same
    weights), relative L2 per key.  Returns the largest."""
    bs, dim = int(config.batch_size), int(config.hidden_size)
    names = sorted(config.modality_config)
    for split, part, n in (("train", data["train"], 4 * bs), ("eval", data["test"], bs)):
        emb, msk = files[f"{split}_embeddings"], files[f"{split}_masks"]
        assert len(emb) == n_keys, (split, sorted(emb, key=str))
        for k, e in emb.items():
            assert isinstance(k, (str, frozenset)), k
            assert e.shape == (n, dim) and e.dtype == np.float32 and np.isfinite(e).all(), k
        assert sorted(msk) == names and all(m.shape == (n,) and m.dtype == bool
                                            for m in msk.values())
        field = "data" if "data" in part[0][config.label_col] else "values"  # CMU's, TCGA's
        want = np.stack([np.asarray(r[config.label_col][field]) for r in part[:n]])
        np.testing.assert_array_equal(files[f"{split}_labels"], want)
    emb32, msk32 = cpu_eval
    assert list(emb32) == list(files["eval_embeddings"])
    for k in names:
        np.testing.assert_array_equal(files["eval_masks"][k], msk32[k])
    return max(float(np.linalg.norm(files["eval_embeddings"][k] - e)
                     / np.linalg.norm(e)) for k, e in emb32.items())


def cpu_eval_split(config, restart, data, cpu_device) -> tuple:
    """The eval split through the model in fp32 on the CPU (the plain
    versions of the kernels), from ``restart``'s weights."""
    cfg32 = type(config)(config)
    cfg32.precision, cfg32.restart = "fp32", str(restart)
    model = infer_lib.build_inference_model(cfg32, cpu_device)
    emb, msk, _, _ = infer_lib.infer_split(
        model, eval_loader(config, data["test"]), config.label_col, torch.device(cpu_device))
    return emb, msk


def time_infer(config, restart, data, device, tmp: Path) -> dict:
    """Wall ms and rows/s of an ``infer`` batch over the train split
    (loader, forward and the split's one copy to the host, warm), the
    device's busy ms a batch (torch.profiler, another pass), and the ms
    to write the split's three files."""
    cfg = type(config)(config)
    cfg.restart = str(restart)
    model = infer_lib.build_inference_model(cfg, device.type)
    loader = eval_loader(config, data["train"])
    infer_lib.infer_split(model, loader, config.label_col, device)
    t0 = time.perf_counter()
    emb, msk, labels, losses = infer_lib.infer_split(model, loader, config.label_col, device)
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        infer_lib.infer_split(model, loader, config.label_col, device)
    busy_ms = sum(ev.device_time_total for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    infer_lib._save(msk, str(tmp / "train_masks"))
    infer_lib._save(emb, str(tmp / "train_embeddings"))
    infer_lib._save_array(labels, str(tmp / "train_labels"))
    write_ms = 1e3 * (time.perf_counter() - t0)
    n = len(losses)
    return {"wall_ms": 1e3 * wall / n, "rows_s": n * int(config.batch_size) / wall,
            "device_ms": busy_ms / n, "write_ms": write_ms}


def family_shapes(cfg) -> dict:
    """``{T: modality lengths}``, one entry for each sequence length at
    which ``cfg``'s infer runs K1 (and K5, on batch x T rows): EAO's
    passes, one per modality and one per combo of ``fusion_combos``,
    unmasked; else the one masked sequence with its fusion tokens."""
    mods = cfg.modality_config.to_plain()
    dims = [int(mods[m]["pad_len"]) for m in cfg.encoder_configs]
    if not cfg.eao:
        t = build_masks(dims, int(cfg.num_fusion_tokens), list(cfg.fusion_combos),
                        zorro=bool(cfg.zorro), fcl=bool(cfg.fcl)).seq_len
        return {t: tuple(dims)}
    channels = [(i,) for i in range(len(dims))] + [
        tuple(sorted(c)) for c in adjusted_powerset(range(len(dims)), list(cfg.fusion_combos))]
    shapes: dict = {}
    for ch in channels:
        shapes.setdefault(sum(dims[i] for i in ch), tuple(dims[i] for i in ch))
    return dict(sorted(shapes.items()))


def check_family_kernels(name: str, cfg, device) -> None:
    """K1 and K5 against their plain versions, each with its planted
    fault, at every shape ``cfg``'s infer gives them (phase 9 (b)): K1
    with ``cfg``'s mask and key padding as flash_inputs makes it (EAO's
    passes unmasked), K5 on batch x T rows."""
    bs = int(cfg.batch_size)
    for t, dims in family_shapes(cfg).items():
        mask, q, k, v, pad = flash_inputs(
            device, b=bs, h=int(cfg.heads), dims=dims, fusion=int(cfg.num_fusion_tokens),
            masked=not cfg.eao, combos=tuple(cfg.fusion_combos), zorro=bool(cfg.zorro))
        assert q.shape[2] == t, (q.shape, t)
        held = hold_flash(mask, q, k, v, pad)
        qi, kj, n_live, flagged = held["planted"]
        del mask, q, k, v, pad
        held_ff = hold_ff(*ff_inputs(device, bs * t))
        chunk, ff_flagged = held_ff["planted"]
        print(f"eval (b): {name} T {t} ({'unmasked' if cfg.eao else 'masked'}): K1 "
              f"max_abs_err {held['err']:.3e} (lse {held['lse_err']:.3e}), planted fault "
              f"(tile q{qi} x kv{kj}, {n_live} live entries, dropped) puts {flagged} "
              f"entries outside tolerance; K5 on {bs * t} rows max_abs_err "
              f"{held_ff['err']:.3e}, planted fault (W2 rows of inner chunk {chunk} "
              f"zeroed) puts {ff_flagged} entries outside tolerance", flush=True)
        del held, held_ff


def check_cmu_kernels(cfg, device) -> None:
    """Phase 10 (a): K1, K2, K3a and K3b against their plain versions
    under CMU_config1's mask (T 2538, combos [4, 3, 2], segment
    boundaries inside tiles), ragged key padding and a sample missing a
    modality, K3a's dq bitwise equal over two runs; K5 on 8 x T rows.
    Each with its planted faults (a dropped partial tile, the second kv
    tile of a pair item, a zeroed W2 chunk)."""
    mods = cfg.modality_config.to_plain()
    dims = tuple(int(mods[m]["pad_len"]) for m in cfg.encoder_configs)
    mask, q, k, v, pad = flash_inputs(
        device, b=int(cfg.batch_size), h=int(cfg.heads), dims=dims,
        fusion=int(cfg.num_fusion_tokens), combos=tuple(cfg.fusion_combos))
    t = q.shape[2]
    held = hold_flash(mask, q, k, v, pad)
    qi, kj, n_live, flagged = held["planted"]
    print(f"cmu (a): T {t}: K1 max_abs_err {held['err']:.3e} (lse {held['lse_err']:.3e}), "
          f"planted fault (tile q{qi} x kv{kj}, {n_live} live entries, dropped) puts "
          f"{flagged} entries outside tolerance", flush=True)
    del held
    g = torch.Generator(device=device).manual_seed(1)
    do = torch.randn(q.shape, generator=g, device=device).to(torch.bfloat16)
    bwd = hold_flash_bwd(mask, q, k, v, pad, do, f"cmu (a) T {t}", determinism=True)
    print(f"cmu (a): T {t}: backward max abs err "
          + ", ".join(f"{i} {n} {e:.3e}" for (i, n), e in bwd["errs"].items())
          + f"; fused vs split relative L2 {bwd['route_rel']:.3e}; planted faults' smallest "
          f"relative L2 {min(min(f[3]) for f in bwd['planted'].values()):.3e}", flush=True)
    del bwd, q, k, v, do
    held_ff = hold_ff(*ff_inputs(device, int(cfg.batch_size) * t))
    chunk, ff_flagged = held_ff["planted"]
    print(f"cmu (a): K5 on {int(cfg.batch_size) * t} rows max_abs_err {held_ff['err']:.3e}, "
          f"planted fault (W2 rows of inner chunk {chunk} zeroed) puts {ff_flagged} "
          f"entries outside tolerance", flush=True)


def check_eao_bwd_kernels(cfg, device) -> None:
    """Phase 11 (a): K2, K3a and K3b against the plain backward, unmasked,
    at each of EAO's pass lengths (``family_shapes``), with ragged key
    padding (sample 0 at full length, so that the last tile has live
    keys) and a sample without the modality; the planted faults of
    :func:`planted_bwd_faults` (a dropped tile, a pair's second half and,
    at an odd tile count, a tile of each lone half); K3a's dq bitwise
    equal over two runs at the longest pass."""
    shapes = family_shapes(cfg)
    longest = max(shapes)
    for t, dims in shapes.items():
        _, q, k, v, pad = flash_inputs(device, b=int(cfg.batch_size), h=int(cfg.heads),
                                       dims=dims, masked=False, full_rows=(0,))
        g = torch.Generator(device=device).manual_seed(t)
        do = torch.randn(q.shape, generator=g, device=device).to(torch.bfloat16)
        nt = -(-t // flash.BLOCK)
        bwd = hold_flash_bwd(None, q, k, v, pad, do, f"eao (a) T {t}",
                             determinism=t == longest)
        print(f"eao (a): T {t} ({nt} tiles, {t - (nt - 1) * flash.BLOCK} live rows in the "
              f"last): backward max abs err "
              + ", ".join(f"{i} {n} {e:.3e}" for (i, n), e in bwd["errs"].items())
              + f"; relative L2 at most {max(bwd['rels'].values()):.3e}; fused vs split "
              f"{bwd['route_rel']:.3e}; planted faults "
              + ", ".join(f"{name} (q{f[0]} x kv{f[1]}) {min(f[3]):.3e}"
                          for name, f in bwd["planted"].items()), flush=True)
        del bwd, q, k, v, do, pad


def probe_run(emb_dir, out_dir, device: str, **overrides) -> tuple:
    """``probe`` with configs/tcga_probe.yaml's settings on ``emb_dir``;
    returns ``(final record, epoch records, seconds, last epoch's
    logits and labels)``, the last as the loop handed them to
    ``probe._record``: ``train_logits``, ``train_y`` (rows in the loop's
    own order), ``eval_logits``, ``eval_y``."""
    cfg = embedding_eval_config(str(PROBE_CONFIG), make_output_dir=False)
    cfg.embedding_dir, cfg.output_dir = str(emb_dir), str(out_dir)
    cfg.update(overrides)
    last = {}
    real = probe_lib._record

    def record(*args):
        last.update(zip(("train_logits", "train_y", "eval_logits", "eval_y"),
                        (np.array(a, np.float64) for a in args[-4:])))
        return real(*args)

    t0 = time.perf_counter()
    with mock.patch.object(probe_lib, "_record", record):
        final = probe_lib.probe(cfg, device=device)
    seconds = time.perf_counter() - t0
    recs = [r for r in run_records(out_dir) if "train_loss" in r]
    assert [r["step"] for r in recs] == list(range(int(cfg.epochs))), len(recs)
    return final, recs, seconds, last


def rank_shares(logits: np.ndarray, y: np.ndarray) -> dict:
    """What one pair or one prediction moves a split's rank metrics by:
    AUROC 1 / (positive x negative entries), F1 the largest change that
    one entry's prediction flipping makes from the split's counts."""
    cm = binary_metrics(logits, y)["cm"]
    (tn, fp), (fn, tp) = (int(x) for x in cm[0]), (int(x) for x in cm[1])

    def f1(tp, fp, fn):
        return 2 * tp / max(2 * tp + fp + fn, 1)

    flips = [c for c, ok in (((tp - 1, fp, fn + 1), tp), ((tp + 1, fp, fn - 1), fn),
                             ((tp, fp - 1, fn), fp), ((tp, fp + 1, fn), tn)) if ok]
    n_pos = int((y == 1).sum())
    return {"auroc": 1.0 / (n_pos * (y.size - n_pos)),
            "f1": max(abs(f1(*c) - f1(tp, fp, fn)) for c in flips)}


def rank_gap_ok(dev: float, host: float, share: float) -> bool:
    return abs(dev - host) <= share * (1 + 1e-9)


def aligned_logits(host: dict, dev: dict) -> tuple:
    """The two loops' last-epoch train rows matched by their logits (each
    device row to the host row nearest it, which must make a
    permutation): ``(rows whose labels disagree, largest logit gap over
    the train and eval rows, relative to the largest logit)``."""
    lh, ld = host["train_logits"], dev["train_logits"]
    lh, ld = lh.reshape(len(lh), -1), ld.reshape(len(ld), -1)
    match = ((ld[:, None, :] - lh[None, :, :]) ** 2).sum(-1).argmin(axis=1)
    assert sorted(match.tolist()) == list(range(len(lh))), "rows do not pair up"
    yh = host["train_y"].reshape(len(lh), -1)
    yd = dev["train_y"].reshape(len(ld), -1)
    wrong = int((yd != yh[match]).any(axis=1).sum())
    scale = max(np.abs(lh).max(), np.abs(host["eval_logits"]).max())
    gap = max(np.abs(ld - lh[match]).max(),
              np.abs(dev["eval_logits"] - host["eval_logits"]).max()) / scale
    return wrong, float(gap)


def check_probe_loops(host: dict, dev: dict, host_last: dict, dev_last: dict) -> float:
    """Phase 9 (c)'s gate on the two loops' final records and last-epoch
    rows (``PROBE_LOOPS_RTOL``, ``PROBE_RANK_KEYS``), with its planted
    fault: the device loop's train labels rolled by one row must fail
    the row check.  Returns the largest relative gap of the other keys."""
    gaps = {k: abs(dev[k] - host[k]) / max(abs(host[k]), 1e-6)
            for k in ("train_loss", "eval_loss", "param_norm", "grad_norm")}
    shares = {"train": rank_shares(host_last["train_logits"], host_last["train_y"]),
              "eval": rank_shares(host_last["eval_logits"], host_last["eval_y"])}
    rank = {k: (dev[k], host[k], shares[k.split("_")[0]][k.split("_")[1]])
            for k in PROBE_RANK_KEYS}
    wrong, logit_gap = aligned_logits(host_last, dev_last)
    rolled = dict(dev_last, train_y=np.roll(dev_last["train_y"], 1, axis=0))
    planted = aligned_logits(host_last, rolled)[0]
    print(f"eval (c): probe final records, device vs host loop, relative gap by key: "
          f"{', '.join(f'{k} {dev[k]!r} vs {host[k]!r} ({x:.3e})' for k, x in gaps.items())}; "
          f"rank metrics, absolute gap against one pair's or prediction's share: "
          f"{', '.join(f'{k} {d!r} vs {h!r} ({abs(d - h):.3e} vs {sh:.3e})' for k, (d, h, sh) in rank.items())}; "
          f"last-epoch logits, train rows matched by value: {wrong} rows with other labels, "
          f"largest gap {logit_gap:.3e} of the largest logit; planted fault (device labels "
          f"rolled by one row) leaves {planted} rows with other labels", flush=True)
    assert max(gaps.values()) <= PROBE_LOOPS_RTOL, gaps
    assert all(rank_gap_ok(*r) for r in rank.values()), rank
    assert wrong == 0 and logit_gap <= PROBE_LOOPS_RTOL, (wrong, logit_gap)
    assert planted > 0, "planted fault passes: the device loop's labels rolled by one row"
    # the reading the relative bound refused: 1/4096 apart at 4096 pairs
    assert rank_gap_ok(2702 / 4096, 2701 / 4096, 1 / 4096)
    return max(gaps.values())


def check_eval(config, device, tmp: Path, rows: list, cpu_device="cpu") -> dict:
    """Phase 9, the evaluation path (module docstring), on phase 8's rows
    and run directory; returns K1's and K5's launches on its main path."""
    depth, bs = int(config.layers), int(config.batch_size)
    no_bwd = dict.fromkeys(flash.bwd_launches, 0)

    # (a) MCA infer from phase 8's final model (a directory that holds
    # model/ alone: a state/ beside it would be read first)
    model_dir = tmp / "eval_model"
    shutil.copytree(tmp / "a" / "model", model_dir / "model")
    data = eval_data(config, rows)
    reset_launches()
    infer_lib.infer(run_config(config, tmp / "i_mca", restart=str(model_dir)), device.type,
                    rows=rows)
    counts = launches_now()
    print(f"eval (a): MCA infer launches {counts}", flush=True)
    assert counts == {"flash_fwd": 5 * depth, "geglu_ff": 5 * depth, **no_bwd}, counts
    total = {"flash_fwd": counts["flash_fwd"], "geglu_ff": counts["geglu_ff"]}
    files = read_eval_files(tmp / "i_mca")
    rel = check_eval_files(files, config, data, 4 + 11 + 1,
                           cpu_eval_split(config, model_dir, data, cpu_device))
    print(f"eval (a): MCA embeddings bf16 GPU vs fp32 CPU relative L2 {rel:.3e}", flush=True)
    assert rel <= SLICE_REL_L2, rel
    # the same weights from the epoch-1 train state
    infer_lib.infer(run_config(config, tmp / "i_mca_state", restart=str(tmp / "a" / "1")),
                    device.type, rows=rows)
    again = read_eval_files(tmp / "i_mca_state")
    for name in ("train_embeddings", "eval_embeddings"):
        assert list(again[name]) == list(files[name])
        assert all(np.array_equal(again[name][k], files[name][k]) for k in files[name]), name
    print("eval (a): infer from 1/ (a train state) and from model/ bitwise equal", flush=True)
    times = {"mca": time_infer(run_config(config, tmp / "t"), model_dir, data, device,
                               tmp / "t_mca")}

    # (b) MMA/Zorro and EAO at full width, weights from seed 0
    for name, path in EVAL_CONFIGS.items():
        cfg = training_config(str(path))
        model = build_model(get_model_config(cfg)).init_weights(torch.Generator().manual_seed(0))
        weights = tmp / f"{name}_weights"
        save_params(model.state_dict(), str(weights))
        del model
        passes = 4 + 6 if cfg.eao else 1
        data_b = eval_data(cfg, rows)
        reset_launches()
        infer_lib.infer(run_config(cfg, tmp / f"i_{name}", restart=str(weights)), device.type,
                        rows=rows)
        counts = launches_now()
        print(f"eval (b): {name} infer launches {counts}", flush=True)
        want = 5 * passes * int(cfg.layers)
        assert counts == {"flash_fwd": want, "geglu_ff": want, **no_bwd}, counts
        for k in total:
            total[k] += counts[k]
        t0 = time.perf_counter()
        rel = check_eval_files(read_eval_files(tmp / f"i_{name}"), cfg, data_b,
                               4 + 6 if cfg.eao else 4 + 1,
                               cpu_eval_split(cfg, weights, data_b, cpu_device))
        print(f"eval (b): {name} embeddings bf16 GPU vs fp32 CPU relative L2 {rel:.3e} "
              f"(CPU eval {time.perf_counter() - t0:.1f} s)", flush=True)
        assert rel <= SLICE_REL_L2, rel
        times[name] = time_infer(run_config(cfg, tmp / "t"), weights, data_b, device,
                                 tmp / f"t_{name}")
        check_family_kernels(name, cfg, device)

    # (c) the probe on (a)'s files: the two loops, the card against the CPU
    host, host_recs, host_s, host_last = probe_run(tmp / "i_mca", tmp / "p_host", device.type)
    dev, _, dev_s, dev_last = probe_run(tmp / "i_mca", tmp / "p_dev", device.type,
                                        scan_epochs=True, scan_epochs_chunk=256)
    cpu, cpu_recs, cpu_s, _ = probe_run(tmp / "i_mca", tmp / "p_cpu", cpu_device)
    loops = check_probe_loops(host, dev, host_last, dev_last)
    vs_cpu = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(host_recs, cpu_recs)
                 for k in ("train_loss", "eval_loss", "param_norm"))
    print(f"eval (c): probe final records, device vs host loop: relative gap {loops:.3e}; "
          f"host loop card vs CPU, every epoch's train_loss, eval_loss, param_norm: "
          f"{vs_cpu:.3e}; final eval_auroc {host['eval_auroc']:.4f}", flush=True)
    assert vs_cpu <= PROBE_CPU_RTOL, vs_cpu
    eao, _, eao_s, _ = probe_run(tmp / "i_eao", tmp / "p_eao", device.type,
                                 embedding_key="combo:0,1")
    bad = {k: v for k, v in eao.items() if isinstance(v, float) and not math.isfinite(v)}
    assert not bad, bad
    print(f"eval (c): EAO probe on combo:0,1: final eval_auroc {eao['eval_auroc']:.4f}, "
          f"train_loss {eao['train_loss']:.6f}", flush=True)

    # (d) times
    epochs = len(host_recs)
    for name, t in times.items():
        print(f"eval (d): {name} infer batch of {bs}: {t['wall_ms']:.3f} ms wall "
              f"({t['rows_s']:.1f} rows/s), {t['device_ms']:.3f} ms device busy "
              f"(torch.profiler); writing the train split's files {t['write_ms']:.3f} ms",
              flush=True)
    print(f"eval (d): probe ms per epoch ({epochs} epochs, 32 rows, full batch): host loop "
          f"{1e3 * host_s / epochs:.3f} on the card, {1e3 * cpu_s / epochs:.3f} on the CPU; "
          f"device loop {1e3 * dev_s / epochs:.3f}; EAO host loop {1e3 * eao_s / epochs:.3f}",
          flush=True)
    return total


def staged_step_losses(config, device, params, rows) -> dict:
    """One step from ``params`` on ``rows`` staged at fp32 and at bf16
    (``narrow_for_staging`` on the host, fp32 again on the device):
    ``{stage: (total_loss, bytes copied)}``."""
    collated = MultimodalCollator(config.modality_config.to_plain())(rows)
    sentinels = staging_sentinels(config)
    out = {}
    for stage in ("fp32", "bf16"):
        model, opt, sched = build_trainer(config, device.type, num_training_steps=2,
                                          params=params)
        staged = narrow_for_staging(collated, stage, sentinels)
        n_bytes = sum(torch.as_tensor(v).nbytes for f in staged.values() for v in f.values())
        loss = train_step(model, opt, sched, to_device(staged, device),
                          clip=float(config.clip))["total_loss"]
        out[stage] = (loss, int(n_bytes))
        del model, opt, sched
    return out


def device_busy_ms(fn, iters: int = PROFILED_STEPS) -> dict:
    """Wall ms a call of ``fn`` (host clock, synchronised, after a warm-up
    call) and the device's busy ms a call under torch.profiler (another
    window of ``iters``): the device's share of the wall; and the
    ``TOP_KERNELS`` kernels that took the most device ms a call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", "#" in ev.name)):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total / 1e3 / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {"wall_ms": wall_ms, "device_ms": sum(by_name.values()), "top": top}


def profiled_steps(config, device, params, rows, steps=PROFILED_STEPS) -> dict:
    """:func:`device_busy_ms` of a fused-backward training step."""
    model, opt, sched = build_trainer(config, device.type, num_training_steps=3 * steps,
                                      params=params)
    batch = to_device(MultimodalCollator(config.modality_config.to_plain())(rows), device)
    return device_busy_ms(lambda: train_step(model, opt, sched, batch, clip=float(config.clip)),
                          steps)


def check_cmu(device, tmp: Path, cpu_device="cpu") -> dict:
    """Phase 10, CMU_config1 at full width (module docstring); returns
    the launches of its main paths: K1 and K5 from serving and infer,
    K2 / K3a / K3b from training."""
    cfg = training_config(str(CMU_CONFIG))
    depth, bs = int(cfg.layers), int(cfg.batch_size)
    t0 = time.perf_counter()
    check_cmu_kernels(cfg, device)  # (a)
    print(f"cmu (a): {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    served = check_slice(cfg, device, label="cmu (b) serve")  # counts from 0
    print(f"cmu (b): {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    trained, _ = check_train(shallow(cfg), device, label="cmu (c) train")
    params = seed_model(cfg).state_dict()
    rows = synthetic_rows(cfg, RUN_ROWS, seed=0)
    staged = staged_step_losses(cfg, device, params, rows[:bs])
    (loss32, bytes32), (loss16, bytes16) = staged["fp32"], staged["bf16"]
    staged_rel = abs(loss16 - loss32) / abs(loss32)
    print(f"cmu (c): one step staged fp32: total_loss {loss32:.6f}, {bytes32} bytes copied a "
          f"batch; staged bf16: total_loss {loss16:.6f} (relative {staged_rel:.3e}), "
          f"{bytes16} bytes", flush=True)
    # the inputs rounded to bf16 (8 significant bits) move an average of
    # log-softmax terms by well under 1%, as bf16 activations do
    assert math.isfinite(loss16) and staged_rel <= TRAIN_LOSS_RTOL, (loss32, loss16)
    assert bytes16 < 0.55 * bytes32, (bytes16, bytes32)
    print(f"cmu (c): {time.perf_counter() - t1:.1f} s", flush=True)

    # (d) infer over 40 rows (4 train, 1 eval batch) from the seed-0 weights
    t1 = time.perf_counter()
    weights = tmp / "cmu_weights"
    save_params(params, str(weights))
    data = eval_data(cfg, rows)
    reset_launches()
    infer_lib.infer(run_config(cfg, tmp / "i_cmu", restart=str(weights)), device.type, rows=rows)
    inferred = launches_now()
    print(f"cmu (d): infer launches {inferred}", flush=True)
    assert inferred == {"flash_fwd": 5 * depth, "geglu_ff": 5 * depth,
                        **dict.fromkeys(flash.bwd_launches, 0)}, inferred
    rel = check_eval_files(read_eval_files(tmp / "i_cmu"), cfg, data, 4 + 11 + 1,
                           cpu_eval_split(cfg, weights, data, cpu_device))
    labels = read_eval_files(tmp / "i_cmu")["eval_labels"]
    assert labels.shape == (bs, 7), labels.shape
    print(f"cmu (d): embeddings bf16 GPU vs fp32 CPU relative L2 {rel:.3e}; "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    assert rel <= SLICE_REL_L2, rel
    t_inf = time_infer(run_config(cfg, tmp / "t"), weights, data, device, tmp / "t_cmu")

    # (e) the host's side of a batch, and the device against the wall
    host = host_batch_costs(cfg, rows[:bs], device)
    prof = profiled_steps(cfg, device, params, rows[:bs])
    print(host_description(), flush=True)
    print(f"cmu (e): host ms a batch of {bs}: collate {host['collate_ms']:.3f}; "
          + "; ".join(f"{sd} staging: narrow {host[sd]['narrow_ms']:.3f}, host-to-device "
                      f"{host[sd]['copy_ms']:.3f} ({host[sd]['bytes']} bytes)"
                      for sd in ("fp32", "bf16"))
          + f"; training step (fused) {prof['wall_ms']:.3f} ms wall, {prof['device_ms']:.3f} "
          f"ms device busy under torch.profiler (busy share "
          f"{prof['device_ms'] / prof['wall_ms']:.3f}); infer batch {t_inf['wall_ms']:.3f} ms "
          f"wall ({t_inf['rows_s']:.1f} rows/s), {t_inf['device_ms']:.3f} ms device busy",
          flush=True)
    check_host_staging(cfg, device, params, rows)
    print(f"cmu: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"flash_fwd": served["flash_fwd"] + inferred["flash_fwd"],
            "geglu_ff": served["geglu_ff"] + inferred["geglu_ff"], **trained}


def shallow(config):
    """``config`` at ``CHECK_DEPTH`` blocks: phases 10 (c) and 11 (b)
    hold their steps to fp32 on the CPU, which at full depth took 124 and
    89 s of the script's 1200 (PR 16)."""
    cfg = type(config)(config)
    cfg.layers = CHECK_DEPTH
    return cfg


def check_eao_train(device, cpu_device="cpu") -> dict:
    """Phase 11, the EAO training step (module docstring); returns its
    main path's backward launches."""
    cfg = training_config(str(EAO_CONFIG))
    t0 = time.perf_counter()
    check_eao_bwd_kernels(cfg, device)  # (a)
    print(f"eao (a): {time.perf_counter() - t0:.1f} s", flush=True)
    trained, _ = check_train(shallow(cfg), device, cpu_device, label="eao (b) train")
    prof = profiled_steps(cfg, device, seed_model(cfg).state_dict(),
                          synthetic_rows(cfg, int(cfg.batch_size)))
    print(f"eao (b): training step (fused) {prof['wall_ms']:.3f} ms wall, "
          f"{prof['device_ms']:.3f} ms device busy under torch.profiler (busy share "
          f"{prof['device_ms'] / prof['wall_ms']:.3f})", flush=True)
    print(f"eao: {time.perf_counter() - t0:.1f} s", flush=True)
    return trained


def plain_collate():
    """The collators through the numpy plain versions of the C++ collate
    inside the ``with`` block."""
    return mock.patch.multiple(native, pad_rows=native.pad_rows_plain,
                               pad_rows_fill=native.pad_rows_fill_plain,
                               pad_seq2d=native.pad_seq2d_plain)


def collate_arms(cfg, rows) -> tuple:
    """One batch of ``rows`` through ``cfg``'s collator, by the C++
    collate and by its numpy plain versions: held bitwise equal, then
    timed in turns (host ms, median of 5).  Returns the C++ batch and the
    times of each arm."""
    collate = MultimodalCollator(cfg.modality_config.to_plain())
    native_batch = collate(rows)
    with plain_collate():
        plain_batch = collate(rows)
    for m, fields in plain_batch.items():
        assert native_batch[m].keys() == fields.keys(), m
        for k, v in fields.items():
            got = native_batch[m][k]
            assert got.dtype == v.dtype and got.shape == v.shape, (m, k)
            assert got.tobytes() == v.tobytes(), (m, k)  # bit for bit
    collate_ms = {"c++": [], "numpy": []}
    for arm in ("c++", "numpy", "numpy", "c++"):
        with plain_collate() if arm == "numpy" else contextlib.nullcontext():
            collate_ms[arm].append(median_host_ms(lambda: collate(rows), torch.cuda.synchronize))
    return native_batch, collate_ms


def check_host_staging(cfg, device, params, rows) -> None:
    """Phase 10 (e), the host's side of a CMU batch, each pair of arms in
    turns in this call: the C++ collate against its numpy plain versions
    (the batches bitwise equal), on the CMU batch and on a TCGA_config1
    batch; a pageable blocking copy (``to_device``) against a pinned
    non-blocking one, with the pinning and without it; and a fused step's
    wall over an epoch of ``rows`` with ``prefetch_batches`` 0 and 1."""
    bs = int(cfg.batch_size)
    collate = MultimodalCollator(cfg.modality_config.to_plain())
    native_batch, collate_ms = collate_arms(cfg, rows[:bs])
    tcga_cfg = training_config(str(CONFIG))
    tcga_bs = int(tcga_cfg.batch_size)
    _, tcga_ms = collate_arms(tcga_cfg, synthetic_rows(tcga_cfg, tcga_bs))
    sync = torch.cuda.synchronize

    def pinned(batch):
        return {m: {k: torch.from_numpy(v).pin_memory() for k, v in f.items()}
                for m, f in batch.items()}

    def copy_async(batch):
        return {m: {k: t.to(device, non_blocking=True) for k, t in f.items()}
                for m, f in batch.items()}

    # the collator wrote into pinned blocks (CUDA is initialised): numpy's own copy is pageable
    pageable = {m: {k: np.array(v) for k, v in f.items()} for m, f in native_batch.items()}
    held = pinned(pageable)
    n_bytes = sum(v.nbytes for f in native_batch.values() for v in f.values())
    copy_ms = {"pageable": [], "pin + async": [], "pinned async": []}
    arms = {"pageable": lambda: to_device(pageable, device),
            "pin + async": lambda: copy_async(pinned(pageable)),
            "pinned async": lambda: copy_async(held)}
    for arm in (*arms, *reversed(arms)):
        copy_ms[arm].append(median_host_ms(arms[arm], sync))

    model, opt, sched = build_trainer(cfg, device.type, num_training_steps=100, params=params)
    clip = float(cfg.clip)

    def epoch_ms(prefetch: int) -> float:
        loader = BatchedLoader(rows, collate, bs, prefetch=prefetch)
        sync()
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            train_step(model, opt, sched, to_device(batch, device), clip=clip)
            n += 1
        return (time.perf_counter() - t0) * 1e3 / n

    epoch_ms(0)  # warm-up
    step_ms = {0: [], 1: []}
    for prefetch in (0, 1, 1, 0):
        step_ms[prefetch].append(epoch_ms(prefetch))
    del model, opt, sched

    def each(xs):
        return ", ".join(f"{x:.3f}" for x in xs)

    print(host_description(), flush=True)
    print(f"cmu (e): collate a batch of {bs} (ms, median of 5, arms in turns): C++ "
          f"{each(collate_ms['c++'])}, numpy {each(collate_ms['numpy'])} (bitwise equal); "
          f"TCGA_config1's batch of {tcga_bs}: C++ {each(tcga_ms['c++'])}, numpy "
          f"{each(tcga_ms['numpy'])} (bitwise equal); host-to-device copy of {n_bytes} bytes: "
          + "; ".join(f"{arm} {each(v)}" for arm, v in copy_ms.items())
          + f"; fused step wall over an epoch of {len(rows) // bs} batches (ms a step), "
          f"prefetch_batches 0: {each(step_ms[0])}, 1: {each(step_ms[1])}", flush=True)


def moe_config():
    """Phase 12's configuration: TCGA_config1 (``configs/tcga_mca.yaml``)
    with ``moe_experts`` and ``moe_capacity_factor`` set here."""
    cfg = training_config(str(CONFIG))
    cfg.moe_experts = MOE_EXPERTS
    cfg.moe_capacity_factor = MOE_CF
    return cfg


def onehot_forward(self, x, padding_mask=None):
    """``MoEFeedForward.forward`` through one-hot dispatch and combine
    products (the JAX package's default arm, ``mca_tpu/models/moe.py``)
    in place of the port's gather and ``index_add``: phase 12's plain
    reference for the port's dispatch and combine, patched over the
    class's ``forward`` in (c) and (d)."""
    B, T, D = x.shape
    E = self.num_experts
    C = expert_capacity(T, E, self.capacity_factor)
    scores = torch.softmax(x.float() @ self.router["weight"], dim=-1)
    if padding_mask is not None:
        scores = scores.masked_fill(padding_mask[..., None].bool(), 0.0)
    gates, token_idx = moe.route(scores, C)
    if self.record is not None:
        self.record.append({"token_idx": token_idx.detach()})
    compute = self.dtype
    dispatch = torch.zeros(B, E, C, T, dtype=compute, device=x.device).scatter_(
        -1, token_idx[..., None], 1.0)  # one-hot [B, E, C, T]
    xe = torch.einsum("bect,btd->becd", dispatch, x.to(compute))
    h, gate = torch.einsum("becd,edf->becf", xe, self.experts["w_in"].to(compute)).chunk(2, -1)
    out = torch.einsum("becf,efd->becd", torch.nn.functional.gelu(gate) * h,
                       self.experts["w_out"].to(compute))
    return torch.einsum("bect,becd->btd", dispatch, gates.to(compute)[..., None] * out)


def onehot_arm():
    """Every ``MoEFeedForward`` through ``onehot_forward`` inside the
    ``with`` block."""
    return mock.patch.object(MoEFeedForward, "forward", onehot_forward)


def planted_gates():
    """The port's routing with expert 0's gates scaled by
    PLANTED_GATE_SCALE inside the ``with`` block (a planted combine
    fault)."""
    real = moe.route

    def route(scores, capacity):
        gates, token_idx = real(scores, capacity)
        return gates * torch.tensor([PLANTED_GATE_SCALE] + [1.0] * (gates.shape[1] - 1),
                                    device=gates.device)[:, None], token_idx

    return mock.patch.object(moe, "route", route)


def routed(mod, x, pad):
    """``mod``'s output (fp32) and its choices ``[B, E, T]`` (True where
    expert e took token t)."""
    mod.record = []
    with torch.no_grad():
        y = mod(x, pad).float()
    idx, mod.record = mod.record[0]["token_idx"], None
    chosen = torch.zeros(*idx.shape[:2], x.shape[1], dtype=torch.bool, device=x.device)
    return y, chosen.scatter_(2, idx, True)


def check_moe_routing(device, b=8, t=2548, d=512) -> None:
    """Phase 12 (c): the MoE module alone where tokens are dropped
    (module docstring), bf16 and fp32 on the card."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(b, t, d, generator=gen)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen)
    lens[0] = t
    pad = (torch.arange(t)[None] >= lens[:, None]).to(device)
    x = x.to(device)
    mods = {}
    for dtype in (torch.float32, torch.bfloat16):
        mods[dtype] = MoEFeedForward(d, ROUTING_EXPERTS, mult=4, capacity_factor=ROUTING_CF,
                                     dtype=dtype)
    init_weights(mods[torch.float32], torch.Generator().manual_seed(1))
    mods[torch.bfloat16].load_state_dict(mods[torch.float32].state_dict())
    for mod in mods.values():
        mod.to(device)
    y32, c32 = routed(mods[torch.float32], x, pad)
    y16, c16 = routed(mods[torch.bfloat16], x, pad)
    with planted_gates():
        yp, _ = routed(mods[torch.bfloat16], x, pad)
    with onehot_arm():
        yo, co = routed(mods[torch.bfloat16], x, pad)
    cap = expert_capacity(t, ROUTING_EXPERTS, ROUTING_CF)
    real = ~pad
    dropped = int((real & ~c16.any(1)).sum())
    flips = int((c32 != c16).sum())
    alike = real & (c32 == c16).all(1)  # [B, T]
    rel = rel_l2(y16[alike], y32[alike])
    arm_rel = rel_l2(y16, yo)
    planted_rel = rel_l2(yp, yo)
    print(f"moe (c): module alone, {ROUTING_EXPERTS} experts, capacity {cap} of T {t}, "
          f"x {list(x.shape)}: {int(real.sum())} real tokens, {dropped} of them picked by "
          f"no expert (bf16); bf16 vs fp32 choices flipped {flips} of "
          f"{b * ROUTING_EXPERTS * cap}, outputs relative L2 {rel:.3e} on the "
          f"{int(alike.sum())} real tokens routed alike; gather / index_add vs the one-hot "
          f"reference (bf16, same choices: {bool(torch.equal(co, c16))}) relative L2 "
          f"{arm_rel:.3e}, with expert 0's gates x {PLANTED_GATE_SCALE} (planted) "
          f"{planted_rel:.3e}", flush=True)
    assert dropped > 0 and int(alike.sum()) > 0.9 * int(real.sum()), (dropped, int(alike.sum()))
    assert torch.equal(co, c16)
    assert rel <= MOE_REL_L2, rel
    assert arm_rel <= MOE_ARM_REL_L2, arm_rel
    assert planted_rel > MOE_ARM_REL_L2, planted_rel
    assert not bool(y16[pad].any()) and not bool(yo[pad].any())  # padded tokens: no FF output


def seed_model(cfg):
    """``cfg``'s training model with the weights the phases draw: seed 0."""
    model = build_model(get_model_config(cfg), fused_ff=False)
    return model.init_weights(torch.Generator().manual_seed(0))


def peak_step(cfg, device, params, rows) -> tuple:
    """``(resident MiB, peak MiB)`` of a fused-backward step after a
    warm-up step: the memory held before it, and the most it held."""
    model, opt, sched = build_trainer(cfg, device.type, num_training_steps=2, params=params)
    batch = to_device(MultimodalCollator(cfg.modality_config.to_plain())(rows), device)
    train_step(model, opt, sched, batch, clip=float(cfg.clip))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_step(model, opt, sched, batch, clip=float(cfg.clip))
    peak = torch.cuda.max_memory_allocated()
    del model, opt, sched, batch
    return resident / 2**20, peak / 2**20


def check_moe(device, tmp: Path, cpu_device="cpu") -> dict:
    """Phase 12, the MoE family (module docstring); returns the launches
    of its main paths: K1 from serving and ``moe_stats``, K1 and K2 /
    K3a / K3b from training."""
    cfg = moe_config()
    depth, bs = int(cfg.layers), int(cfg.batch_size)
    t0 = time.perf_counter()
    served = check_slice(cfg, device, cpu_device, label="moe (a) serve")  # counts from 0
    print(f"moe (a): {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    trained, params = check_train(cfg, device, cpu_device, steps=MOE_STEPS,
                                  label="moe (b) train")
    print(f"moe (b): {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    check_moe_routing(device)
    print(f"moe (c): {time.perf_counter() - t1:.1f} s", flush=True)

    # (d) one call: the port's MoE, the one-hot reference and the dense
    # step, in turns
    t1 = time.perf_counter()
    rows = synthetic_rows(cfg, bs)
    dense_cfg = training_config(str(CONFIG))
    arms = {"gather (the port)": (cfg, params, contextlib.nullcontext),
            "one-hot reference": (cfg, params, onehot_arm),
            "dense": (dense_cfg, seed_model(dense_cfg).state_dict(), contextlib.nullcontext)}
    timed = {arm: [] for arm in arms}
    peaks = {}
    for arm in (*arms, *reversed(arms)):
        acfg, aparams, patch = arms[arm]
        with patch():
            timed[arm].append(profiled_steps(acfg, device, aparams, rows))
            if arm not in peaks:
                peaks[arm] = peak_step(acfg, device, aparams, rows)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    print(host_description(), flush=True)
    for arm, runs in timed.items():
        wall = ", ".join(f"{r['wall_ms']:.3f}" for r in runs)
        busy = ", ".join(f"{r['device_ms']:.3f}" for r in runs)
        top = "; ".join(f"{name[:100]} {ms:.3f}" for name, ms in runs[-1]["top"])
        print(f"moe (d): {arm} step (fused backward): wall ms {wall}; device busy ms "
              f"{busy}; resident {peaks[arm][0]:.1f} MiB, peak {peaks[arm][1]:.1f} MiB; "
              f"most device ms a step: {top}", flush=True)
    print(f"moe (d): {time.perf_counter() - t1:.1f} s", flush=True)

    # (e) moe_stats on the phase's rows, from (b)'s weights
    weights = tmp / "moe_weights"
    save_params(params, str(weights))
    stats_cfg = moe_config()
    stats_cfg.restart = str(weights)
    stats_cfg.split = RUN_SPLIT
    reset_launches()
    stats = extract_moe_stats(stats_cfg, rows=synthetic_rows(cfg, RUN_ROWS, seed=0),
                              device=device.type)
    stats_launches = launches_now()
    for r in stats:
        print(f"moe (e): moe_stats {json.dumps(r)}", flush=True)
    assert stats_launches == {"flash_fwd": depth, "geglu_ff": 0,
                              **dict.fromkeys(flash.bwd_launches, 0)}, stats_launches
    assert [r["layer"] for r in stats] == [f"layer_{i}" for i in range(depth)], stats
    for r in stats:
        assert r["coverage_real"] == 1.0 and r["capacity"] * bs == r["tokens_total"], r
        assert abs(sum(r["expert_prob_mass"]) - 1) <= MOE_MASS_ATOL, r
    print(f"moe: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"flash_fwd": served["flash_fwd"] + stats_launches["flash_fwd"],
            "geglu_ff": served["geglu_ff"], **trained}


def spread_params(config, seed: int = 0) -> dict:
    """The seed-0 weights of ``config``'s model with each block
    projection's output channels scaled by factors drawn log-uniform in
    [1/2, 2] (phase 13): per-channel int8 scales then differ as a
    trained model's do, where the init's uniform weights give every
    channel the same scale to 0.2% and a scale fault could not show."""
    params = seed_model(config).state_dict()
    g = torch.Generator().manual_seed(seed)
    for k, v in params.items():
        if k.startswith("layers.") and k.endswith(".weight") and (
                ".attn.to_" in k or ".feedforward." in k):
            f = torch.exp((torch.rand(v.shape[0], generator=g) * 2 - 1) * math.log(2.0))
            params[k] = v * f[:, None]
    return params


def rel_l2_keys(got: dict, ref: dict, keys, n: int) -> float:
    """The largest relative L2 over ``keys`` of two ``embed`` answers'
    first ``n`` rows."""
    return max(float(np.linalg.norm(got["embeddings"][k][:n] - ref["embeddings"][k][:n])
                     / np.linalg.norm(ref["embeddings"][k][:n])) for k in keys)


def cos_min(got: dict, ref: dict, keys) -> float:
    """The smallest cosine similarity of two ``embed`` answers over every
    live row (norm above 1e-6) and key."""
    worst = 1.0
    for k in keys:
        a = np.asarray(ref["embeddings"][k], np.float64)
        b = np.asarray(got["embeddings"][k], np.float64)
        na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
        live = na > 1e-6
        worst = min(worst, float(((a * b).sum(-1)[live] / (na[live] * nb[live])).min()))
    return worst


def check_int8_products(svc, device, cpu_device="cpu") -> list:
    """``int8_matmul`` on the card against the CPU on the same int8
    operands at the five projections' shapes (block 0's int8 weights,
    8 x T activation rows quantised from seeded normals): bitwise equal,
    integer sums being exact.  Returns ``(name, m, k, n)`` per shape."""
    block = svc.model.layers[0]
    mods = {"to_q": block.attn.to_q, "to_kv": block.attn.to_kv, "to_out": block.attn.to_out,
            "w_in": block.ff.feedforward[0], "w_out": block.ff.feedforward[2]}
    m = 8 * len(svc.model.mask_set.token_types)
    g = torch.Generator().manual_seed(0)
    shapes = []
    for name, mod in mods.items():
        k, n = mod.weight_q.shape
        xq = quant.quantize_rows(torch.randn((m, k), generator=g))[0]
        card = quant.int8_matmul(xq.to(device), mod.weight_q).cpu()
        plain = quant.int8_matmul(xq.to(cpu_device), mod.weight_q.to(cpu_device))
        assert card.dtype == torch.int32 and torch.equal(card, plain), name
        shapes.append((name, m, k, n))
    return shapes


AOT_ATOL = 1e-3  # the loaded program against the eager service: same kernels


def check_quant_aot(config, device, card: str, tmp: Path, cpu_device="cpu") -> dict:
    """Phase 13: int8 serving and the exported serving forward at
    TCGA_config1 (module docstring).  Returns the K1 and K5 launches of
    its main paths: (a)'s serving and (b)'s loaded programs."""
    t0 = time.perf_counter()
    params = spread_params(config)
    # (a) int8 serving, as phase 5, against the same int8 weights in fp32
    # on the CPU
    keep = {}
    counts = check_slice(config, device, cpu_device, label="int8 (a)", params=params,
                         quantize="int8", keep=keep)
    svc8, rows, via_embed, cpu8 = keep["svc"], keep["rows"], keep["via_embed"], keep["cpu_svc"]
    keys, depth = svc8.emb_keys, len(svc8.model.layers)
    fp_svc = EmbeddingService(config, params=params, device=device, max_batch=8)
    cos = cos_min(via_embed, fp_svc.embed(rows), keys)
    scale = cpu8.model.layers[0].attn.to_q.scale
    with torch.no_grad():
        scale.copy_(scale.flip(0))
    planted = rel_l2_keys(via_embed, cpu8.embed(rows[:8]), keys, 8)
    shapes = check_int8_products(svc8, device, cpu_device)
    print(f"int8 (a): cosine to the fp32-weight service, worst live row and key {cos:.6f} "
          f"(bound > {COS_MIN}); planted fault (block 0's to_q scales reversed on the CPU) "
          f"reads {planted:.3e} against the {SLICE_REL_L2} bound; s32 products card vs CPU "
          f"bitwise equal at {', '.join(f'{n} [{m}, {k}] x [{k}, {c}]' for n, m, k, c in shapes)}",
          flush=True)
    assert cos > COS_MIN, cos
    assert planted > SLICE_REL_L2, "planted fault passes: a block's to_q scales reversed"

    # (b) the exported forwards, served from their artifacts
    batch = svc8._pad(rows[:8])
    programs, sizes = {}, {}
    for name, svc in (("fp", fp_svc), ("int8", svc8)):
        t1 = time.perf_counter()
        blob, ek, mk = export_aot.export_packed_forward(config, None, batch, model=svc.model,
                                                        device=device.type)
        path = tmp / f"{name}.aot"
        export_aot.save_aot(str(path), blob, ek, mk, modality_config=config.modality_config
                            .to_plain(), batch=8, device=device.type, quantize=svc.quantize)
        aot = EmbeddingService.from_aot(str(path), device=device.type)
        export_s = time.perf_counter() - t1
        want = svc.embed(rows[:8])
        reset_launches()
        got = aot.embed(rows[:8])  # the main path: one forward of the loaded program
        launched = launches_now()
        assert launched == {"flash_fwd": depth, "geglu_ff": depth if name == "fp" else 0,
                            **dict.fromkeys(flash.bwd_launches, 0)}, (name, launched)
        for k in ("flash_fwd", "geglu_ff"):
            counts[k] += launched[k]
        gap = max(float(np.abs(got["embeddings"][k] - want["embeddings"][k]).max())
                  for k in keys)
        assert aot.emb_keys == keys and gap <= AOT_ATOL, (name, gap)
        for m in svc.mask_keys:
            np.testing.assert_array_equal(got["present"][m], want["present"][m])
        programs[name], sizes[name] = aot, path.stat().st_size
        print(f"aot (b): {name} exported, saved and loaded in {export_s:.1f} s, "
              f"{sizes[name]} bytes; loaded program vs eager service max abs gap {gap!r} "
              f"(bound {AOT_ATOL}); launches of one forward {launched}", flush=True)
    proj = [v for k, v in svc8.model.state_dict().items() if k.endswith(".weight_q")]
    q_bytes = sum(v.numel() for v in proj)
    print(f"aot (b): the five projections a block, {len(proj)} matrices: {q_bytes} bytes "
          f"int8 against {4 * q_bytes} fp32; artifacts {sizes['int8']} bytes int8 against "
          f"{sizes['fp']} fp ({sizes['int8'] / sizes['fp']:.3f})", flush=True)
    fresh = served_in_fresh_process(tmp / "fp.aot", rows[0], device.type)
    assert fresh["launches"] == {"flash_fwd": depth, "geglu_ff": depth}, fresh["launches"]
    model_code = {f"mca_tpu_torch.{m}" for m in ("models", "config", "encoders", "masks")}
    assert not model_code & set(fresh["loaded"]), fresh["loaded"]
    alone = programs["fp"].embed([rows[0]])
    fresh_gap = max(float(np.abs(np.asarray(fresh["embeddings"][k]) - alone["embeddings"][k][0])
                          .max()) for k in keys)
    assert fresh_gap <= AOT_ATOL, fresh_gap
    print(f"aot (b): a fresh process that imports the service and the loader only "
          f"({len(fresh['loaded'])} modules of the port) served a row from the fp artifact "
          f"in {fresh['seconds']:.1f} s, K1 {fresh['launches']['flash_fwd']} and K5 "
          f"{fresh['launches']['geglu_ff']} launches, max abs gap {fresh_gap!r} to this "
          f"process's", flush=True)

    # (b) a MoE model (phase 12's) exported on the card and served through
    # serve --aot (the CLI's service from its artifact) against the eager service
    moe_cfg = moe_config()
    moe_svc = EmbeddingService(moe_cfg, params=seed_model(moe_cfg).state_dict(),
                               device=device, max_batch=8)
    blob, ek, mk = export_aot.export_packed_forward(moe_cfg, None, moe_svc._pad(rows[:8]),
                                                    model=moe_svc.model, device=device.type)
    moe_path = tmp / "moe.aot"
    export_aot.save_aot(str(moe_path), blob, ek, mk,
                        modality_config=moe_cfg.modality_config.to_plain(), batch=8,
                        device=device.type, quantize="none")
    moe_aot = service_from_args(parse_args(["--aot", str(moe_path)]))
    want = moe_svc.embed(rows[:8])
    reset_launches()
    got = moe_aot.embed(rows[:8])  # the main path: one forward of the loaded program
    launched = launches_now()
    assert launched == {"flash_fwd": depth, "geglu_ff": 0,
                        **dict.fromkeys(flash.bwd_launches, 0)}, ("moe", launched)
    counts["flash_fwd"] += launched["flash_fwd"]
    gap = max(float(np.abs(got["embeddings"][k] - want["embeddings"][k]).max())
              for k in moe_svc.emb_keys)
    assert moe_aot.emb_keys == moe_svc.emb_keys and gap <= AOT_ATOL, gap
    print(f"aot (b): the MoE model ({MOE_EXPERTS} experts, capacity factor {MOE_CF}) "
          f"exported, {moe_path.stat().st_size} bytes, served through serve --aot: max abs "
          f"gap {gap!r} to the eager service (bound {AOT_ATOL}); launches of one forward "
          f"{launched}", flush=True)
    moe_svc.stop()
    moe_aot.stop()
    del moe_svc, moe_aot

    # (c) ms per batch-8 forward on the staged batch, CUDA events
    with torch.inference_mode():
        times = {name: cuda_ms(lambda fn=fn: fn(batch), 20) for name, fn in (
            ("eager fp", fp_svc._fn), ("eager int8", svc8._fn),
            ("aot fp", programs["fp"]._fn), ("aot int8", programs["int8"]._fn))}
    print(f"int8 / aot (c): ms per batch-8 forward on {card}: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in times.items())}", flush=True)
    print(f"int8 and aot: {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def served_in_fresh_process(path: Path, row: dict, device: str = "cuda") -> dict:
    """``EmbeddingService.from_aot`` in a new process that imports only the
    service (and through it the loader, the collator and the kernels'
    operator modules), embedding ``row``: its embeddings, launches, the
    port's modules it imported, and its seconds."""
    code = (
        "import json, sys, time\n"
        "t0 = time.perf_counter()\n"
        "import numpy as np\n"
        "from mca_tpu_torch.serve import EmbeddingService\n"
        "from mca_tpu_torch.ops import flash_attention as flash, fused_ff as ff\n"
        f"svc = EmbeddingService.from_aot({str(path)!r}, device={device!r})\n"
        "row = {m: {f: np.asarray(v, np.float32) for f, v in d.items()}\n"
        "       for m, d in json.loads(sys.stdin.read()).items()}\n"
        "flash.launches = ff.launches = 0\n"
        "out = svc.embed([row])\n"
        "print(json.dumps({'embeddings': {k: v[0].tolist() for k, v in out['embeddings'].items()},\n"
        "                  'launches': {'flash_fwd': flash.launches, 'geglu_ff': ff.launches},\n"
        "                  'loaded': sorted(m for m in sys.modules if m.startswith('mca_tpu')),\n"
        "                  'seconds': time.perf_counter() - t0}))\n"
    )
    payload = json.dumps({m: {f: np.asarray(v).tolist() for f, v in d.items()}
                          for m, d in row.items()})
    res = subprocess.run([sys.executable, "-c", code], input=payload, capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert not [m for m in out["loaded"] if m == "mca_tpu" or m.startswith("mca_tpu.")]
    return out


def probe_tol(plain: torch.Tensor) -> torch.Tensor:
    """Tolerance of each entry of a measurement kernel's output: PROBE_RTOL
    of the entry plus PROBE_RTOL of the largest, at its dtype's rtol."""
    p = plain.float().abs()
    return PROBE_RTOL[plain.dtype] * (p + p.max())


def outside(kernel: torch.Tensor, plain: torch.Tensor) -> int:
    """Entries of ``kernel`` outside tolerance of ``plain``."""
    return int(((kernel.float() - plain.float()).abs() > probe_tol(plain)).sum())


def probe_err(kernel: torch.Tensor, plain: torch.Tensor):
    """``(max |kernel - plain|, largest share of an entry's tolerance)``;
    asserts every entry is within tolerance."""
    diff = (kernel.float() - plain.float()).abs()
    share = float((diff / probe_tol(plain)).max())
    assert share <= 1.0, (
        f"{outside(kernel, plain)} entries outside tolerance, max abs err "
        f"{float(diff.max())}, {share:.2f} of tolerance"
    )
    return float(diff.max()), share


def planted(faults: dict) -> str:
    """Asserts that each planted fault, ``{what: (kernel output, plain
    version computed wrong)}``, puts entries outside tolerance; returns a
    note."""
    notes = []
    for what, (kernel, fault) in faults.items():
        n_out = outside(kernel, fault)
        assert n_out > 0, (what, "planted fault passes")
        notes.append(f"{what} {n_out / kernel.numel():.1%}")
    return "planted faults outside tolerance: " + ", ".join(notes)


def bwd5_dropped(q, kv, iters: int, eps: float, product: str):
    """The plain bwd5 chain with one product (dq, dv or dk) left out."""
    for _ in range(iters):
        p = probes.bwd5_products(q, kv[: probes.TILE], kv[probes.TILE :])
        p[product] = torch.zeros_like(p[product])
        fold = (p["dv"] + p["dk"]).sum(dim=-2, keepdim=True)
        q = (q.float() + (p["dq"] + fold) * eps).to(torch.bfloat16)
    return q


def launch_bound(n_bytes: float, bf16_ops: float = 0.0, fp32_instr: float = 0.0,
                 mufu_ops: float = 0.0):
    """One measurement launch's bound, ``(ms, by)``: the larger of its
    bytes over the HBM rate and its slowest unit, which runs beside the
    others: tensor-core operations over the bf16 peak, fp32 instructions
    over the FP32 pipe's issue rate, MUFU operations over the MUFU rate."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(bf16_ops / PEAK_BF16, fp32_instr / PEAK_FP32_ISSUE, mufu_ops / PEAK_MUFU)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_entry(name, tpu_line, errs, ms, plain_ms, bounds) -> dict:
    """The kernels-line entry of a measurement kernel: the sums over its
    modes' timed launches; ``bounds`` holds each launch's
    :func:`launch_bound`."""
    by = {"bytes": 0.0, "operations": 0.0}
    for b_ms, b_by in bounds.values():
        by[b_by] += b_ms
    return {
        "name": name,
        "route": "cuda",
        "source": f"mca_tpu_torch/csrc/{name}.cu",
        "replaces": tpu_line,
        "max_abs_err": max(errs.values()),
        "ms": sum(ms.values()),
        "plain_ms": sum(plain_ms.values()),
        "bound_ms": sum(by.values()),
        "bound_by": max(by, key=by.get),
        "library_ms": None,
        "modes_ms": ms,
        "modes_bound_ms": {m: b[0] for m, b in bounds.items()},
    }


def check_counter(device) -> dict:
    """K6, every mode on as many blocks as reside at once: the check
    after CHECK_ITERS iterations from ``probes.counter_check_inputs``, the
    planted faults, and one launch of TIMED_ITERS iterations at the rate
    pass's inputs (kernel and plain); the entry sums the five launches."""
    errs, ms, plain_ms, bounds = {}, {}, {}, {}
    for mode in probes.COUNTER_MODES:
        n = probes.counter_blocks(mode)
        x0, aux, const = probes.counter_check_inputs(mode, n, seed=7)
        x0, aux = x0.to(device), (aux.to(device) if aux is not None else None)
        out = probes.roofline_counter(mode, x0, aux, CHECK_ITERS, const)
        ref = probes.counter_reference(mode, x0, aux, CHECK_ITERS, const)
        torch.cuda.synchronize()
        errs[mode], share = probe_err(out, ref)
        faults = {"one iteration short": (out, probes.counter_reference(
            mode, x0, aux, CHECK_ITERS - 1, const))}
        if mode == "bwd5":
            for product in ("dq", "dv", "dk"):
                faults[f"{product} dropped"] = (
                    out, bwd5_dropped(x0, aux, CHECK_ITERS, const, product))
        note = planted(faults)
        work, t_const, fill = roofline_tool.COUNTER_WORK[mode]
        xt, auxt = roofline_tool.counter_inputs(mode, n, device, fill)
        ms[mode] = cuda_ms(
            lambda: probes.roofline_counter(mode, xt, auxt, TIMED_ITERS, t_const), 5
        )
        plain_ms[mode] = cuda_ms(
            lambda: probes.counter_reference(mode, xt, auxt, TIMED_ITERS, t_const), 1, 0
        )
        n_bytes = 2.0 * xt.numel() * xt.element_size() + (
            auxt.numel() * auxt.element_size() if auxt is not None else 0
        )
        elems = float(xt.numel()) * TIMED_ITERS
        if mode == "vpu":  # an FMUL and an FFMA an element
            bounds[mode] = launch_bound(n_bytes, fp32_instr=2 * elems)
        elif mode == "exp":  # an FFMA and a MUFU.EX2 an element
            bounds[mode] = launch_bound(n_bytes, fp32_instr=elems, mufu_ops=elems)
        else:
            bounds[mode] = launch_bound(n_bytes, bf16_ops=float(n) * work * TIMED_ITERS)
        print(
            f"K6 roofline_counter {mode}: {n} blocks, max_abs_err {errs[mode]:.3e} "
            f"({share:.2f} of tolerance) after {CHECK_ITERS} iterations; {note}; {TIMED_ITERS} iterations: {ms[mode]:.4f} ms "
            f"kernel ({ms[mode] * 1e3 / TIMED_ITERS:.4f} us per iteration; bound "
            f"{bounds[mode][0]:.4f} ms), {plain_ms[mode]:.3f} ms plain",
            flush=True,
        )
    return kernel_entry("roofline_counter", "baselines/roofline.py:253", errs, ms, plain_ms,
                        bounds)


def check_probe(device) -> dict:
    """K7, each mode: the check after one iteration from the tool's
    seeded a and W and a b far from the exp chain's fixed point, the
    planted faults (each chain one step short), and the mean of
    TIMED_PROBE_LAUNCHES queued launches of TIMED_PROBE_ITERS
    iterations."""
    n = probes.probe_blocks()
    t = overlap_tool.probe_inputs(n, device, seed=3, n_chunks=1)
    a, w = t["a"], t["w"]
    # b <- exp(-|b|) + 1e-3 contracts by about 0.57 a step towards 0.568;
    # from |b| in [3, 6] every step up to the 21st is still outside the
    # fp32 tolerance of the one before, so one iteration's output (EXP_CALLS
    # steps) shows its step count
    rng = np.random.default_rng(3)
    mag = rng.uniform(3.0, 6.0, (n, *probes.EXP_SHAPE)) * rng.choice([-1.0, 1.0], (n, *probes.EXP_SHAPE))
    b = torch.from_numpy(mag).float().to(device)
    b_short = b
    for _ in range(probes.EXP_CALLS - 1):
        b_short = probes.abs_exp_step(b_short)
    errs, ms, plain_ms, bounds = {}, {}, {}, {}
    for mode in probes.PROBE_MODES:
        ka, kb = probes.probe_overlap(mode, a, w, b, 1)
        ra, rb = probes.probe_reference(mode, a, w, b, 1)
        torch.cuda.synchronize()
        (err_a, share_a), (err_b, share_b) = probe_err(ka, ra), probe_err(kb, rb)
        errs[mode], share = max(err_a, err_b), max(share_a, share_b)
        faults = {}
        if mode != "vpu":
            faults["product chain one step short"] = (ka, a)
        if mode != "mxu":
            faults["exp chain one step short"] = (kb, b_short)
        note = planted(faults)
        ms[mode] = cuda_ms(lambda: probes.probe_overlap(mode, a, w, b, TIMED_PROBE_ITERS),
                           TIMED_PROBE_LAUNCHES, queued=True)
        plain_ms[mode] = cuda_ms(
            lambda: probes.probe_reference(mode, a, w, b, TIMED_PROBE_ITERS), 1, 0
        )
        n_bytes = 2.0 * (a.numel() * 2 + b.numel() * 4) + w.numel() * 2
        products = float(n) * 2 * probes.CHAIN_ROWS * probes.CHAIN_W**2 * TIMED_PROBE_ITERS
        exps = float(b.numel()) * probes.EXP_CALLS * TIMED_PROBE_ITERS
        # an exp step is an FMUL, a MUFU.EX2 and an FADD an element
        bounds[mode] = launch_bound(
            n_bytes,
            bf16_ops=products if mode != "vpu" else 0.0,
            fp32_instr=2 * exps if mode != "mxu" else 0.0,
            mufu_ops=exps if mode != "mxu" else 0.0,
        )
        print(
            f"K7 probe_overlap {mode}: {n} blocks, max_abs_err {errs[mode]:.3e} "
            f"({share:.2f} of tolerance) after 1 iteration; {note}; {TIMED_PROBE_ITERS} iterations: {ms[mode]:.4f} ms kernel "
            f"(bound {bounds[mode][0]:.4f} ms), {plain_ms[mode]:.3f} ms plain",
            flush=True,
        )
    return kernel_entry("probe_overlap", "baselines/probe_overlap.py:97", errs, ms, plain_ms,
                        bounds)


def check_ctl(device) -> dict:
    """K8, each mode: the check after 3 steps of 2 products each at
    scale 1.25 (so that a lost or repeated scaling shows), the planted
    fault (the plain version one step short), and one launch of
    TIMED_CTL_STEPS steps of CTL_DOTS products."""
    n = probes.ctl_blocks()
    t = overlap_tool.probe_inputs(n, device, seed=5)
    x, a, w = t["x"], t["a"], t["w"]
    chunk = float(x[0].numel())
    errs, ms, plain_ms, bounds = {}, {}, {}, {}
    for mode in probes.CTL_MODES:
        ky, ka = probes.probe_overlap_ctl(mode, x, torch.zeros_like(x), a, w, 3, 2, 1.25)
        ry, ra = probes.ctl_reference(mode, x, torch.zeros_like(x), a, w, 3, 2, 1.25)
        torch.cuda.synchronize()
        (err_y, share_y), (err_a, share_a) = probe_err(ky, ry), probe_err(ka, ra)
        errs[mode], share = max(err_y, err_a), max(share_y, share_a)
        del ry, ra
        sy, sa = probes.ctl_reference(mode, x, torch.zeros_like(x), a, w, 2, 2, 1.25)
        n_out = outside(ky, sy) + outside(ka, sa)
        assert n_out > 0, (mode, "planted fault passes: one step short")
        del ky, ka, sy, sa
        y = torch.zeros_like(x)
        args = (mode, x, y, a, w, TIMED_CTL_STEPS, CTL_DOTS, overlap_tool.CTL_SCALE)
        ms[mode] = cuda_ms(lambda: probes.probe_overlap_ctl(*args), 3)
        plain_ms[mode] = cuda_ms(lambda: probes.ctl_reference(*args), 1, 0)
        streamed = TIMED_CTL_STEPS if mode != "ctl_mxu" else 1
        # each step scales a chunk (an FMUL an element)
        bounds[mode] = launch_bound(
            2.0 * n * streamed * chunk * 4 + 2.0 * a.numel() * 2 + w.numel() * 2,
            bf16_ops=(float(n) * 2 * probes.CHAIN_ROWS * probes.CHAIN_W**2
                      * TIMED_CTL_STEPS * CTL_DOTS) if mode != "ctl_dma" else 0.0,
            fp32_instr=float(n) * chunk * TIMED_CTL_STEPS,
        )
        print(
            f"K8 probe_overlap_ctl {mode}: {n} blocks, max_abs_err {errs[mode]:.3e} "
            f"({share:.2f} of tolerance) after 3 steps; planted fault (one step short) puts {n_out} entries outside; "
            f"{TIMED_CTL_STEPS} steps of {CTL_DOTS} product(s): {ms[mode]:.4f} ms kernel "
            f"({ms[mode] * 1e3 / TIMED_CTL_STEPS:.3f} us per step; bound "
            f"{bounds[mode][0]:.4f} ms), {plain_ms[mode]:.3f} ms plain",
            flush=True,
        )
    return kernel_entry("probe_overlap_ctl", "baselines/probe_overlap.py:194", errs, ms,
                        plain_ms, bounds)


def check_tools(device) -> dict:
    """The measurement slice's main path, with the launch counts at 0
    just before it: the roofline tool's short rate pass and the overlap
    probe at a short length.  Every rate within (0, 105%] of its
    published ceiling; the control must read OVERLAPS."""
    probes.launches.update(dict.fromkeys(probes.launches, 0))
    rates = roofline_tool.measure_rates(min_ms=2.0)
    rec = overlap_tool.run(min_ms=2.0, ctl_dots=CTL_DOTS)
    counts = dict(probes.launches)
    print(f"tools: launches {counts}", flush=True)
    for name, c in counts.items():
        assert c >= 1, (name, c)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max(roofline_tool.sm_clock_mhz("clocks.max.sm"), *rates["clocks_sm_mhz"].values())
    of_ceiling = roofline_tool.check_rates(rates, roofline_tool.rate_ceilings(clock, sms))
    print(f"tools: short rate pass on {sms} SMs; exp ceiling at {clock:g} MHz", flush=True)
    roofline_tool.print_rates(rates, of_ceiling)
    print(
        f"tools: overlap probe us per iteration {rec['us_per_iter']}, verdict "
        f"{rec['verdict']} (fraction {rec['overlap_fraction']}); control us per step "
        f"{rec['control_us_per_step']} (ctl_dots {rec['ctl_dots']}), verdict "
        f"{rec['control_verdict']} (fraction {rec['control_overlap_fraction']}); clocks.sm "
        f"{rec['clocks_sm_mhz_before']:g} -> {rec['clocks_sm_mhz_after']:g} MHz",
        flush=True,
    )
    assert rec["control_verdict"] == "OVERLAPS", rec
    return counts


def sass_of(name: str) -> dict:
    """``sass_counts.count`` of the built library ``name``, per function."""
    sass = subprocess.run([sass_counts.cuobjdump_path(), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sass_counts.count(sass)


def print_sass(name: str, fn: str, c: dict) -> None:
    print(f"  {name} SASS {fn[-48:]}: HGMMA {c['HGMMA']} (waits {c['WGWAIT']}), UTMALDG "
          f"{c['UTMALDG']}, UTMAREDG {c['UTMAREDG']}, HMMA {c['HMMA']}, MUFU.EX2 "
          f"{c['MUFU.EX2']}, {c['lines']} lines", flush=True)


def check_ptxas(name: str, report: str) -> None:
    """ptxas reports no spills for ``name`` and did not serialise its
    wgmma pipeline (a C75xx warning: a wait after every HGMMA)."""
    spills = [line for line in report.splitlines() if "spill" in line]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in line
                          for line in spills), (name, spills)
    serialised = [line for line in report.splitlines() if "are serialized" in line]
    assert not serialised, (name, serialised)


def check_hopper_sass(reports: dict, names=("flash_fwd", "geglu_ff", "flash_bwd",
                                            "flash_bwd_dq", "flash_bwd_dkv")) -> None:
    """K1, K5, K2, K3a and K3b are built from wgmma and TMA: their SASS
    holds HGMMA and UTMALDG and no HMMA (mma.sync), with no spills and no
    wgmma serialisation; K2 alone holds UTMAREDG, the TMA reduce-add of
    its dq partials (K3a, the deterministic route, has none)."""
    for name in names:
        for fn, c in sass_of(name).items():
            print_sass(name, fn, c)
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0, (name, c)
            assert (c["UTMAREDG"] > 0) == (name == "flash_bwd"), (name, c)
        check_ptxas(name, reports[name])


# K7's three kernels by their template arguments (kDoMxu, kDoExp), as
# they appear in the mangled names cuobjdump prints
PROBE_KERNELS = {"ILb1ELb0E": "mxu", "ILb0ELb1E": "vpu", "ILb1ELb1E": "both"}


def probe_sass_faults(counts: dict) -> list:
    """What is wrong with K7's SASS, from ``sass_counts.count`` of its
    library: ``mxu`` and ``both`` must hold HGMMA (wgmma) and ``vpu``
    none; none may hold HMMA (mma.sync); ``vpu`` and ``both`` must hold
    MUFU.EX2 and ``mxu`` none; each mode once.  Empty when all hold."""
    faults, seen = [], []
    for fn, c in counts.items():
        mode = next((m for tag, m in PROBE_KERNELS.items()
                     if f"probe_overlap_kernel{tag}" in fn), None)
        if mode is None:
            faults.append(f"{fn}: not one of K7's kernels")
            continue
        seen.append(mode)
        if c["HMMA"]:
            faults.append(f"{mode}: {c['HMMA']} HMMA (mma.sync)")
        if (c["HGMMA"] > 0) != (mode != "vpu"):
            faults.append(f"{mode}: {c['HGMMA']} HGMMA")
        if (c["MUFU.EX2"] > 0) != (mode != "mxu"):
            faults.append(f"{mode}: {c['MUFU.EX2']} MUFU.EX2")
    if sorted(seen) != sorted(probes.PROBE_MODES):
        faults.append(f"K7 kernels found: {seen}")
    return faults


def check_probe_sass(report: str) -> None:
    """K7 is the wgmma design (:func:`probe_sass_faults`), with no spills
    and no wgmma serialisation."""
    counts = sass_of("probe_overlap")
    for fn, c in counts.items():
        print_sass("probe_overlap", fn, c)
    faults = probe_sass_faults(counts)
    assert not faults, faults
    check_ptxas("probe_overlap", report)


def check_counter_sass(report: str) -> None:
    """K6's tensor-core modes (fwdpair, bwd5, big) hold HGMMA (wgmma) and
    no HMMA (mma.sync); its vpu and exp sweeps hold neither; no spills
    and no wgmma serialisation."""
    seen = set()
    for fn, c in sass_of("roofline_counter").items():
        print_sass("roofline_counter", fn, c)
        kind = next(k for k in ("fwdpair", "bwd5", "big", "sweep") if f"{k}_kernel" in fn)
        seen.add(kind)
        assert c["HMMA"] == 0 and (c["HGMMA"] > 0) == (kind != "sweep"), (fn, c)
    assert seen == {"fwdpair", "bwd5", "big", "sweep"}, seen
    check_ptxas("roofline_counter", report)

# ---------------------------------------------------------------------------
# phase 14: data and tensor parallelism


def par_config(config, **overrides):
    """Phase 14's configuration: ``config`` (TCGA_config1) with 2 warm-up
    steps (the config's 3000 would keep lr near 0 for 3 steps) and
    ``overrides``."""
    cfg = type(config)(config)
    cfg.num_warmup_steps = TRAIN_WARMUP
    for k, v in overrides.items():
        cfg[k] = v
    return cfg


def flat_params(state: dict) -> torch.Tensor:
    return torch.cat([v.detach().float().reshape(-1).cpu() for _, v in sorted(state.items())])


def par_steps(cfg, device, params, batch, stage=lambda b: b, plant=None) -> dict:
    """PAR_STEPS steps of ``build_trainer`` (on the mesh the process group
    and ``cfg`` give) from ``params`` on the collated ``batch`` (this
    rank's rows of it, through ``stage``): per-step metrics, wall ms and
    launches, the whole final parameters on the host, and this process's
    peak device memory and optimizer state in MiB; then, on CUDA, the
    trainer's resident bytes (what deleting it frees, its gradients
    dropped first, in the bytes its tensors asked the allocator for),
    ``memory_allocated`` less the batch beside them, and the count of its
    state's tensors."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model, opt, sched = build_trainer(cfg, device.type, num_training_steps=PAR_STEPS,
                                      params=params)
    if plant is not None:
        plant(model, opt)
    local = to_device(stage(batch), device)
    n_accum = int(cfg.get("grad_accum", 1) or 1)
    hist, wall, per_step = [], [], []
    for _ in range(PAR_STEPS):
        before = launches_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist.append(train_step(model, opt, sched, local, clip=float(cfg.clip), n_accum=n_accum))
        wall.append(1e3 * (time.perf_counter() - t0))  # train_step ends in a sync
        per_step.append({k: v - before[k] for k, v in launches_now().items()})
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else None
    whole = opt.model_state_dict() if hasattr(opt, "model_state_dict") else model.state_dict()
    out = {"metrics": hist, "wall_ms": wall, "launches": per_step,
           # copies, which do not keep the trainer's leaves alive on the CPU either
           "params": {k: v.detach().to("cpu", copy=True) for k, v in whole.items()},
           "peak_mib": peak, "opt_mib": optimizer_state_bytes(getattr(opt, "inner", opt)) / 2**20,
           "n_tensors": len(memory_report.state_tensors(model, opt)),
           "resident": None, "raw": None, "allocated_drop": None}
    del whole
    if allocated(device) is not None:
        for p in memory_report.state_tensors(model, opt):
            p.grad = None
        gc.collect()
        held = allocated(device)
        out["raw"] = torch.cuda.memory_allocated(device) - memory_report.tensor_bytes(
            t for f in local.values() for t in f.values())
        whole_drop = torch.cuda.memory_allocated(device)
        del model, opt, sched
        gc.collect()
        out["resident"] = held - allocated(device)
        out["allocated_drop"] = whole_drop - torch.cuda.memory_allocated(device)
    return out


def allocated(device):
    """The bytes the live tensors on ``device`` asked the caching allocator
    for (None off CUDA)."""
    return memory_report.requested_bytes(device) if device.type == "cuda" else None


def skip_out_reduce(model, opt) -> None:
    """Phase 14 (b)'s planted fault on rank 1: block 0's row-parallel
    output keeps its own partial.  The collective still runs, forward and
    backward (its result enters at weight 0), so that rank 0 gets the
    true sum and the ranks' collectives stay in step."""
    attn = model.layers[0].attn
    real = attn.reduce_out

    def faulty(out):
        summed = real(out)
        if dist.get_rank() != 1:
            return summed
        mine = out.float()
        mine = coll.chunk(mine, attn.model_group, 1) if attn.seq_shard else mine
        return summed * 0 + mine

    attn.reduce_out = faulty


def unscaled_grads(model, opt) -> None:
    """Phase 14 (b)'s planted fault on a data axis: the gradient summed
    over ``data``, not averaged (the 1 / data of ``reduce_gradients``
    dropped)."""
    real = opt.reduce_gradients

    def faulty():
        real()
        for g in opt.gradients():
            g.mul_(opt.mesh.data)

    opt.reduce_gradients = faulty


def late_stage(model, opt) -> None:
    """Phase 15 (a)'s planted fault: stage 1 runs on the activation of the
    microbatch before its own (zeros for the first), one tick late; the
    shifts stay as they are.  :func:`parallel_rank` puts the real
    ``stage_input`` back after the run."""
    real, held = pipeline.stage_input, [None]

    def late(stage, m, xm, recv):
        if stage != 1:
            return real(stage, m, xm, recv)
        out = torch.zeros_like(recv) if m == 0 else held[0]
        held[0] = recv
        return out

    pipeline.stage_input = late


def summed_replicated(model, opt) -> None:
    """Phase 15 (a)'s planted fault: the gradients every stage already
    holds whole (final norm, pool, logit scales) summed over ``pipe``."""
    real = opt.reduce_gradients

    def faulty():
        real()
        opt._all_reduce_flat([g for g, s in zip(opt.gradients(), opt.pipe_partial) if not s],
                             opt.mesh.pipe_group)

    opt.reduce_gradients = faulty


def first_experts(model, opt) -> None:
    """Phase 15 (b)'s planted fault: every model rank computes the experts
    of rank 0's range with its own experts' weights."""
    for mod in model.modules():
        if isinstance(mod, MoEFeedForward):
            n = mod.experts["w_in"].shape[0]
            mod.local_experts = lambda n=n: (0, n)


def router_not_summed(model, opt) -> None:
    """Phase 15 (b)'s planted fault: the router's gradient left as each
    model rank's partial sum (the all-reduce over ``model`` dropped)."""
    opt.model_partial = [s and not n.endswith("router.weight")
                         for n, s in zip(opt.names, opt.model_partial)]


def reversed_gather(model, opt) -> None:
    """Phase 16 (a)'s planted fault: every group's slices gathered in
    reverse rank order (forward and backward alike)."""
    real = opt._gather_rows
    opt._gather_rows = lambda mine: real(mine).flip(0)


def kept_wholes(model, opt) -> None:
    """Phase 16 (a)'s planted fault: every gathered group's whole weights
    kept (by the optimizer) after its forward and its backward.  Detached:
    a kept graph output would tie its autograd node, which holds the
    optimizer, to the optimizer, and the cycle would outlive the run."""
    real, kept = opt._gather, []

    def gather(bucket):
        wholes = real(bucket)
        kept.append([w.detach() for w in wholes])
        return wholes

    opt._gather = gather


def unscaled_scatter(model, opt) -> None:
    """Phase 16 (a)'s planted fault: the groups' whole gradients
    reduce-scattered into the slices without the 1 / data."""
    real = opt._scatter_grads
    opt._scatter_grads = lambda bucket, grads: [g * opt.mesh.data for g in real(bucket, grads)]


def moments_only(model, opt) -> None:
    """PR 14's ``fsdp``, rebuilt on a ``mesh_data`` trainer for phase 16
    (a)'s peak: the parameters and the gradient whole on every rank (the
    data-parallel all-reduce), AdamW's moments and update on the rank's
    ``1 / data`` slice (a view) of each leaf of at least FSDP_MIN_SIZE
    elements, the updated slices all-gathered into every rank's leaves."""
    d, r = opt.mesh.data, opt.mesh.data_rank
    big = [i for i, p in enumerate(opt.opt_params) if p.numel() >= FSDP_MIN_SIZE]
    chunk = {i: -(-opt.opt_params[i].numel() // d) for i in big}
    span = {i: slice(min(r * chunk[i], opt.opt_params[i].numel()),
                     min((r + 1) * chunk[i], opt.opt_params[i].numel())) for i in big}
    views = {i: opt.opt_params[i].detach().view(-1)[span[i]] for i in big}
    # the schedule steps this group's lr: keep the group, swap its leaves
    opt.inner.param_groups[0]["params"] = [views.get(i, p) for i, p in enumerate(opt.opt_params)]

    def step():
        for i in big:
            views[i].grad = opt.opt_params[i].grad.view(-1)[span[i]]
        opt.inner.step()
        with torch.no_grad():
            mine = torch.cat([opt._padded(views[i], chunk[i]) for i in big])
            rows = coll.all_gather(mine, opt.mesh.data_group).reshape(d, -1)
            for i, cols in zip(big, rows.split([chunk[i] for i in big], dim=1)):
                p = opt.opt_params[i]
                p.copy_(cols.reshape(-1)[: p.numel()].view_as(p))
        for p in [*opt.opt_params, *views.values()]:
            p.grad = None

    opt.step = step


PLANTS = {"none_gather": lambda m, o: setattr(m.loss, "backprop", coll.BackpropType.NONE),
          "skip_out_reduce": skip_out_reduce, "unscaled_grads": unscaled_grads,
          "late_stage": late_stage, "summed_replicated": summed_replicated,
          "first_experts": first_experts, "router_not_summed": router_not_summed,
          "reversed_gather": reversed_gather, "kept_wholes": kept_wholes,
          "unscaled_scatter": unscaled_scatter, "moments_only": moments_only, None: None}


def probe_collectives(device) -> dict:
    """Which collectives the process group's backend accepts on
    ``device``'s tensors, at two ranks: per collective "ok" (right
    values) or the first line of its error.  The port chooses its
    collectives by backend, not from this; phase 14 (b) prints it.  The
    point-to-point ops are :func:`probe_p2p`'s, in processes of their own."""
    r = dist.get_rank()
    x, o = torch.full((2,), r + 1.0, device=device), torch.zeros(4, device=device)

    def fsdp2():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        lin = fully_shard(torch.nn.Linear(4, 4, device=device),
                          mesh=init_device_mesh(device.type, (2,)))
        lin(torch.ones(2, 4, device=device)).sum().backward()
        return lin.weight.grad is not None

    checks = {
        "all_gather_into_tensor": lambda: (dist.all_gather_into_tensor(o, x), o.tolist())[1]
        == [1, 1, 2, 2],
        "reduce_scatter_tensor": lambda: (dist.reduce_scatter_tensor(o[:2], torch.cat([x, 2 * x])),
                                          o[:2].tolist())[1] == [3 * (r + 1)] * 2,
        "all_reduce": lambda: (dist.all_reduce(o[2:].copy_(x)), o[2:].tolist())[1] == [3, 3],
        "broadcast": lambda: (dist.broadcast(o[2:].copy_(x), 0), o[2:].tolist())[1] == [1, 1],
        "fully_shard": fsdp2,
    }
    res = {}
    for name, fn in checks.items():
        try:
            res[name] = "ok" if fn() else "wrong values"
        except Exception as e:  # noqa: BLE001 - the refusal is the reading
            res[name] = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:160]}"
    return res


P2P_OPS = ("send_recv", "batch_isend_irecv")


def p2p_rank(op: str, out_path: str) -> None:
    """One rank of :func:`probe_p2p` (``python3 chip_smoke.py --p2p-rank op
    out``): ``op`` (one of P2P_OPS) between two ranks on CUDA tensors over
    ``MCA_DIST_BACKEND``; rank 0 writes "ok", "wrong values" or the
    error's first line."""
    device = torch.device("cuda")
    init_multihost(device="cuda")
    r = dist.get_rank()
    x, y = torch.full((4,), r + 1.0, device=device), torch.zeros(4, device=device)
    try:
        if op == "send_recv":
            if r == 0:
                dist.send(x, 1)
                dist.recv(y, 1)
            else:
                dist.recv(y, 0)
                dist.send(x, 0)
        else:
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - r),
                                           dist.P2POp(dist.irecv, y, 1 - r)])
            for q in reqs:
                q.wait()
        torch.cuda.synchronize()
        reading = "ok" if y.tolist() == [2.0 - r] * 4 else "wrong values"
    except Exception as e:  # noqa: BLE001 - the refusal is the reading
        reading = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:160]}"
    if r == 0:
        Path(out_path).write_text(reading)
    dist.destroy_process_group()


def probe_p2p(backend: str, tmp: Path) -> dict:
    """``send`` / ``recv`` and ``batch_isend_irecv`` on CUDA tensors between
    two ranks over ``backend``, each op in two processes of its own (gloo
    documents them for CPU tensors only, so an op may take its processes
    down, or hang them until a 60 s timeout): per op the reading, or how
    its processes ended.  A reading, not a gate: the ring shift's route
    is chosen by backend (``parallel/collectives.py``)."""
    res = {}
    for op in P2P_OPS:
        out = tmp / f"p2p_{backend}_{op}.txt"
        try:
            launch_lib.launch([sys.executable, str(ROOT / "chip_smoke.py"), "--p2p-rank", op,
                               str(out)], 2, timeout=60, log_dir=str(tmp / f"p2p_{op}_logs"),
                              env={"MCA_DIST_BACKEND": backend, "PYTHONPATH": str(ROOT)})
            res[op] = out.read_text()
        except launch_lib.LaunchError as e:
            lines = [ln for ln in str(e).splitlines() if ln.strip() and not ln.startswith("---")]
            res[op] = f"ranks failed: {lines[0][:120]} ({lines[-1][:160]})"
    return res


def model_key(mesh: dict) -> str:
    """The model overrides of a layout (MODEL_KEYS), as a key."""
    return json.dumps({k: mesh[k] for k in MODEL_KEYS if k in mesh}, sort_keys=True)


def layout_launches(cfg, mesh: dict) -> int:
    """K1 (and K2) launches a step on each rank of a layout: once a block
    and ``grad_accum`` microbatch, or, under ``mesh_pipe``, once a block of
    the rank's stage and microbatch: ``(L / S) * M``."""
    depth, stages = int(cfg.layers), int(mesh.get("mesh_pipe", 1))
    if stages == 1:
        return depth * int(mesh.get("grad_accum", 1))
    rows = int(cfg.batch_size) // int(mesh.get("mesh_data", 1))
    micro = int(mesh.get("pipeline_microbatches", 0) or stages)
    return depth // stages * pipeline.local_microbatches(rows, micro)


def moe_leaves(params: dict) -> dict:
    return {k: v for k, v in params.items() if ".ff.router." in k or ".ff.experts." in k}


def parallel_rank(job_path: str) -> None:
    """One rank of :func:`check_layouts` (``python3 chip_smoke.py
    --parallel-rank job.json``, started by ``mca_tpu_torch.parallel.launch``):
    each run of the job on ``MCA_DIST_BACKEND``, through :func:`par_steps`;
    the heads of every K1 and K2 launch are recorded; rank 0 writes the
    results."""
    job = json.loads(Path(job_path).read_text())
    device = torch.device(job["device"])
    init_multihost(device=device.type)  # MCA_DIST_BACKEND: launch_ranks sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    flash.default_bwd_impl = "fused"
    heads = {"fwd": [], "bwd": []}
    real_forward, real_bwd = flash._forward, flash.flash_bwd
    real_stage_input = pipeline.stage_input

    def forward(q, *a):
        heads["fwd"].append(int(q.shape[1]))
        return real_forward(q, *a)

    def bwd(q, *a):
        heads["bwd"].append(int(q.shape[1]))
        return real_bwd(q, *a)

    flash._forward, flash.flash_bwd = forward, bwd
    inputs = torch.load(job["inputs"], weights_only=False)
    config = training_config(job["config"])
    out = {}
    for run in job["runs"]:
        cfg = par_config(config, **run["mesh"])
        mesh = training_mesh(cfg, device)
        heads["fwd"].clear(), heads["bwd"].clear()
        res = par_steps(cfg, device, inputs["params"][model_key(run["mesh"])], inputs["batch"],
                        make_stager(mesh, int(cfg.batch_size)),
                        PLANTS[run.get("fault") or run.get("plant")])
        pipeline.stage_input = real_stage_input
        res["heads"] = {k: sorted(set(v)) for k, v in heads.items()}
        res["leaves"] = moe_leaves(res["params"])
        res["params"] = flat_params(res["params"])
        all_res = [None] * dist.get_world_size()
        dist.all_gather_object(all_res, {k: res[k] for k in ("launches", "heads", "wall_ms",
                                                             "peak_mib", "opt_mib", "resident",
                                                             "raw", "allocated_drop",
                                                             "n_tensors")})
        res["ranks"] = all_res
        out[run["name"]] = res
    if job.get("probe"):  # after the runs, which it cannot then disturb
        out["probe"] = probe_collectives(device)
    if dist.get_rank() == 0:
        torch.save(out, job["out"])
    dist.barrier()
    dist.destroy_process_group()


def infer_rank(cfg_path: str, counts_path: str, device: str) -> None:
    """One rank of phase 14 (c): ``python -m mca_tpu_torch.infer``'s
    ``main`` on ``PAR_INFER_ROWS`` synthetic rows; each rank writes its
    launch counts."""
    reset_launches()
    infer_lib.main([cfg_path, "--synthetic", str(PAR_INFER_ROWS), "--device", device])
    rank = dist.get_rank() if dist.is_initialized() else 0
    Path(f"{counts_path}.rank{rank}").write_text(json.dumps(launches_now()))


def launch_ranks(argv: list, log_dir: Path, world: int = 2, backend: str = "gloo") -> None:
    """``world`` ranks of ``argv`` over ``backend`` (rank r on card r
    modulo the cards there are), ended together if one fails or they
    outlive ``PAR_TIMEOUT``."""
    try:
        launch_lib.launch(argv, world, timeout=PAR_TIMEOUT, log_dir=str(log_dir),
                          env={"MCA_DIST_BACKEND": backend, "PYTHONPATH": str(ROOT)})
    except launch_lib.LaunchError as e:
        raise AssertionError(f"parallel ranks: {e}") from None


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_layouts(config, device, card: str, batch, tmp: Path, world: int, backend: str,
                  layouts: dict, faults: dict, label: str, plants: dict = None) -> tuple:
    """``world`` ranks over ``backend`` (started by :func:`launch_ranks`),
    each layout of ``layouts`` (mesh keys, and the MODEL_KEYS that change
    ``config``'s model) and, for each, its planted faults of ``faults``,
    PAR_STEPS steps from the seed-0 weights on ``batch``, held to the same
    model's steps unsharded in this process on the fused route: K1 and K2
    :func:`layout_launches` times a step on every rank, at the heads the
    model axis leaves; per-step total_loss, grad_norm and param_norm, the
    final parameters' update and, for a MoE model, each expert leaf's and
    each router leaf's update, within PAR_BOUNDS, on CUDA each rank's
    resident bytes equal to plan_parallel's state bytes for the layout but
    for the allocator's rounding (ALLOC_ROUND a tensor), and each fault
    past the bound of each of its gates (FAULT_GATES).  ``plants`` names a
    plant a layout runs with (not gated on resident bytes).  Prints each
    rank's wall ms a step, peak device memory, optimizer state and
    resident bytes, and over gloo which collectives it accepts.  Returns
    the launches of the layouts' runs, summed over the ranks, and each
    run's results by name."""
    plants = plants or {}
    refs = {}
    for mesh in layouts.values():
        key = model_key(mesh)
        if key not in refs:
            cfg = par_config(config, **json.loads(key))
            params = {k: v.clone() for k, v in seed_model(cfg).state_dict().items()}
            ref = par_steps(cfg, device, params, batch)
            refs[key] = {"cfg": cfg, "params": params, "ref": ref,
                         "update": flat_params(ref["params"]) - flat_params(params),
                         "leaf_update": {k: v - params[k]
                                         for k, v in moe_leaves(ref["params"]).items()}}
    torch.save({"params": {k: r["params"] for k, r in refs.items()}, "batch": batch},
               tmp / "par_inputs.pt")
    # a rank's state on each layout, as plan_parallel predicts it
    metas = {key: plan_tool._meta_model(r["cfg"]) for key, r in refs.items()}
    predicted = {name: plan_tool._sharded_bytes(refs[model_key(mesh)]["cfg"],
                                                int(mesh.get("mesh_data", 1)),
                                                int(mesh.get("mesh_model", 1)),
                                                bool(mesh.get("fsdp", False)),
                                                model=metas[model_key(mesh)])
                 + plan_tool._buffer_bytes(metas[model_key(mesh)])
                 for name, mesh in layouts.items() if name not in plants}
    runs = [{"name": name if fault is None else f"{name}+{fault}", "mesh": mesh, "fault": fault,
             "plant": plants.get(name) if fault is None else None}
            for name, mesh in layouts.items() for fault in [None, *faults[name]]]
    job = {"config": str(CONFIG), "device": device.type, "inputs": str(tmp / "par_inputs.pt"),
           "out": str(tmp / "par_out.pt"), "runs": runs, "probe": backend == "gloo"}
    (tmp / "par_job.json").write_text(json.dumps(job))
    t0 = time.perf_counter()
    launch_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank",
                  str(tmp / "par_job.json")], tmp / "par_logs", world, backend)
    launch_s = time.perf_counter() - t0
    out = torch.load(tmp / "par_out.pt", weights_only=False)

    def gaps(res, r, name) -> dict:
        ref = r["ref"]
        per_step = {k: max(abs(m[k] - w[k]) / abs(w[k])
                           for m, w in zip(res["metrics"], ref["metrics"]))
                    for k in ("total_loss", "grad_norm", "param_norm")}
        g = {"loss": per_step["total_loss"], "grad_norm": per_step["grad_norm"],
             "param_norm": per_step["param_norm"],
             "update": rel_l2(res["params"] - flat_params(r["params"]), r["update"])}
        leaf = {k: rel_l2(v - r["params"][k], r["leaf_update"][k])
                for k, v in res["leaves"].items()}
        for gate, part in (("experts", ".ff.experts."), ("router", ".ff.router.")):
            if any(part in k for k in leaf):
                g[gate] = max(v for k, v in leaf.items() if part in k)
        if name in predicted and res["ranks"][0]["resident"] is not None:
            g["resident"] = max(abs(rank["resident"] - predicted[name])
                                - ALLOC_ROUND * rank["n_tensors"] for rank in res["ranks"])
        return g

    def show(g: dict) -> str:
        return ", ".join(f"{k} {v:.3e}" for k, v in g.items())

    def mib(x) -> str:
        return "not measured" if x is None else f"{x:.1f}"

    counts = dict.fromkeys(launches_now(), 0)
    for name, mesh in layouts.items():
        res, r = out[name], refs[model_key(mesh)]
        n = layout_launches(r["cfg"], mesh)
        want_heads = [int(r["cfg"].heads) // int(mesh.get("mesh_model", 1))]
        for rank_i, rank in enumerate(res["ranks"]):
            for c in rank["launches"]:
                assert c == {**dict.fromkeys(c, 0), "flash_fwd": n, "flash_bwd": n}, \
                    (name, rank_i, c)
            assert rank["heads"] == {"fwd": want_heads, "bwd": want_heads}, \
                (name, rank_i, rank["heads"])
            for k in counts:
                counts[k] += sum(c[k] for c in rank["launches"])
        held = gaps(res, r, name)
        planted = {f: gaps(out[f"{name}+{f}"], r, name) for f in faults[name]}
        walls = "; ".join(f"rank {i} " + ", ".join(f"{x:.3f}" for x in rank["wall_ms"])
                          for i, rank in enumerate(res["ranks"]))
        memory = "; ".join(
            f"rank {i} peak {mib(rank['peak_mib'])}, optimizer state {rank['opt_mib']:.1f}, "
            f"resident {rank['resident']} B ({rank['n_tensors']} tensors; memory_allocated "
            f"less the batch {rank['raw']} B, its drop {rank['allocated_drop']} B)"
            for i, rank in enumerate(res["ranks"]))
        if name in predicted:
            memory += f"; predicted state {predicted[name]} B (plan_parallel)"
        print(
            f"{label} {name} ({mesh}): {world} ranks over {backend} against the unsharded steps "
            f"(fused backward): largest per-step gap {show(held)} (bounds "
            f"{show({k: PAR_BOUNDS[k] for k in held})}); "
            + "".join(f"planted {f} ({'/'.join(FAULT_GATES[f])} must fail): {show(g)}; "
                      for f, g in planted.items())
            + f"K1 {n} + K2 {n} a step on each rank at H {want_heads[0]}; wall ms a step {walls}; "
            f"unsharded {', '.join(f'{x:.3f}' for x in r['ref']['wall_ms'])}; MiB {memory} "
            f"(unsharded peak {mib(r['ref']['peak_mib'])}, optimizer state "
            f"{r['ref']['opt_mib']:.1f})",
            flush=True,
        )
        for gate, value in held.items():
            assert value <= PAR_BOUNDS[gate], (name, gate, value)
        for f, g in planted.items():
            for gate in FAULT_GATES[f]:
                assert g[gate] > PAR_BOUNDS[gate], (name, f, gate, g)
    if "probe" in out:
        print(f"{label}: {backend} on {device.type} tensors, two ranks: {out['probe']}", flush=True)
    print(f"{label}: the launch took {launch_s:.1f} s; {host_description()}; {card}", flush=True)
    return counts, out


def par_inputs(config) -> tuple:
    """Phase 14's configuration, seed-0 weights and one collated batch of
    ``synthetic_rows``."""
    cfg = par_config(config)
    batch = MultimodalCollator(cfg.modality_config.to_plain())(
        synthetic_rows(cfg, int(cfg.batch_size)))
    return cfg, {k: v.clone() for k, v in seed_model(cfg).state_dict().items()}, batch


#: ``--parallel-cards N``: each layout with its planted faults, NCCL, a
#: rank a card; the last three are phase 15's at four ranks (depth 4)
CARD_FAULTS = {"dp_fsdp": ["none_gather", "unscaled_grads"], "tcga_parallel": ["skip_out_reduce"],
               "dp_pp_fsdp": [], "tp_pp": [], "dp_ep": []}


def card_layouts(world: int) -> dict:
    return {"dp_fsdp": {"mesh_data": world, "fsdp": True},
            "tcga_parallel": {"mesh_data": world // 2, "mesh_model": 2, "fsdp": True,
                              "seq_shard": True},
            "dp_pp_fsdp": {"layers": 4, "mesh_data": world // 2, "mesh_pipe": 2, "fsdp": True},
            "tp_pp": {"layers": 4, "mesh_data": world // 4, "mesh_model": 2, "mesh_pipe": 2},
            "dp_ep": {"layers": 4, "moe_experts": 4, "moe_capacity_factor": MOE_CF,
                      "mesh_data": world // 2, "mesh_model": 2}}


def parallel_cards(world: int) -> int:
    """``python3 chip_smoke.py --parallel-cards N``: phases 14 (b) and 15's
    checks over NCCL on N cards of one host, one rank a card: DP + FSDP
    over all N, ``configs/tcga_parallel.yaml``'s layout (data N / 2 x
    model 2, fsdp, seq_shard), data N / 2 x pipe 2 + fsdp, model 2 x pipe 2
    (TP inside the stages) and data N / 2 x model 2 with 4 experts (EP),
    the last three at depth 4, against the unsharded steps on card 0;
    then NCCL's point-to-point ops on CUDA tensors.  Not part of the
    one-card run."""
    if torch.cuda.device_count() < world:
        print(f"chip_smoke: --parallel-cards {world} needs {world} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print("\n".join(card), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    config = training_config(str(CONFIG))
    _, _, batch = par_inputs(config)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as tmp:
        counts, _ = check_layouts(config, torch.device("cuda"), card[0], batch, Path(tmp), world,
                                  "nccl", card_layouts(world), CARD_FAULTS, f"{world} cards")
        print(f"{world} cards: nccl point to point on cuda tensors, two ranks: "
              f"{probe_p2p('nccl', Path(tmp))}", flush=True)
    print(json.dumps({"launches": counts}), flush=True)
    return 0


def check_parallel(device, card: str, tmp: Path) -> dict:
    """Phase 14, data and tensor parallelism (module docstring); returns
    the launches of its main paths."""
    config = training_config(str(CONFIG))
    cfg, params, batch = par_inputs(config)
    bs = int(cfg.batch_size)
    counts = dict.fromkeys(launches_now(), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    # (a) NCCL, world 1, on the split (deterministic) backward
    old_cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    flash.default_bwd_impl = "split"
    env = {"MCA_MULTIHOST": "auto", "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    try:
        alone = par_steps(cfg, device, params, batch)
        with mock.patch.dict(os.environ, env):
            assert init_multihost(device=device.type)
        backend = {"cuda": "nccl", "cpu": "gloo"}[device.type]
        assert dist.get_backend() == backend and dist.get_world_size() == 1
        cfg_a = par_config(config, mesh_data=0, fsdp=True)
        reset_launches()
        grouped = par_steps(cfg_a, device, params, batch)
        add(launches_now())
        model = build_trainer(cfg_a, device.type, params=grouped["params"])[0]
        Checkpointer().save_state({"model": model.state_dict(), "step": PAR_STEPS, "epoch": 0},
                                  str(tmp / "a"))
        del model
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        flash.default_bwd_impl = "fused"
        if old_cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old_cublas
    n = int(cfg.layers)
    for c in grouped["launches"]:
        assert c == {**dict.fromkeys(c, 0), "flash_fwd": n, "flash_bwd_dq": n,
                     "flash_bwd_dkv": n}, c
    a_losses = [m["total_loss"] for m in grouped["metrics"]]
    assert a_losses == [m["total_loss"] for m in alone["metrics"]], (a_losses, alone["metrics"])
    for k, v in alone["params"].items():
        assert torch.equal(v, grouped["params"][k]), f"phase 14 (a): {k} differs"
    svc = EmbeddingService(cfg, restart=str(tmp / "a"), device=device, max_batch=bs)
    reset_launches()
    served = svc.embed(request_rows(cfg, bs))
    add(launches_now())
    assert (flash.launches, ff.launches) == (n, n), (flash.launches, ff.launches)
    assert all(np.isfinite(e).all() for e in served["embeddings"].values())
    del svc
    print(
        f"phase 14 (a): 3 steps through init_multihost ({backend}, world 1, mesh_data 0, fsdp) "
        f"bitwise equal to the same steps without a process group (split backward): "
        f"total_loss {a_losses}; K1 {n} + K3a {n} + K3b {n} a step; serve --restart of its "
        f"checkpoint: one batch of {bs}, K1 {n} + K5 {n}; wall ms a step "
        f"{', '.join(f'{x:.3f}' for x in grouped['wall_ms'])} (without a group "
        f"{', '.join(f'{x:.3f}' for x in alone['wall_ms'])}); {card}",
        flush=True,
    )

    # (b) two ranks on the one card over gloo, against the unsharded steps
    add(check_layouts(config, device, card, batch, tmp, 2, "gloo", PAR_LAYOUTS,
                      PAR_FAULTS, "phase 14 (b)")[0])

    # (c) infer at 2 ranks against 1, from (a)'s checkpoint
    base = load_yaml(str(CONFIG))
    files = {}
    for world in (1, 2):
        out_dir = tmp / f"infer{world}"
        path = tmp / f"infer{world}.yaml"
        path.write_text(yaml.safe_dump({**base, "restart": str(tmp / "a"), "split": RUN_SPLIT,
                                        "output_dir": str(out_dir), "mesh_data": world},
                                       sort_keys=False))  # the modalities' order is the model's
        if world == 1:
            reset_launches()
            infer_lib.main([str(path), "--synthetic", str(PAR_INFER_ROWS), "--device",
                            device.type])
            one_counts = launches_now()
        else:
            launch_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--infer-rank", str(path),
                          str(tmp / "infer_counts"), device.type], tmp / "infer_logs")
            for r in range(2):
                rank_counts = json.loads(Path(f"{tmp / 'infer_counts'}.rank{r}").read_text())
                assert rank_counts == one_counts, (r, rank_counts, one_counts)
                add(rank_counts)
        files[world] = read_eval_files(out_dir)
    assert one_counts["flash_fwd"] == one_counts["geglu_ff"] > 0, one_counts
    gap = 0.0
    for split in ("train", "eval"):
        emb = [files[w][f"{split}_embeddings"] for w in (1, 2)]
        msk = [files[w][f"{split}_masks"] for w in (1, 2)]
        assert emb[0].keys() == emb[1].keys() and msk[0].keys() == msk[1].keys(), split
        for k in msk[0]:
            assert np.array_equal(msk[0][k], msk[1][k]), (split, k)
        assert np.array_equal(files[1][f"{split}_labels"], files[2][f"{split}_labels"]), split
        for k in emb[0]:
            gap = max(gap, float(np.abs(emb[0][k] - emb[1][k]).max()))
    assert gap <= AGREE_ATOL, gap
    print(
        f"phase 14 (c): infer at 2 ranks (gloo, {PAR_INFER_ROWS} rows) against 1 from (a)'s "
        f"checkpoint: keys, masks, labels and row order equal, embeddings at most {gap:.3e} "
        f"apart (bound {AGREE_ATOL}); world-1 launches {one_counts}",
        flush=True,
    )
    return counts


def check_pipe_ep(device, card: str, tmp: Path) -> dict:
    """Phase 15, GPipe and expert parallelism (module docstring); returns
    the launches of its main paths."""
    config = training_config(str(CONFIG))
    _, _, batch = par_inputs(config)
    counts, _ = check_layouts(config, device, card, batch, tmp, 2, "gloo", PIPE_EP_LAYOUTS,
                              PIPE_EP_FAULTS, "phase 15")
    print(f"phase 15: gloo point to point on {device.type} tensors, two ranks: "
          f"{probe_p2p('gloo', tmp)}; the ring shift takes "
          f"{'an all_gather over pipe' if device.type == 'cuda' else 'batch_isend_irecv'} "
          f"on gloo {device.type} tensors", flush=True)
    return counts


def exact_resident_gap(reports: list, predicted: int) -> int:
    """The largest gap between a rank's resident bytes and ``predicted``,
    beyond the allocator's rounding of the rank's state tensors."""
    return max(abs(r["resident_bytes"] - predicted) - ALLOC_ROUND * r["state_tensors"]
               for r in reports)


def trace_kernel_counts(path: Path) -> dict:
    """How often each of TRACE_KERNELS' kernels runs in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(fn in n for n in names) for k, fn in TRACE_KERNELS.items()}


def check_plan(config) -> None:
    """Phase 16 (c): ``plan_parallel --devices 2 --exact --json`` as a
    user runs it, in a process of its own: it reads its activation model
    at the fewest rows a plan gives a microbatch and at the batch of 8,
    with its accumulation term at ``grad_accum: 2`` over the fewest rows,
    and measures the top plans' ranks; each rank's resident bytes equal
    the plan's state bytes, and measured peak <= predicted <= 1.25 x
    measured."""
    mib = 2.0**-20
    lo, hi = plan_tool.probe_rows(config, plan_tool.enumerate_plans(config, PLAN_DEVICES))
    assert hi == int(config.batch_size), (lo, hi)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mca_tpu_torch.tools.plan_parallel", str(CONFIG), "--devices",
         str(PLAN_DEVICES), "--topk", str(PLAN_TOPK), "--exact", "--json", "--reading-jobs",
         str(PLAN_READING_JOBS)],
        cwd=ROOT, capture_output=True, text=True, timeout=PLAN_TIMEOUT,
        env={**os.environ,
             "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")})
    tool_s = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-4000:]
    plans = json.loads([ln for ln in res.stdout.splitlines() if ln.startswith("[")][-1])
    measured = [p for p in plans if p["pp"] == 1]
    assert measured and all(p["exact"] for p in measured), plans
    for p in measured:
        gap = exact_resident_gap(p["exact"], p["state_bytes"])
        peaks = [r["peak_estimate_bytes"] for r in p["exact"]]
        pred = p["peak_bytes"]
        print(f"phase 16 (c): plan {p['config_stanza']}: state predicted {p['state_bytes']} B, "
              f"resident a rank {[r['resident_bytes'] for r in p['exact']]} B "
              f"({[r['state_tensors'] for r in p['exact']]} tensors, ranks over "
              f"{p['exact'][0]['dist_backend']}); peak predicted {pred * mib:.1f} MiB "
              f"(activations {p['act_bytes'] * mib:.1f}, read by the tool's own process), "
              f"measured {[round(x * mib, 1) for x in peaks]} (predicted / measured "
              f"{', '.join(f'{pred / x:.4f}' for x in peaks)}, bounds 1 and "
              f"{PLAN_PEAK_OVER}); est {p['est_step_ms']:.3f} ms a step", flush=True)
        assert gap <= 0, (p, gap)
        for x in peaks:
            assert x <= pred <= PLAN_PEAK_OVER * x, (p["config_stanza"], pred, x)
    print(f"phase 16 (c): plan_parallel --devices {PLAN_DEVICES} --topk {PLAN_TOPK} --exact "
          f"--json --reading-jobs {PLAN_READING_JOBS}, its activation model read at {lo} and "
          f"{hi} rows: {tool_s:.1f} s", flush=True)
    # the reading the accumulation term rests on, in a process of its own
    # (the tool's) and in this one, after the earlier phases
    cfg = type(config)(config)
    cfg.batch_size = 2 * lo
    fresh = plan_tool.fresh_step_memory(cfg, grad_accum=2)
    here = memory_report.step_memory(cfg, grad_accum=2)
    print(f"phase 16 (c): {lo} row a microbatch, grad_accum 2: peak "
          f"{fresh['peak_estimate_bytes']} B, reading {plan_tool.step_reading(fresh)} B in a "
          f"fresh process; {here['peak_estimate_bytes']} B, "
          f"{plan_tool.step_reading(here)} B in this one", flush=True)


def check_zero3(device, card: str, tmp: Path) -> dict:
    """Phase 16, ZeRO-3, ``memory_report``, ``plan_parallel`` and
    ``trace_dir`` (module docstring); returns the launches of its main
    paths."""
    config = training_config(str(CONFIG))
    _, _, batch = par_inputs(config)

    # (a) ZeRO-3 at two ranks against the unsharded steps; PR 14's layout beside it
    counts, out = check_layouts(config, device, card, batch, tmp, 2, "gloo", ZERO3_LAYOUTS,
                                ZERO3_FAULTS, "phase 16 (a)", plants=ZERO3_PLANTS)
    peaks = [(z["peak_mib"], m["peak_mib"])
             for z, m in zip(out["zero3"]["ranks"], out["moments_only"]["ranks"])]
    print("phase 16 (a): peak MiB a rank, ZeRO-3 against PR 14's optimizer-state-only "
          "layout: " + "; ".join(f"rank {i} {z:.1f} against {m:.1f}"
                                 for i, (z, m) in enumerate(peaks)) + f"; {card}", flush=True)
    for z, m in peaks:
        assert z < m, peaks

    # (b) memory_report on one process: grad_accum and remat against the base
    reset_launches()
    base = memory_report.step_memory(config, device=device.type)
    for k, v in launches_now().items():
        counts[k] += v
    accum = memory_report.step_memory(config, grad_accum=MEMREPORT_ACCUM, device=device.type)
    remat = memory_report.step_memory(config, remat=True, device=device.type)
    for name, rep in (("base", base), (f"grad_accum {MEMREPORT_ACCUM}", accum), ("remat", remat)):
        print(f"phase 16 (b): memory_report TCGA_config1 {name}: "
              + ", ".join(f"{k} {v}" for k, v in rep.items()), flush=True)
    # plan_parallel's two measured figures: a step's wall and device time,
    # plain and under remat (PROFILED_STEPS steps each after a warm-up)
    params = seed_model(config).state_dict()
    rows = synthetic_rows(config, int(config.batch_size))
    plain_t = profiled_steps(config, device, params, rows)
    remat_t = profiled_steps(run_config(config, tmp / "remat_t", remat=True), device, params, rows)
    mfu = plan_tool.flops_per_step(config) / (1e-3 * plain_t["wall_ms"] * plan_tool.H100.peak_flops)
    print(f"phase 16 (b): a step (mean of {PROFILED_STEPS}) {plain_t['wall_ms']:.3f} ms wall, "
          f"{plain_t['device_ms']:.3f} ms device busy; under remat {remat_t['wall_ms']:.3f} / "
          f"{remat_t['device_ms']:.3f}: remat cost {remat_t['device_ms'] / plain_t['device_ms']:.4f} "
          f"on the device, {remat_t['wall_ms'] / plain_t['wall_ms']:.4f} on the wall; model FLOPs "
          f"utilisation {mfu:.5f} ({plan_tool.flops_per_step(config):.4e} FLOPs a step over its "
          f"wall at 989 TFLOP/s); plan_parallel's H100 model: mfu {plan_tool.H100.mfu}, "
          f"remat_cost {plan_tool.H100.remat_cost}; {host_description()}; {card}", flush=True)
    assert accum["temp_size_in_bytes"] < ACCUM_TEMP_SHARE * base["temp_size_in_bytes"], (accum,
                                                                                         base)
    assert accum["argument_size_in_bytes"] == base["argument_size_in_bytes"], (accum, base)
    assert remat["temp_size_in_bytes"] < base["temp_size_in_bytes"], (remat, base)

    check_plan(config)

    # (d) trace_dir: a short run traces its second step
    rows = synthetic_rows(config, TRACE_STEPS * int(config.batch_size) + 2, seed=0)
    cfg = run_config(config, tmp / "trace_run", epochs=1, trace_dir=str(tmp / "trace"),
                     split=2, run_eval_loop=False)  # 2 eval rows: TRACE_STEPS batches train
    reset_launches()
    train(cfg, device.type, rows=rows)
    for k, v in launches_now().items():
        counts[k] += v
    traces = sorted((tmp / "trace").iterdir())
    assert [t.name for t in traces] == ["step2.rank0.json"], traces
    found = trace_kernel_counts(traces[0])
    depth = int(config.layers)
    print(f"phase 16 (d): trace_dir: {traces[0].name}, {traces[0].stat().st_size} bytes; "
          f"kernels in the traced step {found} (a step launches {depth} of each)", flush=True)
    assert found == dict.fromkeys(TRACE_KERNELS, depth), found
    return counts


# ---------------------------------------------------------------------------
# phase 17: attention_impl segmented, attention_maps, import_checkpoint,
# one sweep cell and a reproduce pipeline
# ---------------------------------------------------------------------------


def with_impl(config, impl: str):
    """``config`` with ``attention_impl: impl``."""
    cfg = type(config)(config)
    cfg.attention_impl = impl
    return cfg


def segments_of(config) -> int:
    """The self-attention segments of ``config``'s mask (K1 / K2 launches
    a block on the segmented path)."""
    mods = config.modality_config.to_plain()
    ms = build_masks([int(mods[m]["pad_len"]) for m in config.encoder_configs],
                     int(config.num_fusion_tokens), list(config.fusion_combos),
                     zorro=bool(config.zorro), fcl=bool(config.fcl))
    return len(segmented.analyze_mask(ms.attn_mask)[0])


def embed_forward(config, params, device, batch) -> dict:
    """The serving forward (fused feed-forward) of ``config``'s model on
    ``params``: the embeddings as fp32 CPU tensors, and the model."""
    model = build_model(get_model_config(config), fused_ff=True)
    model.load_state_dict(params, strict=True)
    model.to(device).eval()
    with torch.inference_mode():
        out = model(to_device(batch, device), no_loss=True)
        emb = {k: out[k].float().cpu() for k in model.loss.output_keys()}
    return emb, model


def check_segmented_forward(config, device, label: str, cpu_device="cpu") -> dict:
    """Phase 17 (a) (and (c)'s CMU forward without ``cpu_device``): the
    segmented serving forward at the config's full width and depth, batch
    of 8, against the monolithic K1 forward on the same weights and
    against fp32 on the CPU, per key; K1 a segment a block, K5 a block.
    Returns its launches."""
    seg, mono = with_impl(config, "segmented"), with_impl(config, "pallas")
    depth, n_seg = int(config.layers), segments_of(config)
    params = seed_model(config).state_dict()
    batch = MultimodalCollator(config.modality_config.to_plain())(
        synthetic_rows(config, int(config.batch_size)))
    reset_launches()
    got, seg_model = embed_forward(seg, params, device, batch)  # the main path
    launched = launches_now()
    assert launched == {"flash_fwd": n_seg * depth, "geglu_ff": depth,
                        **dict.fromkeys(flash.bwd_launches, 0)}, (label, launched)
    want, mono_model = embed_forward(mono, params, device, batch)
    keys = sorted(got)
    rel = {k: rel_l2(got[k], want[k]) for k in keys}
    gates = {"monolithic": max(rel.values())}
    if cpu_device is not None:
        cpu32 = type(seg)(seg)
        cpu32.precision = "fp32"
        ref, _ = embed_forward(cpu32, params, cpu_device, batch)
        gates["fp32 CPU"] = max(rel_l2(got[k], ref[k]) for k in keys)
    staged = to_device(batch, device)
    with torch.inference_mode():
        times = {name: device_busy_ms(lambda m=m: m(staged, no_loss=True))
                 for name, m in (("segmented", seg_model), ("monolithic", mono_model))}
    print(f"{label}: segmented forward, {n_seg} segments a block: launches {launched}; "
          f"embeddings against the monolithic K1 forward, relative L2 per key at most "
          f"{gates['monolithic']:.3e}"
          + (f", against fp32 on the CPU {gates['fp32 CPU']:.3e}" if cpu_device else "")
          + f" (bound {SLICE_REL_L2}); ms a batch-8 forward (wall / device busy): "
          + "; ".join(f"{n} {t['wall_ms']:.3f} / {t['device_ms']:.3f}"
                      for n, t in times.items()), flush=True)
    for name, g in gates.items():
        assert g <= SLICE_REL_L2, (label, name, g)
    del seg_model, mono_model
    return {"flash_fwd": launched["flash_fwd"], "geglu_ff": launched["geglu_ff"]}


def check_segmented_step(config, device) -> dict:
    """Phase 17 (b): the segmented training step at TCGA_config1, through
    the fused backward (K2 a segment a block) and the split one (K3a +
    K3b), ``SEG_STEPS`` steps each with finite metrics; the first step's
    loss, flat gradient and attention leaves against the monolithic K1 /
    K2 step from the same weights, with phase 6's bounds; the two routes'
    q / kv leaves against each other.  Returns the launches."""
    seg, mono = with_impl(config, "segmented"), with_impl(config, "pallas")
    for cfg in (seg, mono):
        cfg.num_warmup_steps = TRAIN_WARMUP
    depth, n_seg = int(config.layers), segments_of(config)
    params = seed_model(config).state_dict()
    rows = synthetic_rows(config, int(config.batch_size))
    batch = to_device(MultimodalCollator(config.modality_config.to_plain())(rows), device)
    counts = {}
    for impl in ("fused", "split"):
        flash.default_bwd_impl = impl
        try:
            model, opt, sched = build_trainer(seg, device.type, num_training_steps=SEG_STEPS,
                                              params=params)
            reset_launches()
            history = [train_step(model, opt, sched, batch, clip=float(seg.clip))
                       for _ in range(SEG_STEPS)]  # the main path
            counts[impl] = launches_now()
        finally:
            flash.default_bwd_impl = "fused"
        n = n_seg * depth * SEG_STEPS
        want = {"flash_fwd": n, "geglu_ff": 0, "flash_bwd": n if impl == "fused" else 0,
                "flash_bwd_dq": n if impl == "split" else 0,
                "flash_bwd_dkv": n if impl == "split" else 0}
        assert counts[impl] == want, (impl, counts[impl])
        for m in history:
            assert all(math.isfinite(m[k]) for k in ("total_loss", "grad_norm", "param_norm")), m
        del model, opt, sched

    def first_step(cfg, impl="fused"):
        flash.default_bwd_impl = impl
        try:
            model = build_trainer(cfg, device.type, params=params)[0]
            loss = float(forward_backward(model, batch)["total_loss"])
        finally:
            flash.default_bwd_impl = "fused"
        return loss, {n: p.grad.float().cpu() for n, p in model.named_parameters()}

    seg_loss, seg_g = first_step(seg)
    _, split_g = first_step(seg, "split")
    mono_loss, mono_g = first_step(mono)
    loss_rel = abs(seg_loss - mono_loss) / abs(mono_loss)
    grad_rel = rel_l2(torch.cat([g.reshape(-1) for g in seg_g.values()]),
                      torch.cat([g.reshape(-1) for g in mono_g.values()]))
    attn_rel = max(rel_l2(seg_g[n], mono_g[n]) for n in attention_leaves(seg_g))
    route_rel = max(rel_l2(split_g[n], seg_g[n])
                    for n in attention_leaves(seg_g, ("to_q", "to_kv")))
    times = {name: profiled_steps(cfg, device, params, rows)
             for name, cfg in (("segmented", seg), ("monolithic", mono))}
    print(f"seg (b): launches over {SEG_STEPS} steps, fused {counts['fused']}, split "
          f"{counts['split']}; first step against the monolithic K1 / K2 step: loss "
          f"{seg_loss:.6f} vs {mono_loss:.6f} (relative {loss_rel:.3e}, bound "
          f"{TRAIN_LOSS_RTOL}), gradient relative L2 {grad_rel:.3e} (bound "
          f"{TRAIN_GRAD_REL_L2}), attention projections at most {attn_rel:.3e} (bound "
          f"{TRAIN_ATTN_GRAD_REL_L2}); split vs fused q / kv at most {route_rel:.3e} (bound "
          f"{TRAIN_ROUTE_GRAD_REL_L2}); ms a step (wall / device busy): "
          + "; ".join(f"{n} {t['wall_ms']:.3f} / {t['device_ms']:.3f}" for n, t in times.items())
          + "; segmented top kernels "
          + ", ".join(f"{k[:40]} {v:.3f}" for k, v in times["segmented"]["top"]), flush=True)
    assert loss_rel <= TRAIN_LOSS_RTOL, (seg_loss, mono_loss)
    assert grad_rel <= TRAIN_GRAD_REL_L2, grad_rel
    assert attn_rel <= TRAIN_ATTN_GRAD_REL_L2, attn_rel
    assert route_rel <= TRAIN_ROUTE_GRAD_REL_L2, route_rel
    return {k: counts["fused"][k] + counts["split"][k] for k in counts["fused"]}


def check_segment_kernels(device) -> None:
    """Phase 17 (c): K1 and K2 / K3a / K3b against their plain versions,
    unmasked, at CMU_config1's segment lengths, batch 8 x 8 heads, ragged
    key padding (sample 0 at full length) and a sample without the
    modality; each with its planted faults (at one tile, the tile itself)."""
    for t in SEG_LENGTHS:
        _, q, k, v, pad = flash_inputs(device, dims=(t,), masked=False, full_rows=(0,))
        held = hold_flash(None, q, k, v, pad)
        qi, kj, n_live, flagged = held["planted"]
        g = torch.Generator(device=device).manual_seed(t)
        do = torch.randn(q.shape, generator=g, device=device).to(torch.bfloat16)
        bwd = hold_flash_bwd(None, q, k, v, pad, do, f"seg (c) T {t}")
        print(f"seg (c): T {t} ({-(-t // flash.BLOCK)} tiles), unmasked: K1 max_abs_err "
              f"{held['err']:.3e} (lse {held['lse_err']:.3e}), planted fault (tile q{qi} x "
              f"kv{kj}, {n_live} live entries, dropped) puts {flagged} entries outside "
              f"tolerance; backward relative L2 at most {max(bwd['rels'].values()):.3e}, "
              f"fused vs split {bwd['route_rel']:.3e}; planted faults "
              + ", ".join(f"{name} (q{f[0]} x kv{f[1]}) {min(f[3]):.3e}"
                          for name, f in bwd["planted"].items()), flush=True)
        del held, bwd, q, k, v, do, pad


def check_attention_maps(config, device, cpu_device="cpu") -> None:
    """Phase 17 (d): ``tools.attention_maps`` at full width on two rows
    (seed-0 weights): every row of every map sums to 1, blocked entries
    of a row with a live key are exactly 0 (a row with none is uniform,
    the dense path's semantics); layer 0 against fp32 on the CPU."""
    cfg = type(config)(config)
    cfg.split, cfg.batch_size = MAPS_SPLIT, MAPS_BATCH
    rows = synthetic_rows(cfg, MAPS_ROWS)
    t0 = time.perf_counter()
    maps = attention_maps.extract_attention_maps(cfg, rows=rows, device=device.type)
    gpu_s = time.perf_counter() - t0
    layers, pool = (torch.from_numpy(maps[k]) for k in ("layers", "pool"))
    depth, b, h, t, _ = layers.shape
    assert (depth, h, t) == (int(cfg.layers), int(cfg.heads), len(maps["token_types"])), \
        layers.shape
    assert pool.shape[:2] == (b, h) and pool.shape[-1] == t, pool.shape
    # the maps' own batch (the first of the train split) and its padding
    data = setup_data(rows, split=cfg.split, ds_frac=cfg.ds_frac, ds_seed=cfg.ds_seed)
    batch = to_device(BatchedLoader(data["train"], MultimodalCollator(
        cfg.modality_config.to_plain()), b).first_batch(), cpu_device)
    # layer 0 in fp32 on the CPU: a one-block model on the same weights
    cpu_cfg = type(cfg)(cfg)
    cpu_cfg.precision, cpu_cfg.layers = "fp32", 1
    cpu_model = build_model(get_model_config(cpu_cfg), fused_ff=False)
    full = seed_model(cfg).state_dict()
    cpu_model.load_state_dict({k: v for k, v in full.items() if k in cpu_model.state_dict()},
                              strict=True)
    with torch.inference_mode():
        pad = cpu_model.pack_sequence(batch)[1]
        ref0 = cpu_model.attention_maps(batch)["layers"][0]
    blocked = torch.from_numpy(cpu_model.mask_set.attn_mask)[None] | pad[:, None, :]  # [B, T, T]
    live = ~blocked.all(dim=2)
    sums = (layers.sum(-1) - 1).abs().max().item()
    pool_sums = (pool.sum(-1) - 1).abs().max().item()
    leak = float(layers.masked_select((blocked & live[..., None])[None, :, None]
                                      .expand_as(layers)).abs().max())
    rel0 = rel_l2(layers[0], ref0)
    print(f"maps (d): layers {tuple(layers.shape)} and pool {tuple(pool.shape)} in "
          f"{gpu_s:.1f} s, {maps['layers'].nbytes} bytes; rows sum to 1 within {sums:.2e} "
          f"(pool {pool_sums:.2e}, bound {MAPS_SUM_ATOL}); blocked entries of live rows at "
          f"most {leak!r}; {int((~live).sum())} rows with no live key; layer 0 against fp32 "
          f"on the CPU relative L2 {rel0:.3e} (bound {MAPS_REL_L2})", flush=True)
    assert max(sums, pool_sums) <= MAPS_SUM_ATOL, (sums, pool_sums)
    assert leak == 0.0, leak
    assert rel0 <= MAPS_REL_L2, rel0


def accelerate_dir(path: Path, model, opt, sched, modalities) -> None:
    """A trainer's state as an Accelerate ``save_state`` directory: the
    weights, the AdamW state dict keyed by the reference's parameter
    order and the scheduler's step."""
    path.mkdir(parents=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path / "pytorch_model.bin")
    names = [n for n, _ in model.named_parameters()]
    ref = interop.ref_param_names(names, modalities)
    sd = opt.state_dict()
    index = {n: i for i, n in enumerate(names)}
    state = {j: {k: v.cpu() if torch.is_tensor(v) else v
                 for k, v in sd["state"][index[n]].items()} for j, n in enumerate(ref)}
    torch.save({"state": state, "param_groups": [{**sd["param_groups"][0],
                                                  "params": list(range(len(ref)))}]},
               path / "optimizer.bin")
    torch.save({"last_epoch": sched.last_epoch}, path / "scheduler.bin")


def check_import_restart(config, device, tmp: Path) -> dict:
    """Phase 17 (e): ``tools.import_checkpoint --with-optimizer`` from an
    Accelerate directory written from a trainer after ``IMPORT_STEPS``
    steps (fp32 moments); one step restarted from the imported state (as
    ``restart:`` loads it) equals one step continued from the trainer, bit
    for bit, on the split backward with deterministic algorithms.
    Returns the restarted step's launches."""
    cfg = type(config)(config)
    cfg.num_warmup_steps = TRAIN_WARMUP
    path = tmp / "import.yaml"
    path.write_text(yaml.safe_dump(cfg.to_plain(), sort_keys=False))
    cfg = training_config(str(path))  # the modalities in the file's order
    batch = to_device(MultimodalCollator(cfg.modality_config.to_plain())(
        synthetic_rows(cfg, int(cfg.batch_size))), device)
    old_cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    flash.default_bwd_impl = "split"
    try:
        model, opt, sched = build_trainer(cfg, device.type, num_training_steps=IMPORT_HORIZON,
                                          params=seed_model(cfg).state_dict())
        for _ in range(IMPORT_STEPS):
            train_step(model, opt, sched, batch, clip=float(cfg.clip))
        accelerate_dir(tmp / "accelerate", model, opt, sched, list(cfg.encoder_configs))
        t0 = time.perf_counter()
        assert import_tool.main([str(path), str(tmp / "accelerate"), str(tmp / "imported"),
                                 "--with-optimizer"]) == 0
        import_s = time.perf_counter() - t0
        saved = load_state(str(tmp / "imported"))
        assert saved["step"] == IMPORT_STEPS, saved["step"]
        model2, opt2, sched2 = build_trainer(cfg, device.type,
                                             num_training_steps=IMPORT_HORIZON)
        load_train_state(saved, model2, opt2, sched2)
        reset_launches()
        restarted = train_step(model2, opt2, sched2, batch, clip=float(cfg.clip))  # main path
        launched = launches_now()
        continued = train_step(model, opt, sched, batch, clip=float(cfg.clip))
    finally:
        torch.use_deterministic_algorithms(False)
        flash.default_bwd_impl = "fused"
        if old_cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old_cublas
    depth = int(cfg.layers)
    assert launched == {"flash_fwd": depth, "geglu_ff": 0, "flash_bwd": 0,
                        "flash_bwd_dq": depth, "flash_bwd_dkv": depth}, launched
    a, b = dict(model.named_parameters()), dict(model2.named_parameters())
    unequal = [n for n in a if not torch.equal(a[n], b[n])]
    print(f"import (e): Accelerate directory from step {IMPORT_STEPS} imported in "
          f"{import_s:.1f} s (step {saved['step']}, lr {restarted['lr']:.6e} against "
          f"{continued['lr']:.6e}); the restarted step's total_loss "
          f"{restarted['total_loss']!r} against {continued['total_loss']!r} continued; "
          f"parameters after it unequal on {len(unequal)} of {len(a)} leaves", flush=True)
    assert restarted == continued, (restarted, continued)
    assert not unequal, unequal[:4]
    del model, opt, sched, model2, opt2, sched2
    return {k: v for k, v in launched.items() if v}


def check_sweep_reproduce(config, device, tmp: Path) -> None:
    """Phase 17 (f): one sweep cell (``SWEEP_CELL`` at the grid's canonical
    scale, one epoch) and a small reproduce pipeline (TCGA_config1, one
    epoch), each on rows held in memory: finite probe metrics, and the
    files each stage writes."""
    t0 = time.perf_counter()
    widths = {m: int(c["pad_len"]) for m, c in config.modality_config.items()}
    rows = sweep_tool.sweep_rows(n_samples=SWEEP_ROWS, widths=widths, seed=7)
    out = tmp / "sweep"
    args = sweep_tool.parse_args(["--out", str(out), "--scale", "canonical", "--cells",
                                  SWEEP_CELL, "--epochs", "1", "--probe-epochs",
                                  str(SWEEP_PROBE_EPOCHS), "--n-samples", str(SWEEP_ROWS)])
    (row,) = sweep_tool.run_sweep(args, device.type, rows=rows)
    sweep_s = time.perf_counter() - t0
    assert row["cell"] == SWEEP_CELL and row["device"] == torch.cuda.get_device_name(device)
    assert math.isfinite(row["final_train_loss"]), row
    assert row["probe"] and all(math.isfinite(v) for v in row["probe"].values()), row
    for rel in row["configs"].values():
        assert (out / rel).exists(), rel
    runs = out / "runs"
    assert (runs / SWEEP_CELL / "0" / "state" / "state.pt").exists()
    assert all(os.path.exists(p) for p in infer_lib.output_files(str(runs / f"{SWEEP_CELL}_infer")))
    assert (runs / f"{SWEEP_CELL}_probe" / "probe_result.json").exists()
    assert json.loads((out / "sweep_grid.jsonl").read_text())["cell"] == SWEEP_CELL

    t1 = time.perf_counter()
    train_cfg = dict(config.to_plain(), epochs=1, split=REPRO_SPLIT,
                     num_warmup_steps=TRAIN_WARMUP, output_dir=str(tmp / "reproduce"))
    pipeline = {"train": train_cfg, "infer_epoch": -1,
                "probe": {"task": -1, "loss_type": "BCE", "epochs": REPRO_PROBE_EPOCHS,
                          "batch_size": 16, "rank_metrics": True}}
    summary = reproduce_tool.reproduce(pipeline, device.type,
                                       rows=synthetic_rows(config, REPRO_ROWS))
    repro_s = time.perf_counter() - t1
    assert list(summary) == ["dataset", "train_output", "inference", "probe"], summary
    assert (Path(summary["train_output"]) / "0" / "state" / "state.pt").exists()
    assert all(os.path.exists(p) for p in infer_lib.output_files(summary["inference"]))
    assert summary["probe"] and all(math.isfinite(v) for v in summary["probe"].values())
    print(f"sweep (f): cell {SWEEP_CELL} at TCGA_config1 scale on {SWEEP_ROWS} rows in "
          f"memory, one epoch, in {sweep_s:.1f} s: final train loss "
          f"{row['final_train_loss']:.5f}, eval_auroc {row['probe'].get('eval_auroc')}, "
          f"eval_f1 {row['probe'].get('eval_f1')}; reproduce on {REPRO_ROWS} rows in "
          f"{repro_s:.1f} s: probe eval_auroc {summary['probe'].get('eval_auroc')}, "
          f"eval_loss {summary['probe'].get('eval_loss')}", flush=True)


def check_segmented(device, tmp: Path) -> dict:
    """Phase 17 (module docstring); returns the launches of its main paths."""
    config = training_config(str(CONFIG))
    counts = dict.fromkeys(launches_now(), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    add(check_segmented_forward(config, device, "seg (a) TCGA_config1"))
    add(check_segmented_step(config, device))
    check_segment_kernels(device)
    add(check_segmented_forward(training_config(str(CMU_CONFIG)), device,
                                "seg (c) CMU_config1", cpu_device=None))
    check_attention_maps(config, device)
    add(check_import_restart(config, device, tmp))
    check_sweep_reproduce(config, device, tmp)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(host_description(), flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"mca_tpu_torch {mca_tpu_torch.__version__}",
        flush=True,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = t0 = time.perf_counter()
    seconds = {}  # each phase's wall seconds, printed together at the end

    def lap(name: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    reports = _build.build()
    print(f"built {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    check_hopper_sass(reports)
    check_counter_sass(reports["roofline_counter"])
    check_probe_sass(reports["probe_overlap"])

    lap("1 build and SASS")
    device = torch.device("cuda")
    kernels = [check_flash(device), check_ff(device)]
    lap("2-3 K1, K5")
    kernels += check_flash_bwd(device)
    lap("4 backward")
    config = training_config(str(CONFIG))
    counts = check_slice(config, device)
    lap("5 serving")
    counts.update(check_train(config, device)[0])
    lap("6 training step")
    rows = synthetic_rows(config, RUN_ROWS, seed=int(config.seed))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as tmp:
        check_run(config, device, Path(tmp), rows)
        lap("8 training run")
        print(f"training run: {seconds['8 training run']:.1f} s", flush=True)
        eval_counts = check_eval(config, device, Path(tmp), rows)
        lap("9 evaluation")
        print(f"evaluation path: {seconds['9 evaluation']:.1f} s", flush=True)
        cmu_counts = check_cmu(device, Path(tmp))
        lap("10 cmu")
    eao_counts = check_eao_train(device)
    lap("11 eao")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        moe_counts = check_moe(device, Path(tmp))
    lap("12 moe")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aot_") as tmp:
        quant_counts = check_quant_aot(config, device, card, Path(tmp))
    lap("13 int8 and aot")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        par_counts = check_parallel(device, card, Path(tmp))
    lap("14 parallel")
    print(f"parallel slice: {seconds['14 parallel']:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipe_ep_") as tmp:
        pipe_ep_counts = check_pipe_ep(device, card, Path(tmp))
    lap("15 pipe and ep")
    print(f"pipeline and expert parallelism: {seconds['15 pipe and ep']:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zero3_") as tmp:
        zero3_counts = check_zero3(device, card, Path(tmp))
    lap("16 zero3")
    print(f"ZeRO-3 and the memory tools: {seconds['16 zero3']:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_segmented_") as tmp:
        seg_counts = check_segmented(device, Path(tmp))
    lap("17 segmented and tools")
    print(f"segmented attention and the tools: {seconds['17 segmented and tools']:.1f} s",
          flush=True)
    # K6 read twice: its big mode once read 1.263 ms against 0.785-0.798
    # in the calls beside it, with no code changed (PR 15)
    counter = [check_counter(device) for _ in range(2)]
    print("K6 read twice in this process: "
          + "; ".join(f"{c['ms']:.4f} ms (" + ", ".join(f"{m} {v:.4f}" for m, v in
                                                        c["modes_ms"].items()) + ")"
                      for c in counter) + f"; {card}", flush=True)
    kernels += [counter[0], check_probe(device), check_ctl(device)]
    counts.update(check_tools(device))
    lap("7 measurement")
    print(f"measurement slice: {seconds['7 measurement']:.1f} s", flush=True)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; total {time.perf_counter() - start:.1f}", flush=True)
    for extra in (eval_counts, cmu_counts, eao_counts, moe_counts, quant_counts, par_counts,
                  pipe_ep_counts, zero3_counts, seg_counts):
        for name, n in extra.items():
            counts[name] += n
    for entry in kernels:
        entry["launches"] = counts[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--p2p-rank"]:
        sys.exit(p2p_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--infer-rank"]:
        sys.exit(infer_rank(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--parallel-cards"]:
        sys.exit(parallel_cards(int(sys.argv[2])))
    sys.exit(main())
