#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sggan_tpu_torch``).

Drives the port's paths on one NVIDIA GPU at full width, with random
weights from a seed: the serving path (the ResNet generator, ngf 64, at
256x512 behind the HTTP service), the sggan train step (ResNet generator,
semantic discriminator ndf 64, 34 classes, pool 50, bf16, batch 16), the
fused conv3x3 + instance norm table (``sggan_tpu_torch.perf_conv_in`` at
the resblock shape and the wide encoder shape, bf16, batch 16), the
trainer behind ``python -m sggan_tpu_torch.main`` on a synthetic set of
512x1024 PNGs (batch 12 doubled by augmentation, 256x512 bf16), and the
CLI's default nets: the U-Net generator (ngf 64) with the semantic
discriminator, p2p loss and dropout, through its step, the CLI with no
net or loss flag (128x128, batch 1 doubled) and the service, and the
pix2pix pair with batch norm; the cycle-consistency mode, two ResNet
generators and two semantic discriminators, through its step (256x512,
bf16, batch 8) and the CLI; and the deployment path: the service's
``torch.export`` artifacts of those checkpoints and the reference-TF2
import; and the CUDA graphs of every loss mode's step (``--scan_steps``)
and of the fixed-shape forward.  Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build both kernel sources (csrc/instance_norm.cu, csrc/conv3_in.cu)
     with nvcc, side by side, and the zstd decoder (csrc/zstd_decode.cpp,
     host code) with g++ beside them; registers, spills and static
     shared memory of every kernel;
  3. the kernel against its plain PyTorch version on the card, at the
     four (shape, act) pairs of the generator's 23 instance-norm sites,
     batch 1 and 16, f32 and bf16, with its plan; two calls bitwise
     equal;
  4. the whole generator at 256x512: the f32 card forward (TF32 off)
     against the same module's f32 CPU forward, and the bf16 card forward;
  5. the HTTP service on the card: /healthz, four PNG translations (one
     1024x2048, so the resize runs), one garbage body answered 400; the
     start-up's forward captures a CUDA graph (23 x 2 kernel calls, the
     warm-up and the capture), each request replays it (no wrapper
     call; phase 29 names a replay's kernels);
  6. timings with CUDA events: generator forward, kernel against plain
     version, and a device-time breakdown from torch.profiler;
  7. both instance-norm kernels against their plain versions at the
     train step's sites (the generator's four at batch 16, the
     discriminator's seven, leaky_relu, at batch 16 and 32), f32 and bf16:
     each site's plan (route, cluster, CTAs, clusters the card holds at
     once), the forward's output and saved moments, then the backward fed
     the kernel's own moments; two calls bitwise equal;
  8. one f32 sggan step, card (kernels, TF32 off) against CPU (plain
     versions) from the same seeded state, batch and pool draws: losses
     and every gradient, at the CPU tests' size (32x64, b=2) and at full
     width (256x512, b=1), where the card is also run with cuDNN off to
     show the gradients' f32 noise floor;
  9. the train step at full width, bf16, batch 16, >= 12 steps: finite
     losses, exactly 37 forward and 37 backward kernel calls per step,
     each on the route its plan gives (16-byte routes only);
  10. timings: step time, img/s and peak memory at batch 16 and 24; a
     torch.profiler breakdown of one step, where no K1 kernel may fall
     outside K1's categories; both kernels at every site of the step, by
     CUDA events and by the profiler (device only), against their bound,
     the routes the plan did not take, their plain versions and PyTorch's
     F.instance_norm;
  11. the fused conv3x3 + instance norm kernel (K2) against its plain
     PyTorch twin: y, y16, mean and rsig for three activations, f32 and
     bf16, at small shapes (both conv routes, ragged tiles) and at the two
     full shapes; two calls must agree bitwise;
  12. the gradients of K2's autograd Function (dx, dw, dgamma, dbeta)
     against its plain route at the same shapes, with one K2 launch and
     one K1 backward launch per call;
  13. the generator's first resblock at full width (16, 64, 128, 256)
     composed from two K2 calls against ``GeneratorResnet._res_block``,
     forward and the gradient to x, bf16 and f32, both timed;
  14. the K2 table (main path): ``perf_conv_in`` at both full shapes,
     K2 against the unfused library path, forward and forward+backward;
     a profiler listing of the K2 forward, which must hold no library
     convolution and no pad gather;
  15. the data pipeline at the trainer's source shape: 12 distinct
     512x1024 triplets doubled to 24, half layout, -> 256x512, mask
     32x64, 34 classes, with the sources as they are and host-downscaled
     to 256x512, photometric off and on: ``preprocess_train`` and
     ``preprocess_test`` on the card against the port's own CPU run on
     the same inputs and draws (images 1e-5 abs, masks and flips equal);
     ``seg_labels_u8`` and ``fake_u8`` bit-exact against the host
     conversions (``fake_u8`` over every lattice point 2k/255 - 1 with 4
     ulps each side and 2^24 strided f32 values of [-1, 1]); preprocess
     img/s by CUDA events, 10 iterations after 3;
  16. the trainer (main path): 96 + 2 synthetic 512x1024 PNG triplets as
     ``perf_epoch_e2e.build_dataset`` makes them; ``python -m
     sggan_tpu_torch.main --phase train`` with perf_epoch_e2e.py's
     fused-aug flags for 3 epochs (the resident split taken, finite
     losses, checkpoint, test PNGs, tfevents), then ``--phase test``
     (" [*] Load SUCCESS") and ``--continue_train`` for one epoch, which
     must resume at the saved step; per-epoch, sustained and whole-run
     img/s, the training at the default ``--scan_steps 8`` through the
     step's CUDA graph (the run's capture line with 37 + 37 K1 calls);
     then one epoch in-process with ``--scan_steps 1`` and K1's exact
     counts per route (37 forward and 37 backward a step, 23 x 2 forward
     for the capture of the eval's graph) and a profiler window of 2
     steps of the epoch loop, and the batch assembly profiled alone;
  17. the U-Net and the pix2pix generator at 128x128, ngf 64, b=2, f32:
     the card's forward (TF32 off) against the CPU's, inference and with
     dropout masks fed (pix2pix: batch norm on its moving stats, then on
     the batch's), phase 4's limit; 15 K1 calls a U-Net forward;
  18. both K1 kernels against their plain versions at every site of the
     U-Net's paths, f32 and bf16: the p2p step's (the generator's 15
     and the semantic discriminator's at b and 2b) at 128x128 b=2 and at
     256x512 b=8, 4 and 2, the eval's and the service's forward; each
     call on its planned route, the generator's b=2 sites on the route of
     the plan's table (16-CTA cluster or stream), phase 7's limits; then
     each width's bf16 time by events and profiler beside the routes the
     plan did not take;
  19. the p2p U-Net step (main path): one f32 step card vs CPU at 32x64
     b=2 with dropout masks fed (phase 8's limits, the full-width ones
     where a generator gate falls on opposite sides); then bf16 steps at
     128x128 b=2 and at 256x512 at the largest of b 8, 4, 2 that fits:
     exactly 27 (29) K1 calls a step each way on the planned routes,
     finite losses, step ms and img/s, peak memory, a profiler breakdown
     by kernel and by aten op (conv forward, conv-transpose forward,
     their backward, dropout's draws and its apply) with the idle share;
  20. the default CLI (main path): ``python -m sggan_tpu_torch.main
     --phase train`` with no net or loss flag on phase 16's PNG set at
     128x128 (train, test, resume; sustained img/s; the step's graph of
     27 + 27 K1 calls), one in-process epoch with ``--scan_steps 1`` and
     K1's exact calls, and beside the last three one short
     ``--use_pix2pix`` epoch (one chunk of 8, one print) whose
     checkpoint carries moved BN state;
  21. /translate with the U-Net at 128x128 (15 x 2 K1 calls at the
     start-up's capture, a request a replay) and the
     U-Net's bf16 forward at b=1 and 16, 128x128 and 256x512;
  22. the cycle step (``--loss_mode cycle``: two generators, two
     semantic discriminators, the pair pool), f32, card vs CPU at 32x64
     b=2 from one seeded state, two-domain batch, pool draws and mask
     sets: the ResNet, and the U-Net with its four dropout mask sets;
     phase 8's limits, or the full-width ones where a sign the gradient
     follows (a gate, an L1's or the gradient loss's abs) falls on
     opposite sides, counted;
  23. both K1 kernels against their plain versions at every site of the
     cycle paths that phases 7 and 18 do not hold (the ResNet cycle
     step's at b = 2, 4, 8, 12, 16, the discriminators' at b and 2b, the
     eval's at b=2), f32 and bf16, on the planned routes; both kernels
     timed at every site of one b=8 cycle step against their bound;
  24. the cycle step (main path): bench.py:221-256's cell, ResNet
     256x512, ngf and ndf 64, 34 classes, pool 50, bf16, identity and
     gradient loss on, b=8, 12 steps with exactly 166 forward and 166
     backward K1 calls a step on the planned routes, finite losses, step
     ms, pairs/s, peak memory and a profiler breakdown with the idle
     share; then a sweep over b = 8, 12, 16 (pairs/s, peak memory;
     a batch that does not fit is printed as such, b=8 must run);
  25. the cycle CLI (main path): phase 16's PNG set with a 48-triplet
     trainB of another seed; ``python -m sggan_tpu_torch.main --phase
     train --loss_mode cycle --use_resnet`` with phase 16's fused-aug
     flags at b=4 doubled to 8, ``--train_size 48``, 3 epochs (both splits
     resident, finite losses, checkpoint, test PNGs, tfevents; sustained
     pairs/s; the step's graph of 166 + 166 K1 calls), ``--phase test``
     AtoB and BtoA (" [*] Load SUCCESS", different PNGs),
     ``--continue_train`` 1 epoch (resumes at the saved step), then one
     in-process epoch with ``--scan_steps 1`` and K1's exact calls;
  26. the exported artifact (main path): ``python -m
     sggan_tpu_torch.serve --export`` on the checkpoints of phases 16
     (ResNet, bf16 and again f32), 20 (U-Net, pix2pix) and 25 (cycle,
     AtoB and BtoA), side by side; then, beside the untimed rest of
     phases 36 and 37 and phase 35's recon eval, each export printed
     checkpoint_loaded=True; 23, 15 and 0 K1 op nodes a graph
     and no plain reduction; a fresh process that imports only
     ``utils.export`` runs each twice: the first call captures its CUDA
     graph with K1's exact calls (twice a forward's) on the planned
     routes, the second replays it with none and the same output; each
     against the checkpoint service (f32 phase 4's limit with TF32 off,
     bf16 one PNG level; AtoB and BtoA apart); the service with
     ``--artifact``: /healthz, four PNGs (one 1024x2048) within one level
     of the checkpoint service's, each a replay, a garbage body 400;
  27. the inference cell (bench.py:147-175): the ResNet's artifact at
     256x512 and the U-Net's at 128x128, bf16, b=1 and b=16, through its
     CUDA graph, beside its GraphModule node by node and the eager
     forward, 32 calls after 3; busy, idle share and K1's share from the
     profiler; the b=1 vs b=16 gap; a K1 call's host cost through the
     registered op and through the wrapper;
  28. the reference-TF2 import at full width: TensorBundles of a ResNet
     generator (ngf 64) and a semantic discriminator (ndf 64, 34
     classes) written by the port's ``tf_bundle`` from seeded weights;
     ``python -m sggan_tpu_torch.utils.import_tf`` writes cp-0000.pt,
     which holds them exactly (both in a process of their own beside
     phases 29 and 33, whose fresh process leaves the host's other cores
     idle); after phases 30-32 the service serves it within one PNG
     level of the eager forward; ``--selftest`` (started beside phase
     29) passes;
  29. the CUDA graphs (main path): the trainer's loop over a resident
     split made on the card, for the ResNet sggan step (256x512 b=16),
     the default p2p U-Net with dropout and the pix2pix pair with batch
     norm (128x128 b=2) and the ResNet cycle step (256x512 b=8): from one
     snapshot of the state and both generators, 8 eager steps
     (``--scan_steps 1``) and the same 8 through the step's graph in
     chunks of 8 and of 3 (a tail of 2), with cuDNN deterministic:
     losses and every parameter, Adam moment and count, BN stat, EMA
     tensor and pool buffer bitwise equal; K1's calls recorded at the
     capture exactly 37 + 37, 27 + 27, 0 and 166 + 166 on the planned
     routes; a profiler window of an epoch's replays names K1's kernels
     for those calls each; then eager beside the graph with cuDNN's
     defaults: step ms by events, busy by the profiler, idle share, peak
     memory, img/s (pairs/s); and the forward graphs of
     ``evaluate.generate``, the ResNet at 256x512 and the U-Net at
     128x128, bf16, b=1 and 16: bitwise equal to the eager forward, K1's
     calls only at the capture, a replay's kernels profiled, ms a call
     beside eager's.  The ResNet sggan cell also
     under ``--remat``: its graph holds the backward's recompute, K1's
     calls at the capture 55 + 37.  In a fresh process, with phase 33
     after it: late in a long one the profiler drops kernels from short
     traces;
  30. the reflect layers, in a fresh process with 31 and 32: the reflect
     pad's ``autograd.Function`` (the strip-add adjoint) and both forms
     of the reflect conv, the pad-free Function and the gather + VALID
     conv, against their plain twins (the gather with autograd's index
     adjoint) at c1 (16,256,512,3 -> 64, k7) and a resblock conv
     (16,64,128,256 -> 256, k3), f32 (TF32 off: 1e-5 of each tensor's
     largest) and bf16 (phase 13's limits): value, dx, dw; each form's
     forward + backward by CUDA events; the profiler's reflect pads in
     one ResNet sggan step at b=16 and one cycle step at b=8, the
     parent's forms beside the path's;
  31. the head, 7x7 64 -> 3 at (8 and 16, 256, 512), bf16, forward +
     backward: cuDNN's conv (after the pad, and pad-free) beside the
     space-to-depth forms at ``best_block``'s (8, 4), (4, 4), (4, 8) and
     (2, 2), each against the plain twin; the table, the fastest and
     ``s2d.head_block``'s choice; the generator with ``pad_free_head``
     true, false and by default, f32 card vs CPU at 256x512 (phase 4's
     limit);
  32. ``--remat`` (main path): the ResNet sggan step (256x512 b=16), the
     p2p U-Net step (128x128 b=2, masks fed) and the ResNet cycle step
     (256x512 b=8) with and without it from one state, cuDNN
     deterministic: losses and every gradient bitwise equal; K1's exact
     calls (the forward's rise by the recomputed norms: 55, 42 and 274,
     the backward's stay 37, 27 and 166) on the planned routes; peak
     memory and ms each way; then the largest batch that fits for the
     ResNet sggan step at 2048x1024 and the cycle step at 512x1024, with
     and without it (probes at b=4 and 8, then at the batch a straight
     line through their peaks puts at 95% of the card's memory, walked a
     batch at a time, then bisected; at most 8 probes);
  33. ``--compat_fake_history`` (main path), in phase 29's process: both K1
     kernels against their plain versions at the discriminator's new
     sites (N = 11 and 13 at 128x128, 17 and 25 at 256x512), f32 and
     bf16, on the planned routes; the f32 history step card vs CPU at
     32x64 with a history of 6 earlier fakes (phase 19's limits); bf16
     steps of the default config with the flag at 128x128 b=1 doubled to
     2 (a history of 11) and 256x512 b=4 doubled to 8 (17): 12 steps,
     the count sequence of the JAX step (2, 4, 6, 8, 10, 2, ...), exactly
     27 + 27 K1 calls a step on the planned routes, ms, peak memory,
     busy and idle; the trainer's loop eager against the step's graph
     (chunks of 8 and 3) bitwise, and both timed;
  34. the default CLI with ``--compat_fake_history --eval_crf
     --scan_steps 4`` on phase 20's PNG set: it trains through the graph
     (27 + 27 K1 calls at the capture), the eval refines every fake with
     the dense CRF, the checkpoint holds the history's count, and a
     resume continues the count; the CRF library built from
     ``native/crf/`` held to the numpy mean field at 16x16 and timed on
     the host at 128x128x3 and 512x1024x34 (run beside phases 29-33);
     the MFU of phase 29's sggan and cycle graph steps from
     ``utils/flops.py`` against the dense bf16 peak;
  35. ``python -m sggan_tpu_torch.utils.hbm`` in fresh processes: the
     sggan step at 2048x1024 under ``--remat`` at b=2 doubled to 4
     fits, and at b=64 doubled to 128 without it runs out of memory, its
     bytes parsed; ``python -m sggan_tpu_torch.cycle_recon_eval`` on
     phase 25's checkpoint: finite scores and both PNG strips;
  36. data parallelism (``--mesh_data 2``), as two ranks in processes of
     their own, each with torchrun's environment and ``LOCAL_RANK=0``, so
     that both share the one card, joined to gloo explicitly (NCCL refuses
     two ranks on one card; the phase tries it once and prints what it
     says).  Part 2's training runs alone after phase 25 (its steps are
     timed); part 1, part 2's resume and test, and the NCCL attempt run
     beside phase 26, which checks values.  Part 1: every loss mode
     (ResNet sggan with the pool and the EMA, the p2p U-Net with dropout,
     pix2pix with batch norm, the ResNet cycle step) at 32x64 f32, a
     shard of 2, 3 steps, held against one process that computes both
     shards' losses and gradients from the same state and draws and
     averages them (phase 8's limits), K1's calls a step per rank those
     of one shard's step, the ranks' replicas bitwise equal.  Part 2
     (main path): ``python -m sggan_tpu_torch.main --mesh_data 2``
     (ResNet sggan, 256x512 bf16, 8 files a step doubled to 16, 8 a rank,
     one epoch of 4 steps) at the CLI's defaults, each rank on the split
     resident on its card (its line printed) in a chunk of eager steps,
     then the same on the host iterator (``--device_dataset_mb 0``) in
     the same processes: equal finite losses on both ranks, 37 + 37 K1
     calls a step per rank, only rank 0 printing and writing the
     checkpoint (both ranks' pool rows), the eval's PNGs and the
     tfevents; each rank's step ms, busy, idle share and the
     all-reduce's ms from a profiler window, resident beside host, and
     the bytes reduced a step, beside phase 16's one-process loop step
     (two ranks sharing one card, not a scaling number); a one-process
     ``--phase test`` of that checkpoint; a two-rank
     ``--continue_train``, then in its ranks the p2p ResNet (f32,
     128x256, 4 files a step doubled, 2 steps, cuDNN deterministic) on
     both paths, its resident epoch loss within rel 1e-4 of the host
     iterator's.  The ranks import no JAX module.
     Alone: ``python -c "import chip_smoke; chip_smoke.dp_alone()"``.
  37. Spatial sharding, ``--mesh_space`` (gloo ranks sharing the card;
     NCCL over 2 cards is phase 39's part 2).  Part 2 (main path, timed,
     after phase 36's): ``python -m
     sggan_tpu_torch.main --mesh_space 2`` (ResNet sggan, 256x512 bf16,
     ngf and ndf 64, 34 classes, b=8 doubled to 16, one epoch of 4
     steps, on the split resident on each rank, its line printed) with
     equal finite losses on both ranks, exactly 29 calls of
     each of K1's four split entries a step per rank and no one-card K1
     call but the coordinator's eval, the checkpoint's pool in the JAX
     global layout;
     each rank's step ms, busy, idle, halo bytes and exchanges a step, the
     ``sp.halo`` and ``sp.moments`` ranges' ms, the moments' all-reduces a
     step, a step's peak memory beside one process's at the same global
     batch; K1's split passes timed at a rank's resblock block beside the
     twin and ``F.instance_norm``.  Then, in the same two processes, the
     CLI with ``--use_pix2pix --loss_mode p2p`` (ngf and ndf 64,
     dropout) on the host iterator: equal finite losses and each rank's
     whole state bitwise equal (both nets' BN states in it), no K1 call,
     the checkpoint with both nets' BN states; each rank's step, busy, idle, the gathers' bytes and
     collectives a step and the ``sp.gather`` range, the halos and the BN
     moments, a step's peak beside one process's.  Beside phase 26: part
     1's 2-rank jobs, part 2's ``--continue_train`` (both runs) and the
     pix2pix run's one-process ``--phase test``; then part 1's 4-rank
     jobs: the ResNet sggan step at data 2 x space 2 and space 2 x wspace
     2, the U-Net sggan step at space 2 with its shards' masks, the ResNet
     cycle step at space 2, the pix2pix p2p step at space 2 and space 2 x
     wspace 2 with its masks (32x64 f32), each against one process on the
     whole plane (losses rel 1e-6, gradients 1e-4 of a tensor's largest,
     the pix2pix nets' new BN states 1e-5 + 1e-4 rel and bitwise equal on
     the ranks), K1's split calls a step per rank exactly the step's sites
     (none for the pix2pix pair), the split passes against their twin at
     every rank's site (phase 7's limits, the moments all-reduced both
     ways); one step at 512x1024 on a 2 x 2 grid, each rank's peak beside
     one process's.  Alone: ``python -c "import chip_smoke;
     chip_smoke.sp_alone()"``.

  38. the JAX package's Orbax checkpoints (main path), at the end of
     phase 29's fresh process: the zstd decoder built from
     csrc/zstd_decode.cpp with g++ (in phase 2); for each committed
     fixture of ``tests/golden/orbax/`` (the JAX package's CLI's
     ``cp-0000``: the ResNet sggan with ``--gen_ema``, the pix2pix pair
     with its BN states, the ResNet cycle mode; ngf and ndf 1, 32x64,
     f32): ``--phase test`` (" [*] Load SUCCESS (JAX Orbax cp-0000)"; its
     forward in f32, TF32 off, against the JAX package's at phase 4's
     limit, its PNG within one level), the service on it
     (``checkpoint_loaded: true``, a POST within one level), then
     ``--continue_train`` of 2 steps through the step's CUDA graph: the
     loaded state equal to the fixture's per-leaf SHA-256 bit for bit,
     K1's calls exactly the cell's (31, 0 or 154 a step at 32x64, at its
     warm-ups and capture, and the eval's forward graph), the run going on from
     the saved step, ``cp-0001.pt`` written and the JAX directories left
     as they were; then the decoder's MB/s on the host over the
     fixtures' frames repeated to 200 MB of output, with the host CPU
     and the card.  Alone: ``python -c "import chip_smoke;
     chip_smoke.orbax_alone()"``.
  39. the multi-rank step as a CUDA graph (main path).  Part 1, in phase
     29's fresh process after its step cells: a process group of one NCCL
     rank on the card, and over it the data-parallel step (built with
     ``keep_one``, which the trainer never passes, so that its buckets'
     all-reduces are NCCL calls) in phase 29's ResNet sggan cell (256x512
     bf16 b=8 doubled to 16) and pix2pix cell (128x128 b=1 doubled to 2,
     the bucket with the batch norms' stats): 8 eager steps and the same
     8 through ``StepGraph`` in chunks of 8 and of 3, cuDNN deterministic,
     losses and every state tensor bitwise equal; K1's 37 + 37 calls
     recorded at the ResNet's capture and named by a profiler window of
     replays; the collectives recorded at the capture an eager step's (2
     all-reduces, the ResNet's 90,165,916 bytes); eager beside graph step
     ms, idle share, peak memory and the NCCL kernels of a window of
     replays (or none).  Part 2, where two cards are visible: the ResNet
     sggan CLI with ``--mesh_data 2 --scan_steps 4`` and with
     ``--mesh_space 2 --scan_steps 4`` on phase 16's PNGs over two NCCL
     ranks, a card each, then over two gloo ranks on the same cards, cuDNN
     deterministic: each NCCL rank's captured line, the coordinator's
     path lines, the NCCL ranks' states bitwise equal, the epoch loss
     within rel 1e-6 of gloo's; on one card it prints "nccl graph: not
     run, 1 card".  Part 1 alone: ``chip_smoke.nccl_graph_phase(card,
     device)``.

Prints a JSON line of the trainer's and the preprocess's rates, one of
the default nets' numbers, one of the cycle mode's, one of the inference
cell's, one of the CUDA graphs', one of phases 30-32, one of phases
33-35, one of phase 36, one of phase 37, one of phase 38, one of phase
39, a JSON line of the kernels
(K1's entries with ``launches_dp`` and ``launches_dp_graph``, and K1's
split entries
``instance_norm_sp_fwd`` / ``_bwd``), then as the last line ``{"ok": true, "device":
{...}}``.  Exits non-zero, printing neither,
when no CUDA device is visible or any phase fails.
"""

from __future__ import annotations

import glob
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SITES = [((256, 512, 64), "relu"), ((128, 256, 128), "relu"),
         ((64, 128, 256), "relu"), ((64, 128, 256), None)]
SITE_COUNT = [2, 2, 10, 9]  # per generator forward: 23 instance norms
# the discriminator's 7 instance norms at 256x512 (ndf 64): h1, h2, h3,
# then the VALID chain [2, 2, 2, 1] on the 32x64 h3 grid; all leaky_relu
D_SITES = [((64, 128, 128), "leaky_relu"), ((32, 64, 256), "leaky_relu"),
           ((32, 64, 512), "leaky_relu"), ((15, 31, 512), "leaky_relu"),
           ((7, 15, 512), "leaky_relu"), ((3, 7, 512), "leaky_relu"),
           ((1, 5, 512), "leaky_relu")]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # tests/test_pallas.py
F32_U = 2.0 ** -24  # f32's unit roundoff


def f32_out_limit(x, gamma, ref, mean, rstd, base: float = TOL[torch.float32]):
    """The f32 output limit of a K1 check, per element: the fixed ``base``
    (abs + rel of ``ref``) plus what the plane's conditioning allows.  Two
    f32 implementations of var = E[x^2] - mean^2 (the kernel and its
    twin, or the twin and f64) differ in var by up to ~(k + 3) u E[x^2]:
    k = ceil(log2 s) for the sums of s = H*W terms (S and Q, summed in
    different orders), 3 for the roundings of Q / s, mean^2 and the
    subtraction; the mean itself by ~k u E|x|.  So rstd moves by (k + 3) u
    E[x^2] / (var + eps) of itself and y by that times |gamma xhat|, plus
    |gamma| rstd k u E|x| <= |gamma| k u sqrt(E[x^2] / (var + eps)).  With
    kappa = mean^2 rstd^2 (E[x^2] / (var + eps) - var / (var + eps)), the
    part beyond what ``base`` covers on a centred plane is c u (kappa
    |gamma xhat| + |gamma| sqrt(kappa + 1)), c = ceil(log2 s) + 3; it is
    ~0 on the nets' planes (mean ~ 0, kappa << 1) and 6 u kappa on the
    semantic D's last site, planes of 5 elements where var ~ 1e-2 mean^2
    (ROADMAP Queue 3).  ``mean`` and ``rstd`` (N, C): the plane's moments
    (the twin's); ``x`` the input, ``ref`` the reference output, NHWC."""
    s = x.shape[1] * x.shape[2]
    c = math.ceil(math.log2(max(s, 2))) + 3
    m = mean.double()[:, None, None, :]
    r = rstd.double()[:, None, None, :]
    kappa = m * m * r * r
    g = gamma.double().abs()
    xhat = (x.double() - m) * r
    return (base + base * ref.double().abs()
            + c * F32_U * (kappa * g * xhat.abs() + g * (kappa + 1).sqrt()))
SLICE_ATOL = 1e-3
# phase 8 at 256x512: largest |diff| over a gradient's largest element, and
# |diff| / |g| in norm.  f32 whole-net gradients at init are sums with deep
# cancellation, and any two summation orders differ by a few percent of a
# tensor's largest element (PERF.md section 6); the planted faults of
# tests/test_torch_step.py move them by far more than these limits.
STEP_MAX_REL, STEP_NORM_REL = 0.1, 2e-2
H, W, NGF = 256, 512, 64
B_TRAIN, N_STEPS, N_CLASS = 16, 12, 34
LAUNCHES_PER_STEP = 37  # 23 generator + 7 (D for the gen loss) + 7 (D call)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 in the tensor cores
# K2 (N, H, W, Cin, Cout): the JAX tests' three, an odd plane and a Cin
# that is no multiple of 16 (scalar route in every dtype), then four that
# the wgmma route takes in bf16: W < 64, ragged in rows, columns and the
# Cout tile, and two ragged against its 8 x 64 pixel by 64 channel tile
# (W of 70 and 130, odd H, Cout 144 and 48, Cin 16 in one chunk, n > 1);
# then the two full shapes of the table
K2_SMALL = [(2, 8, 16, 8, 8), (1, 16, 8, 16, 8), (1, 64, 8, 8, 16),
            (2, 7, 9, 5, 6), (1, 9, 33, 24, 40), (2, 16, 16, 16, 16),
            (1, 20, 37, 32, 80), (1, 9, 70, 32, 144), (2, 5, 130, 16, 48)]
K2_FULL = [(16, 64, 128, 256, 256), (16, 256, 512, 64, 64)]
K2_ACTS = (None, "relu", "leaky_relu")
K2_ITERS = 10


def gen_sites(n: int) -> list:
    """(N, (H, W, C), act, calls) of the ResNet generator's 23 instance
    norms in one forward at batch ``n``."""
    return [(n, hwc, act, c) for (hwc, act), c in zip(SITES, SITE_COUNT)]


def step_sites(b: int = B_TRAIN):
    """(N, (H, W, C), act, calls per step) of every instance norm of one
    train step at batch ``b``: the generator's 23, the discriminator's 7
    in the generator loss (batch b) and in the one call over [real; fake]
    (batch 2b)."""
    return (gen_sites(b) + [(b, hwc, act, 1) for hwc, act in D_SITES]
            + [(2 * b, hwc, act, 1) for hwc, act in D_SITES])


def step_k1_sites() -> list:
    """(N, (H, W, C), act) of phase 7: the generator's four at b=16, the
    discriminator's seven at b=16 and 32."""
    return ([(B_TRAIN, hwc, act) for hwc, act in SITES]
            + [(n, hwc, act) for n in (B_TRAIN, 2 * B_TRAIN)
               for hwc, act in D_SITES])


def bound_ms(n, hwc, dtype_bytes, tensors, flops_per_elt):
    """Least time for one call: ``tensors`` activation-sized arrays moved
    once each at HBM rate, or the f32 operations at the f32 rate."""
    elts = n * hwc[0] * hwc[1] * hwc[2]
    return 1e3 * max(tensors * elts * dtype_bytes / HBM_BYTES_PER_S,
                     flops_per_elt * elts / F32_FLOPS_PER_S)


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill stores and loads, static shared bytes)
    of every entry function in nvcc's ``-Xptxas -v`` output."""
    rows, kernel, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = short_kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spills {m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), spills, int(m.group(2))))
            kernel = None
    return rows


def short_kernel_name(mangled: str) -> str:
    """``in_bwd_apply<bf16,8>`` or ``k2_conv_wgmma<64,4,4>`` from an
    Itanium-mangled kernel template."""
    m = re.search(r"\d+(k2_[a-z_0-9]+?)I((?:Li\d+E)+)E", mangled)
    if m:
        return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
    m = re.search(r"\d+((?:in|k2)_[a-z_0-9]+?)I(13__nv_bfloat16|f)"
                  r"(?:Li(\d+)E)?", mangled)
    if not m:
        m = re.search(r"\d+((?:in|k2)_[a-z_0-9]+)", mangled)
        return m.group(1) if m else mangled[:40]
    t = "bf16" if m.group(2).endswith("bfloat16") else "f32"
    return f"{m.group(1)}<{t}{',' + m.group(3) if m.group(3) else ''}>"


T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.0f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def site_inputs(n, hwc, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = hwc[-1]
    x = (torch.randn((n, *hwc), generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    beta = torch.randn(c, generator=g, device=dev) * 0.1
    return x, gamma, beta


def plan_line(n, hwc, dtype, direction) -> str:
    """The K1 plan of one site and, on the cluster route, how many of its
    clusters the card holds at once."""
    from sggan_tpu_torch.ops import cuda_in
    p = cuda_in.plan(n, *hwc, dtype, direction)
    if p.route != "cluster":
        return f"{p.route} x{p.splits} splits, {p.ctas} CTAs"
    return (f"cluster of {p.cluster}, {p.ctas} CTAs, {p.smem} B shared "
            f"each, {cuda_in.max_active_clusters(p, direction, dtype)} "
            "clusters at once")


# a forward graph's first call runs the forward through K1's wrappers
# twice, its warm-up and its capture; a replay launches the kernels
# without them
FWD_GRAPH_CALLS = 2


def png(arr: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def post(port: int, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/translate",
                                 data=body,
                                 headers={"Content-Type": "image/png"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


# K1's kernels by name: the cluster route's one kernel per direction, the
# two-pass routes' stats and apply kernels (csrc/instance_norm.cu)
K1_FWD_KERNELS = ("in_fwd_cluster", "in_stats", "in_apply")
K1_BWD_KERNELS = ("in_bwd_cluster", "in_bwd_stats", "in_bwd_apply")
CATEGORIES = [("K1 instance norm", K1_FWD_KERNELS),
              ("convolutions", ("xmma", "conv", "cutlass", "gemm")),
              ("reflect-pad gathers", ("index_elementwise",)),
              ("copies and casts", ("copy",)),
              ("residual adds", ("CUDAFunctor_add",))]



def kernel_times(prof, n_runs: int) -> list:
    """(device ms per run, launches per run, name) of every device kernel
    in a torch.profiler trace of ``n_runs`` runs, the longest first.  Read
    from the trace's raw device events, as ``key_averages`` counts them
    (synchronous device events, names demangled): ``key_averages`` first
    builds an event object for every host op of the window too, which
    takes tens of seconds over a window of eager steps."""
    from torch._C._autograd import DeviceType
    ns, cnt = {}, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_async()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        name = e.name()
        ns[name] = ns.get(name, 0) + e.duration_ns()
        cnt[name] = cnt.get(name, 0) + 1
    by_name = {}
    for name in ns:
        key = torch._C._demangle(name)
        t, c = by_name.get(key, (0, 0))
        by_name[key] = (t + ns[name], c + cnt[name])
    return sorted(((t / n_runs / 1e6, c // n_runs, key)
                   for key, (t, c) in by_name.items()), reverse=True)


def range_ms(prof, names, n_runs: int) -> dict:
    """Host ms per run of each ``record_function`` range of ``names`` in a
    torch.profiler trace of ``n_runs`` runs, summed over its entries: the
    host-side events only (a CUDA trace also lists each range as a device
    annotation).  A range the trace does not hold is absent."""
    from torch._C._autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in names:
            out[e.name()] = (out.get(e.name(), 0.0)
                             + e.duration_ns() / n_runs / 1e6)
    return out


def print_breakdown(prof, n_runs: int, wall_ms: float, title: str,
                    categories) -> None:
    """Device time per run from a torch.profiler trace of ``n_runs`` runs,
    by category and by kernel, and the device idle share against the
    event-timed ``wall_ms`` of one run."""
    kern = kernel_times(prof, n_runs)
    total = sum(k[0] for k in kern)
    print(f"  {title}: device busy {total:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * (1 - total / wall_ms):.1f}% idle)")
    left = list(kern)
    for cat, keys in categories:
        mine = [k for k in left if any(t in k[2] for t in keys)]
        left = [k for k in left if k not in mine]
        print(f"    {cat:30s} {sum(k[0] for k in mine):8.4f} ms "
              f"in {sum(k[1] for k in mine)} launches")
    print(f"    {'other':30s} {sum(k[0] for k in left):8.4f} ms "
          f"in {sum(k[1] for k in left)} launches")
    for ms, cnt, name in kern[:12]:
        print(f"      {ms:8.4f} ms  x{cnt:<4d} {name[:90]}")
    stray = [k[2] for k in left if "::in_" in k[2]]
    if stray:
        raise AssertionError(f"K1 kernels outside K1's categories: {stray}")


def profile_forward(gen, n: int, wall_ms: float, card: str) -> None:
    """Device time of one bf16 forward by kernel and by category
    (torch.profiler over 3 forwards)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.round(torch.rand(n, H, W, 3, device="cuda") * 255.0)
    with torch.inference_mode():
        gen(x, {}, torch.bfloat16)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                gen(x, {}, torch.bfloat16)
            torch.cuda.synchronize()
    print_breakdown(prof, 3, wall_ms, f"[{card}] profiler, b={n} bf16 "
                    "forward", CATEGORIES)


STEP_CATEGORIES = [
    ("K1 backward", K1_BWD_KERNELS),
    ("K1 forward", K1_FWD_KERNELS),
    ("convolutions", ("xmma", "conv", "cutlass", "gemm", "cudnn")),
    ("reflect pads and their adjoints", ("index_elementwise",
                                         "indexing_backward", "index_put",
                                         "RadixSort", "radix_sort")),
    ("pool gathers and concats", ("index_select", "indexSelect",
                                  "CatArray")),
    ("Adam and EMA (foreach)", ("multi_tensor_apply",)),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
]


def train_batch(cfg, b: int, dev, seed: int) -> dict:
    """A synthetic batch like bench.py's: uniform photo and seg map, a
    one-hot mask of random classes on the mask grid."""
    g = torch.Generator().manual_seed(seed)
    h, w = cfg.image_size
    hm, wm = cfg.mask_hw
    ids = torch.randint(0, cfg.segment_class, (b, hm, wm), generator=g)
    return {"real_a": torch.rand(b, h, w, 3, generator=g).to(dev),
            "seg_a": torch.rand(b, h, w, 3, generator=g).to(dev),
            "mask_a": torch.eye(cfg.segment_class)[ids].to(dev)}


def cycle_batch(cfg, b: int, dev, seed: int) -> dict:
    """The cycle step's batch: ``train_batch`` for domain A from ``seed``
    and for domain B from ``seed + 1000``."""
    bb = train_batch(cfg, b, dev, seed + 1000)
    return dict(train_batch(cfg, b, dev, seed), real_b=bb["real_a"],
                seg_b=bb["seg_a"], mask_b=bb["mask_a"])


def device_batch(cfg, b: int, dev, seed: int) -> dict:
    """``train_batch``'s tensors (``cycle_batch``'s under the cycle mode)
    drawn on the card: for phase 32's memory probes, whose values do not
    matter and whose host draws at 2048x1024 take seconds each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = cfg.image_size
    hm, wm = cfg.mask_hw
    out = {}
    for s in ("a", "b") if cfg.loss_mode == "cycle" else ("a",):
        ids = torch.randint(0, cfg.segment_class, (b, hm, wm), generator=g,
                            device=dev)
        out.update({f"real_{s}": torch.rand(b, h, w, 3, generator=g,
                                            device=dev),
                    f"seg_{s}": torch.rand(b, h, w, 3, generator=g,
                                           device=dev),
                    f"mask_{s}": torch.nn.functional.one_hot(
                        ids, cfg.segment_class).float()})
    return out


def to_dev(x, dev):
    """A tensor, or a dict (a batch) or nested tuples and lists (the
    dropout mask sets) of them, on ``dev``; None stays None."""
    if isinstance(x, dict):
        return {k: to_dev(t, dev) for k, t in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_dev(t, dev) for t in x)
    return x if x is None else x.to(dev)


def grad_rows(ref: dict, got: dict) -> list:
    """(max |diff| / max |g|, |diff| / |g|, name) for every gradient of
    ``ref`` that is not all zero, sorted, the worst max last."""
    return sorted(((got[k] - ref[k]).abs().max().item()
                   / ref[k].abs().max().item(),
                   ((got[k] - ref[k]).norm() / ref[k].norm()).item(), k)
                  for k in ref if ref[k].any())


def print_rows(title: str, rows: list) -> None:
    print(f"    {title}: median max |diff| / max |g| "
          f"{rows[len(rows) // 2][0]:.3g}; largest |diff| / |g| "
          f"{max(r[1] for r in rows):.3g}")
    for mx, nr, k in rows[::-1][:3]:
        print(f"      {k}: max |diff| / max |g| {mx:.3g}, |diff| / |g| "
              f"{nr:.3g}")


def step_grads(cfg, b: int, dev: str):
    """One f32 step's losses and gradients on ``dev`` from the seeded
    state, batch, pool draws and dropout masks that every call shares;
    gradients on the CPU, keyed "gen.*" and "disc.*"."""
    from sggan_tpu_torch.train import cycle as tcycle
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    cycle = cfg.loss_mode == "cycle"
    batch = (cycle_batch if cycle else train_batch)(cfg, b, dev, seed=3)
    draws = tpool.pool_draws(torch.Generator().manual_seed(4), b,
                             cfg.max_size)
    st = tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)
    if tstep.compat_hist(cfg):
        # a history of 6 earlier fakes, so the losses judge more than this
        # step's
        buf = st.pool.buffer["fake"]
        buf.copy_(torch.rand(buf.shape, generator=torch.Generator()
                             .manual_seed(9)).mul(2).sub(1))
        st = st._replace(pool=st.pool._replace(count=6))
    # the generator's dropout masks (None for the ResNet; the cycle step's
    # four sets), drawn on the CPU
    masks = to_dev(tstep.dropout_masks(cfg, st.gen_params,
                                       torch.Generator().manual_seed(7), b),
                   dev)
    t0 = time.perf_counter()
    m, gg, dg, *_ = (tcycle if cycle else tstep).losses_and_grads(
        cfg, st, batch, draws, masks)
    m = {k: v.item() for k, v in m.items()}
    print(f"  {cfg.image_size}, ngf {cfg.ngf}, ndf {cfg.ndf}, b={b}, {dev}: "
          f"losses and grads in {time.perf_counter() - t0:.2f} s, {m}")
    return m, {**{f"gen.{k}": v.cpu() for k, v in gg.items()},
               **{f"disc.{k}": v.cpu() for k, v in dg.items()}}


def step_card_vs_cpu(cfg, b: int):
    """One f32 step's losses and gradients on the CPU (plain versions) and
    on the card (kernels).  Prints and returns the losses' largest
    relative difference, the ``grad_rows`` of the card against the CPU,
    the CPU's gradients, and whether a gradient that is zero on the CPU (a
    dead bias) is not zero on the card."""
    (mc, gc), (mg, gg) = step_grads(cfg, b, "cpu"), step_grads(cfg, b, "cuda")
    loss_err = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc)
    dead = [k for k in gc if not gc[k].any()]
    rows = grad_rows(gc, gg)
    print(f"    losses max rel diff {loss_err:.3g}; {len(rows)} gradients, "
          f"{len(dead)} dead biases zero on the CPU")
    print_rows("card vs CPU", rows)
    return loss_err, rows, gg, any(gg[k].any() for k in dead)


def library_in(x, gamma, beta, act):
    """PyTorch's own instance norm (eps 1e-3) and activation on the NCHW
    view of an NHWC tensor: the yardstick, never called by the port."""
    import torch.nn.functional as F
    y = F.instance_norm(x.permute(0, 3, 1, 2), weight=gamma, bias=beta,
                        eps=1e-3)
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, 0.3)
    return y


def time_sites(card: str, dev, sites=None,
               label: str = "the 37 calls of one b=16 step"):
    """Both K1 kernels, their plain versions and PyTorch's instance norm at
    every instance-norm site of ``sites`` ((N, (H, W, C), act, calls), by
    default one b=16 bf16 train step's), the kernels by CUDA events
    (wrapper included) and by the profiler (device only), and the routes
    the plan did not take at each site by events.  Returns the sums over
    the calls and one row per site."""
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.ops import norm as tnorm
    from sggan_tpu_torch.perf_in import device_ms
    tot = {(d, k): 0.0 for d in ("fwd", "bwd") for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "floor_ms", "library_ms")}
    rows = []
    bf16 = torch.bfloat16
    for i, (n, hwc, act, calls) in enumerate(sites or step_sites()):
        x, g, b = site_inputs(n, hwc, bf16, dev, seed=i)
        dy = torch.randn(x.shape, device=dev).to(bf16)
        _, mean, rstd = cuda_in.instance_norm_cuda(x, g, b, 1e-3, act,
                                                   save_stats=True)
        it = 20 if n * hwc[0] * hwc[1] < 2 ** 20 else 5

        def fwd(p=None):
            if p is None:
                return cuda_in.instance_norm_cuda(x, g, b, 1e-3, act,
                                                  save_stats=True)
            return cuda_in._forward(x, g, b, 1e-3, act, 0.3, p)

        def bwd(p=None):
            if p is None:
                return cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd,
                                                      act)
            return cuda_in._backward(x, dy, g, b, mean, rstd, act, 0.3, p)

        ms = {
            ("fwd", "ms"): cuda_ms(fwd, it),
            ("fwd", "device_ms"): device_ms(fwd, it),
            ("fwd", "plain_ms"): cuda_ms(lambda: tnorm._ref_forward(
                x, g, b, 1e-3, act, 0.3), it),
            ("fwd", "library_ms"): cuda_ms(lambda: library_in(x, g, b, act),
                                           it),
            ("bwd", "ms"): cuda_ms(bwd, it),
            ("bwd", "device_ms"): device_ms(bwd, it),
            ("bwd", "plain_ms"): cuda_ms(lambda: tnorm.instance_norm_bwd_ref(
                x, dy, g, b, mean, rstd, act), it),
        }
        xr, gr, br = (t.detach().requires_grad_(True) for t in (x, g, b))
        y = library_in(xr, gr, br, act)
        dyp = dy.permute(0, 3, 1, 2)
        ms["bwd", "library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            y, (xr, gr, br), dyp, retain_graph=True), it)
        # bound: each input read once, each output written once; floor:
        # what a kernel that cannot hold the plane must move, since the sums
        # need the whole plane before the first output (fwd 2R+1W, bwd
        # 2x(x, dy) + dx)
        ms["fwd", "bound_ms"] = bound_ms(n, hwc, 2, 2, 8)
        ms["bwd", "bound_ms"] = bound_ms(n, hwc, 2, 3, 14)
        ms["fwd", "floor_ms"] = bound_ms(n, hwc, 2, 3, 8)
        ms["bwd", "floor_ms"] = bound_ms(n, hwc, 2, 5, 14)
        for key, v in ms.items():
            tot[key] += calls * v
        row = {"n": n, "hwc": list(hwc), "act": act, "calls": calls,
               **{f"{d}_{k}": v for (d, k), v in ms.items()}}
        for d, fn in (("fwd", fwd), ("bwd", bwd)):
            p = cuda_in.plan(n, *hwc, bf16, d)
            row[f"{d}_route"] = p.route
            row[f"{d}_cluster"] = p.cluster
            for r in ("cluster", "stream", "scalar"):
                if r == p.route:
                    continue
                try:
                    alt = cuda_in.plan(n, *hwc, bf16, d, route=r)
                except ValueError:  # no cluster holds this plane
                    continue
                row[f"{d}_{r}_ms"] = cuda_ms(lambda: fn(alt), it)
                row[f"{d}_{r}_device_ms"] = device_ms(lambda: fn(alt), it)
        rows.append(row)

        def others(d):
            return ", ".join(
                f"{r} {row[f'{d}_{r}_ms']:.4f} / {row[f'{d}_{r}_device_ms']:.4f}"
                for r in ("cluster", "stream", "scalar")
                if f"{d}_{r}_ms" in row)
        print(f"  [{card}] K1 ({n},{','.join(map(str, hwc))}) act={act} "
              f"bf16 x{calls}:")
        for d, lib in (("fwd", "F.instance_norm"),
                       ("bwd", "autograd of F.instance_norm")):
            print(f"    {d} {row[d + '_route']}"
                  f"{' of ' + str(row[d + '_cluster']) if row[d + '_route'] == 'cluster' else ''}"
                  f": {ms[d, 'ms']:.4f} ms events, {ms[d, 'device_ms']:.4f} "
                  f"device (bound {ms[d, 'bound_ms']:.4f}, floor "
                  f"{ms[d, 'floor_ms']:.4f}); other routes, events / device, "
                  f"{others(d)}; "
                  f"plain {ms[d, 'plain_ms']:.4f}, {lib} "
                  f"{ms[d, 'library_ms']:.4f}")
        del x, dy, y, xr, mean, rstd
    torch.cuda.empty_cache()
    for d in ("fwd", "bwd"):
        print(f"  [{card}] K1 {d}, {label}: kernel "
              f"{tot[d, 'ms']:.3f} ms events, {tot[d, 'device_ms']:.3f} ms "
              f"device, plain {tot[d, 'plain_ms']:.3f} ms, F.instance_norm "
              f"{tot[d, 'library_ms']:.3f} ms, bound {tot[d, 'bound_ms']:.3f}"
              f" ms, floor {tot[d, 'floor_ms']:.3f} ms")
    return tot, rows


def k1_vs_plain(n, hwc, act, dtype, dev, seed,
                own_moments: bool = False) -> tuple:
    """Both K1 kernels against their plain twins at one site (phases 7 and
    18): the site's plan, the forward's output and saved moments, then the
    backward fed the kernel's own moments; two calls of each bitwise
    equal.  Returns the largest forward and dx differences; raises outside
    the limits (tests/test_pallas.py's and tests/test_torch_cuda.py's).

    ``own_moments`` (phase 33): the forward's output is held against the
    plain normalize, affine and act of the kernel's own moments, as the
    backward is fed them, and the moments against the plain twin's.  Both
    sides compute var = E[x^2] - mean^2 in f32, as the JAX package does,
    and on a plane of 5 elements whose variance is ~1e-2 of mean^2 their
    two summation orders move rstd by 1e-5 to 3e-5 of itself, each as far
    from the f64 moments as the other; the f32 output's limit is
    ``f32_out_limit``, which allows for that conditioning (it was a fixed
    1e-5 before), and the moments' own limit (1e-4 of rstd) holds
    there."""
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.ops import norm as tnorm
    x, g, b = site_inputs(n, hwc, dtype, dev, seed=seed)
    gd = torch.Generator(device=dev).manual_seed(100 + seed)
    dy = torch.randn(x.shape, generator=gd, device=dev).to(dtype)
    # the forward as the train step calls it: output and moments
    y, mean, rstd = cuda_in.instance_norm_cuda(x, g, b, 1e-3, act, 0.3,
                                               save_stats=True)
    again = cuda_in.instance_norm_cuda(x, g, b, 1e-3, act, 0.3,
                                       save_stats=True)
    if not all(torch.equal(a, c) for a, c in zip((y, mean, rstd), again)):
        raise AssertionError("two K1 forward calls differ bitwise")
    ry, rmean, rrstd = tnorm._ref_forward(x, g, b, 1e-3, act, 0.3)
    if own_moments:
        ry = tnorm._act((x.float() - mean[:, None, None])
                        * rstd[:, None, None] * g + b, act, 0.3).to(dtype)
    if y.dtype != dtype or mean.shape != (n, hwc[-1]):
        raise AssertionError(f"forward output {y.dtype}, moments "
                             f"{tuple(mean.shape)}")
    dy_ = (y.float() - ry.float()).abs()
    tol = TOL[dtype]
    # f32: the fixed limit plus what the plane's conditioning allows
    # (f32_out_limit); bf16: the fixed one
    lim = f32_out_limit(x, g, ry.float(), rmean, rrstd) \
        if dtype == torch.float32 else tol + tol * ry.float().abs()
    # saved moments: tests/test_torch_cuda.py's tolerances
    n_bad = (int((dy_ > lim).sum())
             + int(((mean - rmean).abs() > 1e-5 + 1e-5 * rmean.abs()).sum())
             + int(((rstd - rrstd).abs() > 1e-5 + 1e-4 * rrstd.abs()).sum()))
    f_err = max(dy_.max().item(), (mean - rmean).abs().max().item(),
                (rstd - rrstd).abs().max().item())
    print(f"  ({n},{','.join(map(str, hwc))}) act={act} "
          f"{str(dtype)[6:]}: fwd {plan_line(n, hwc, dtype, 'fwd')}"
          f"; bwd {plan_line(n, hwc, dtype, 'bwd')}")
    print(f"    fwd y{' (of its own moments)' if own_moments else ''}"
          f"/mean/rstd max abs diff {f_err:.3g}, {n_bad} outside; bitwise "
          "repeatable")
    if n_bad:
        raise AssertionError("forward kernel or its moments disagree with "
                             "plain")
    # both backwards fed the kernel's own moments, as the step feeds them:
    # moments that differ by an ulp flip the act gate of the few elements
    # whose pre-activation is that near 0, and each flip moves its whole
    # plane's dx by ~|dy| / (H * W)
    dx, dg, db = cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd, act)
    again = cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd, act)
    if not all(torch.equal(a, c) for a, c in zip((dx, dg, db), again)):
        raise AssertionError("two K1 backward calls differ bitwise")
    rdx, rdg, rdb = tnorm.instance_norm_bwd_ref(x, dy, g, b, mean, rstd, act)
    if dx.dtype != dtype or dx.shape != x.shape:
        raise AssertionError(f"backward output {dx.dtype} {tuple(dx.shape)}")
    d = (dx.float() - rdx.float()).abs()
    err = d.max().item()
    scale = rdx.float().abs().max().item()
    if dtype == torch.float32:  # tests/test_pallas.py's grad tol
        n_bad = int((d > 1e-5 + 1e-4 * rdx.abs()).sum())
    else:
        n_bad = int(err > 2e-2 * scale)
    e_g = max((dg - rdg).abs().max().item()
              / max(rdg.abs().max().item(), 1e-30),
              (db - rdb).abs().max().item()
              / max(rdb.abs().max().item(), 1e-30))
    print(f"    bwd dx max abs diff {err:.3g} (max |dx| {scale:.3g}), "
          f"{n_bad} outside; dgamma/dbeta max rel diff {e_g:.3g} (tol "
          "1e-4); bitwise repeatable")
    if n_bad or e_g > 1e-4:
        raise AssertionError("backward kernel disagrees with plain")
    return f_err, err


# ----------------------------------------------------------------------
# K2: the fused reflect-pad conv3x3 + instance norm
# ----------------------------------------------------------------------

def k2_inputs(shape, dtype, dev, seed):
    """x ~ N(0, 1), an f32 kernel ~ N(0, 1 / (9 cin)) in the port's (cout,
    cin, 3, 3) layout, gamma near 1 and beta near 0, from a seed."""
    n, h, w, cin, cout = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=g, device=dev).to(dtype)
    wk = torch.randn((cout, cin, 3, 3), generator=g, device=dev) \
        / (9 * cin) ** 0.5
    gamma = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
    beta = 0.1 * torch.randn(cout, generator=g, device=dev)
    return x, wk, gamma, beta


def k2_bound(shape, dtype, backward: bool = False) -> tuple:
    """(least ms, what bounds it) of one K2 forward, or backward: every
    input read once and every output written once at HBM rate, or the
    convs' operations at the peak rate of the dtype's route (bf16 tensor
    cores, f32 plain FMAs).  Forward: x, the f32 kernel, gamma, beta in;
    y, y16, mean, rsig out; one conv.  Backward: x, the kernel, y16, dy,
    gamma, beta, mean, rsig in; dx, dw, dgamma, dbeta out; dgrad and
    wgrad, each the forward conv's operations."""
    n, h, w, cin, cout = shape
    sz = torch.finfo(dtype).bits // 8
    if backward:
        by = (n * h * w * (2 * cin + 2 * cout) * sz
              + 4 * (2 * 9 * cin * cout + 4 * cout + 2 * n * cout))
    else:
        by = (n * h * w * (cin + 2 * cout) * sz
              + 4 * (9 * cin * cout + 2 * cout + 2 * n * cout))
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes = by / HBM_BYTES_PER_S
    t_ops = (2 if backward else 1) * 2 * 9 * cin * cout * n * h * w / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else \
        "operations"


def k2_tols(dtype, full: bool) -> dict:
    """abs + rel limits of y, y16 and the moments against the plain twin.
    f32 at the small shapes: tests/test_pallas_conv_in.py's 2e-5.  f32 at
    full width: 1e-4, sums of 2,304 terms in another order than cuDNN's
    (the run prints what it found).  bf16: y 5e-2, since one bf16 ulp of
    y16 from another summation order before the single rounding is up to
    2^-8 of a value near 4 sigma after normalizing; y16 itself within one
    ulp (2^-7 rel); moments 2e-3."""
    if dtype == torch.bfloat16:
        return {"y": 5e-2, "y16": 2.0 ** -7, "mean": 2e-3, "rsig": 2e-3}
    t = 1e-4 if full else 2e-5
    return {"y": t, "y16": t, "mean": t, "rsig": t}


def k2_forward_vs_plain(dev) -> dict:
    """Phase 11.  Returns the largest |y - plain y| per dtype."""
    from sggan_tpu_torch.ops import cuda_conv_in as cci
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for full, shapes in ((False, K2_SMALL), (True, K2_FULL)):
        for si, shape in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                tols = k2_tols(dtype, full)
                x, wk, g, b = k2_inputs(shape, dtype, dev, seed=si)
                route = cci.conv_plan(*shape, dtype).kernel
                worst = dict.fromkeys(tols, 0.0)
                for act in K2_ACTS:
                    before = cci.route_launches[route]
                    got = cci.conv3_in_cuda(x, wk, g, b, 1e-3, act, 0.3)
                    again = cci.conv3_in_cuda(x, wk, g, b, 1e-3, act, 0.3)
                    if cci.route_launches[route] != before + 2:
                        raise AssertionError(f"K2 did not run {route}")
                    ref = cci.conv3_in_ref(x, wk, g, b, 1e-3, act, 0.3)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, c) for a, c in zip(got, again)):
                        raise AssertionError("two K2 calls differ bitwise")
                    for (name, tol), a, r in zip(tols.items(), got, ref):
                        if a.dtype != r.dtype or a.shape != r.shape:
                            raise AssertionError(f"K2 {name}: {a.dtype} "
                                                 f"{tuple(a.shape)}")
                        d = (a.float() - r.float()).abs()
                        worst[name] = max(worst[name], d.max().item())
                        if (d > tol + tol * r.float().abs()).any():
                            raise AssertionError(
                                f"K2 {name} disagrees with its plain twin at "
                                f"{shape} act={act} {dtype}: max abs diff "
                                f"{d.max().item():.3g}, tol {tol:.3g}")
                    del got, again, ref
                errs[dtype] = max(errs[dtype], worst["y"])
                print(f"  {shape} {str(dtype)[6:]} {route}, acts "
                      f"{K2_ACTS}: max abs diff "
                      + ", ".join(f"{k} {v:.3g} (tol {tols[k]:.3g} abs + rel)"
                                  for k, v in worst.items())
                      + "; bitwise repeatable")
                del x
            torch.cuda.empty_cache()
    return errs


def k2_plain_bwd(x, wk, g, b, y16, mean, rsig, dy, act):
    """The plain route of ``conv3_in``'s backward on any device: K1's
    plain backward twin on y16, then the library dgrad and wgrad."""
    from sggan_tpu_torch.ops import cuda_conv_in as cci
    from sggan_tpu_torch.ops.norm import instance_norm_bwd_ref
    d_y16, dg, db = instance_norm_bwd_ref(y16, dy, g, b, mean, rsig, act, 0.3)
    return (*cci.conv_grads(x, wk, d_y16), dg, db)


def k2_backward_vs_plain(dev) -> dict:
    """Phase 12.  dx, dw, dgamma, dbeta of ``conv3_in`` on the card against
    (a) the plain backward fed the kernel's own saved y16, mean and rsig,
    as the Function feeds K1's backward kernel, at every shape; (b) the
    fully plain route (plain twin forward, plain backward) on the card
    and the Function on the CPU, at the small shapes.  (a) and (b) are
    held to 2e-4 of each tensor's largest in f32 (the JAX test's 2e-4) and
    2e-2 in bf16 (d_y16 and dx are rounded to bf16).  At full width (b)
    on the card is held only to 2e-2 in norm: the two forwards' y16 differ
    in the last bits, which gates the few of 33 million elements whose
    pre-activation is that near 0 the other way, and each such element
    moves its gradient by its whole dy.  Returns the largest
    |dx - plain dx| of (a) per dtype."""
    from sggan_tpu_torch.ops import cuda_conv_in as cci
    from sggan_tpu_torch.ops import cuda_in
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    names = ("dx", "dw", "dgamma", "dbeta")

    def worst(got, ref, norm=False):
        out = {}
        for name, a, r in zip(names, got, ref):
            a, r = a.float(), r.to(dev).float()
            if a.shape != r.shape:
                raise AssertionError(f"K2 {name} shape {tuple(a.shape)}")
            if norm:
                out[name] = ((a - r).norm() / r.norm().clamp_min(1e-30)).item()
            else:
                out[name] = (a - r).abs().max().item() / max(
                    r.abs().max().item(), 1e-30)
        return out

    for full, shapes in ((False, K2_SMALL), (True, K2_FULL)):
        for si, shape in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                tol = 2e-4 if dtype == torch.float32 else 2e-2
                x, wk, g, b = k2_inputs(shape, dtype, dev, seed=10 + si)
                gd = torch.Generator(device=dev).manual_seed(20 + si)
                dy = torch.randn((*shape[:3], shape[4]), generator=gd,
                                 device=dev).to(dtype)
                for act in K2_ACTS:
                    leaves = [t.detach().requires_grad_(True)
                              for t in (x, wk, g, b)]
                    before = cci.launches, cuda_in.bwd_launches
                    y = cci.conv3_in(*leaves, act=act)
                    saved = [t.detach() for t in y.grad_fn.saved_tensors]
                    got = torch.autograd.grad(y, leaves, dy)
                    if (cci.launches, cuda_in.bwd_launches) != (
                            before[0] + 1, before[1] + 1):
                        raise AssertionError("conv3_in did not run one K2 "
                                             "and one K1 backward launch")
                    if got[0].dtype != dtype or got[1].dtype != wk.dtype:
                        raise AssertionError("K2 gradient dtypes")
                    fed_ref = k2_plain_bwd(*saved, dy, act)
                    fed = worst(got, fed_ref)
                    errs[dtype] = max(errs[dtype], (
                        got[0].float() - fed_ref[0].float()).abs().max()
                        .item())
                    _, y16, mean, rsig = cci.conv3_in_ref(x, wk, g, b, 1e-3,
                                                          act, 0.3)
                    plain = k2_plain_bwd(x, wk, g, b, y16, mean, rsig, dy,
                                         act)
                    if full:
                        indep = worst(got, plain, norm=True)
                        limit, what = STEP_NORM_REL, "|diff| / |g|"
                    else:
                        cl = [t.detach().cpu().requires_grad_(True)
                              for t in (x, wk, g, b)]
                        cpu = torch.autograd.grad(cci.conv3_in(*cl, act=act),
                                                  cl, dy.cpu())
                        indep = {k: max(v, w) for (k, v), w in zip(
                            worst(got, plain).items(),
                            worst(got, cpu).values())}
                        limit, what = tol, "max |diff| / max |g|"
                    torch.cuda.synchronize()
                    print(f"  {shape} act={act} {str(dtype)[6:]}: fed the "
                          "kernel's saved tensors, max |diff| / max |g| "
                          + ", ".join(f"{k} {v:.3g}" for k, v in fed.items())
                          + f" (tol {tol}); plain route throughout, {what} "
                          + ", ".join(f"{k} {v:.3g}" for k, v in indep.items())
                          + f" (tol {limit})")
                    if max(fed.values()) > tol or max(indep.values()) > limit:
                        raise AssertionError("K2 gradients disagree with "
                                             "the plain route")
                    del y, got, saved, fed_ref, plain, y16, leaves
                del x, dy
            torch.cuda.empty_cache()
    return errs


def k2_resblock(card: str, dev) -> dict:
    """Phase 13.  The activation that enters the generator's first
    resblock at 256x512, b=16, through x + K2(act=None)(K2(act=relu)(x))
    with r1's parameters, against ``GeneratorResnet._res_block``."""
    from sggan_tpu_torch.models.generator_resnet import GeneratorResnet
    from sggan_tpu_torch.ops import conv2d, conv2d_reflect, instance_norm
    from sggan_tpu_torch.ops import cuda_conv_in as cci

    gen = GeneratorResnet(ngf=NGF, generator=torch.Generator().manual_seed(0))
    gen = gen.to(dev)
    r1 = gen.r1
    gx = torch.Generator().manual_seed(1)
    img = torch.round(torch.rand(B_TRAIN, H, W, 3, generator=gx) * 255.0)
    img = img.to(dev)

    def k2_block(x):
        h = cci.conv3_in(x, r1["conv1"]["w"], r1["in1"]["gamma"],
                         r1["in1"]["beta"], act="relu")
        return x + cci.conv3_in(h, r1["conv2"]["w"], r1["in2"]["gamma"],
                                r1["in2"]["beta"], act=None)

    out = {}
    for cd in (torch.bfloat16, torch.float32):
        with torch.no_grad():
            x = conv2d_reflect(gen.c1, img.to(cd), cd, bias=False)
            x = instance_norm(gen.c1_in, x, act="relu")
            x = conv2d(gen.c2, x, 2, "SAME", cd, bias=False)
            x = instance_norm(gen.c2_in, x, act="relu")
            x = conv2d(gen.c3, x, 2, "SAME", cd, bias=False)
            x = instance_norm(gen.c3_in, x, act="relu")
        if tuple(x.shape) != (B_TRAIN, H // 4, W // 4, 4 * NGF):
            raise AssertionError(f"resblock input {tuple(x.shape)}")
        gd = torch.Generator(device=dev).manual_seed(2)
        dy = torch.randn(x.shape, generator=gd, device=dev).to(cd)

        def fwd_bwd(block):
            # gradients to x and to r1's parameters (its conv biases are
            # dead: an instance norm follows)
            xl = x.detach().requires_grad_(True)
            y = block(xl)
            return y.detach(), torch.autograd.grad(
                y, [xl, *r1.parameters()], dy, allow_unused=True)[0]

        before = cci.launches
        y_k, dx_k = fwd_bwd(k2_block)
        if cci.launches != before + 2:
            raise AssertionError("the K2 resblock did not launch K2 twice")
        y_r, dx_r = fwd_bwd(lambda t: gen._res_block(r1, t, cd))
        torch.cuda.synchronize()
        fwd_err = (y_k.float() - y_r.float()).abs().max().item()
        scale = y_r.float().abs().max().item()
        g_err = (dx_k.float() - dx_r.float()).abs().max().item()
        g_scale = dx_r.float().abs().max().item()
        g_norm = ((dx_k.float() - dx_r.float()).norm()
                  / dx_r.float().norm()).item()
        # forward: f32 at the generator's card-vs-CPU limit; bf16 two ulps
        # of the largest output (y16 may differ by an ulp in each of the
        # two stages, then the skip sum is rounded).  Gradient to x: the
        # two paths' conv outputs differ in the last bits, so the relu
        # gates the few of 33 million elements whose pre-activation is
        # that near 0 the other way, and each moves dx around it by its
        # whole dy (phase 12 shows the same between K2 and its own plain
        # route).  So dx is held in norm, f32 2e-3 and bf16 2e-2, and
        # pointwise only to the train step's 0.1 of the largest element
        if cd == torch.float32:
            f_tol, n_tol = SLICE_ATOL, 2e-3
        else:
            # one bf16 ulp of the largest output's binade: 2^(e - 7)
            f_tol = 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)
            n_tol = STEP_NORM_REL
        print(f"  {str(cd)[6:]}: forward max abs diff {fwd_err:.3g} (max |y| "
              f"{scale:.3g}, tol {f_tol:.3g}); dx |diff| / |dx| {g_norm:.3g} "
              f"(tol {n_tol}), max abs diff {g_err:.3g} (max |dx| "
              f"{g_scale:.3g}, tol {STEP_MAX_REL} of it)")
        if not (y_k.dtype == cd and y_k.shape == y_r.shape
                and torch.isfinite(y_k.float()).all()
                and fwd_err <= f_tol and g_norm <= n_tol
                and g_err <= STEP_MAX_REL * g_scale):
            raise AssertionError("the K2 resblock disagrees with _res_block")
        key = str(cd)[6:]
        with torch.no_grad():
            out[key, "k2_fwd"] = cuda_ms(lambda: k2_block(x), 5, warmup=2)
            out[key, "lib_fwd"] = cuda_ms(
                lambda: gen._res_block(r1, x, cd), 5, warmup=2)
        out[key, "k2_fwdbwd"] = cuda_ms(lambda: fwd_bwd(k2_block), 5,
                                        warmup=2)
        out[key, "lib_fwdbwd"] = cuda_ms(
            lambda: fwd_bwd(lambda t: gen._res_block(r1, t, cd)), 5, warmup=2)
        print(f"  [{card}] resblock (16,64,128,256) {key}: forward K2 "
              f"{out[key, 'k2_fwd']:.3f} ms, _res_block "
              f"{out[key, 'lib_fwd']:.3f} ms; forward + gradient to x and "
              f"parameters K2 {out[key, 'k2_fwdbwd']:.3f} ms, _res_block "
              f"{out[key, 'lib_fwdbwd']:.3f} ms")
        del x, dy, y_k, y_r, dx_k, dx_r
        torch.cuda.empty_cache()
    return out


K2_CATEGORIES = [("K2 conv pass", ("k2_conv",)),
                 ("K2 moments", ("k2_moments",)),
                 ("K2 normalize pass", ("k2_normalize",)),
                 ("weight packing", ("copy", "elementwise"))]
# what the K2 forward must not contain: a library convolution or matrix
# product, or the reflect pad's gather
K2_FORBIDDEN = ("cudnn", "xmma", "gemm", "cutlass", "conv", "implicit",
                "index", "gather")


def k2_profile(card: str, dev, wall_ms: float) -> None:
    """Device kernels of the K2 forward at the resblock shape (profiler
    over 3 calls); raises if one is a library convolution or a gather."""
    from torch.profiler import ProfilerActivity, profile

    from sggan_tpu_torch.ops import cuda_conv_in as cci
    x, wk, g, b = k2_inputs(K2_FULL[0], torch.bfloat16, dev, seed=0)
    with torch.no_grad():
        cci.conv3_in(x, wk, g, b, act="relu")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                cci.conv3_in(x, wk, g, b, act="relu")
            torch.cuda.synchronize()
    print_breakdown(prof, 3, wall_ms, f"[{card}] profiler, K2 forward "
                    f"{K2_FULL[0]} bf16", K2_CATEGORIES)
    names = [k[2] for k in kernel_times(prof, 1)]
    if not any("k2_conv_wgmma" in k for k in names):
        raise AssertionError("the profiler saw no k2_conv_wgmma kernel")
    bad = [k for k in names if "k2_" not in k
           and any(t in k.lower() for t in K2_FORBIDDEN)]
    if bad:
        raise AssertionError(f"library kernels inside the K2 forward: {bad}")


# ----------------------------------------------------------------------
# The data pipeline and the trainer (phases 15 and 16)
# ----------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
SRC_H, SRC_W = 512, 1024     # the synthetic set's source resolution
E2E_TRAIN, E2E_TEST = 96, 2  # its train and test triplets
E2E_B, E2E_EPOCHS = 12, 3    # per-file batch, doubled by augmentation
PRE_DISTINCT, PRE_ITERS = 12, 10
IMG_ATOL = 1e-5  # tests/test_torch_data.py's limit on [0, 1] images
# perf_epoch_e2e.py's "fused-aug" variant: the default user config, batch
# 12 doubled by augmentation, 256x512 bf16 sggan with the ResNet
E2E_ARGS = ["--batch_size", str(E2E_B), "--use_augmentation",
            "--img_height", str(H), "--img_width", str(W),
            "--loss_mode", "sggan", "--use_resnet", "--segment_class",
            str(N_CLASS), "--compute_dtype", "bfloat16", "--max_size", "50",
            "--data_seed", "19", "--save_freq", "0", "--print_freq", "1000",
            "--eval_freq", "1000", "--decode_cache_mb", "8192",
            "--scan_steps", "8", "--host_downscale", "2"]
PRE_CATEGORIES = [("resize (f32 GEMMs)", ("gemm",)),
                  ("gathers: batch, warp taps, blur pads", ("index",)),
                  ("random draws", ("distribution",)),
                  ("copies and casts", ("copy",))]
LOOP_CATEGORIES = [("preprocess: random draws", ("distribution",)),
                   ("preprocess: resize GEMMs (f32)", ("sgemm",
                                                       "gemm_f32f32")),
                   *STEP_CATEGORIES]


def synth_triplet(rng, i: int, yy, xx):
    """One triplet of ``perf_epoch_e2e.build_dataset``: a smooth sinusoid
    per channel, a checkerboard of 64-pixel cells over the 34 class ids,
    and its colour seg map."""
    ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    fr = rng.uniform(1, 4, 3).astype(np.float32)
    img = np.stack([
        127.5 * (1 + np.sin(fr[c] * (xx / SRC_W * 6.28 + ph[c])
                            + yy / SRC_H * fr[(c + 1) % 3]))
        for c in range(3)], -1).astype(np.uint8)
    cls = ((yy // 64 + xx // 64 + i) % 34).astype(np.uint8)
    seg = np.stack([cls * 7, 255 - cls * 7, cls * 3], -1).astype(np.uint8)
    return img, seg, cls


def build_dataset(root: str, n: int, splits=None, seed: int = 0) -> float:
    """``perf_epoch_e2e.build_dataset``: ``n`` train and ``E2E_TEST`` test
    triplets of 512x1024 PNGs under root/{trainA,testA}{,_seg,_seg_class},
    drawn in its order from ``seed``; the PNG encodes run on a thread
    pool.  ``splits``, (split, count) pairs, adds those splits to an
    existing root instead (the cycle mode's trainB, phase 25).  Returns
    the seconds it took."""
    from PIL import Image
    if splits is None:
        if os.path.isdir(root):
            shutil.rmtree(root)
        splits = (("trainA", n), ("testA", E2E_TEST))
    t0 = time.perf_counter()
    yy, xx = np.mgrid[0:SRC_H, 0:SRC_W].astype(np.float32)
    rng = np.random.default_rng(seed)
    jobs = []
    for split, count in splits:
        for sub in ("", "_seg", "_seg_class"):
            os.makedirs(os.path.join(root, split + sub))
        for i in range(count):
            nm = f"s{i:04d}.png"
            for sub, a in zip(("", "_seg", "_seg_class"),
                              synth_triplet(rng, i, yy, xx)):
                jobs.append((a, os.path.join(root, split + sub, nm)))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda j: Image.fromarray(j[0]).save(j[1]), jobs))
    return time.perf_counter() - t0


def fake_u8_inputs() -> np.ndarray:
    """Every lattice point x = 2k/255 - 1 with its 4 f32 neighbours each
    side (the only places a plain f32 formula flips a code), then 2^24
    values evenly strided over the f32 bit patterns of [-1, 1]."""
    xb = (2.0 * np.arange(256) / 255.0 - 1.0).astype(np.float32)
    pts, dn, up = [xb], xb, xb
    for _ in range(4):
        dn = np.nextafter(dn, np.float32(-2))
        up = np.nextafter(up, np.float32(2))
        pts += [dn, up]
    top = int(np.float32(1).view(np.uint32))
    pos = np.linspace(0, top, 1 << 23).astype(np.uint32).view(np.float32)
    return np.clip(np.concatenate(pts + [pos, -pos]), -1, 1)


def draws_to(draws, dev):
    """A copy of nested NamedTuples of tensors on ``dev``."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws.to(dev)
    return type(draws)(*(draws_to(t, dev) for t in draws))


def held(name: str, got: dict, ref: dict, exact=("mask_a",)) -> float:
    """Largest |card - CPU| of the images (limit ``IMG_ATOL``); the masks
    must be equal.  Raises otherwise."""
    worst = 0.0
    for k, r in ref.items():
        g = got[k].cpu()
        if g.shape != r.shape or g.dtype != r.dtype \
                or not torch.isfinite(g).all():
            raise AssertionError(f"{name} {k}: {g.dtype} {tuple(g.shape)}")
        if k in exact:
            if not torch.equal(g, r):
                raise AssertionError(f"{name} {k} differs from the CPU's")
            continue
        d = (g - r).abs().max().item()
        worst = max(worst, d)
        if d > IMG_ATOL:
            raise AssertionError(f"{name} {k}: max |card - CPU| {d:.3g} > "
                                 f"{IMG_ATOL}")
    return worst


def preprocess_phase(card: str, dev) -> dict:
    """Phase 15.  The preprocess on the card against the port's own CPU
    run on the same inputs and draws, at the trainer's source shape;
    fake_u8 and seg_labels_u8 bit-exact against the host conversions;
    preprocess img/s.  Returns {(host_downscale, photometric): img/s}."""
    from sggan_tpu_torch.data import preprocess as tp
    from sggan_tpu_torch.data.loader import _downscale
    from sggan_tpu_torch.utils.images import inverse_transform
    out_hw, mask_hw = (H, W), (H // 8, W // 8)
    yy, xx = np.mgrid[0:SRC_H, 0:SRC_W].astype(np.float32)
    rng = np.random.default_rng(15)
    trips = [synth_triplet(rng, i, yy, xx) for i in range(PRE_DISTINCT)]
    rates = {}
    for ds in (2, 1):
        src = trips if ds == 2 else [
            (_downscale(a, out_hw), _downscale(b, out_hw),
             _downscale(c, out_hw, nearest=True)) for a, b, c in trips]
        # doubled into [plain, to-augment] halves, as the iterators emit
        arrays = [np.concatenate([np.stack([t[k] for t in src])] * 2)
                  for k in range(3)]
        b, sh = arrays[0].shape[:2]
        cpu_in = [torch.from_numpy(a) for a in arrays]
        cpu_in.append(torch.arange(b) >= b // 2)
        dev_in = [t.to(dev) for t in cpu_in]
        for pho in (False, True):
            g = torch.Generator(device=dev).manual_seed(150 + ds)
            kw = dict(out_hw=out_hw, mask_hw=mask_hw, n_class=N_CLASS,
                      photometric=pho, aug_layout="half")
            draws = tp.draw_preprocess(g, b, sh, out_hw, pho)
            got = tp.preprocess_train(*dev_in[:3], draws, dev_in[3], **kw)
            ref = tp.preprocess_train(*cpu_in[:3], draws_to(draws, "cpu"),
                                      cpu_in[3], **kw)
            if got["real_a"].shape != (b, H, W, 3) \
                    or got["mask_a"].shape != (b, *mask_hw, N_CLASS):
                raise AssertionError("preprocess_train output shapes")
            err = held(f"preprocess_train ds{ds} photometric={pho}", got,
                       ref)

            def run():
                tp.preprocess_train(*dev_in[:3], tp.draw_preprocess(
                    g, b, sh, out_hw, pho), dev_in[3], **kw)
            ms = cuda_ms(run, PRE_ITERS, warmup=3)
            rates[ds, pho] = 1e3 * b / ms
            print(f"  [{card}] preprocess_train {sh}x{arrays[0].shape[2]}"
                  f" -> {H}x{W}, b={b} half layout, "
                  f"photometric {'on' if pho else 'off'}: card vs CPU max "
                  f"abs diff {err:.3g} (tol {IMG_ATOL}), masks and flips "
                  f"equal; {ms:.3f} ms with its draws, "
                  f"{rates[ds, pho]:.1f} img/s")
        n = PRE_DISTINCT
        kw = dict(out_hw=out_hw, mask_hw=mask_hw, n_class=N_CLASS)
        got = tp.preprocess_test(*(t[:n] for t in dev_in[:3]), **kw)
        ref = tp.preprocess_test(*(t[:n] for t in cpu_in[:3]), **kw)
        names = ("img", "seg", "mask_full", "mask_grid")
        err = held(f"preprocess_test ds{ds}", dict(zip(names, got)),
                   dict(zip(names, ref)), exact=names[2:])
        labels = tp.seg_labels_u8(got[1]).cpu().numpy()
        host = (255 * got[1].cpu().numpy()).astype(np.uint8)
        if not np.array_equal(labels, host):
            raise AssertionError("seg_labels_u8 differs from the host cast")
        print(f"  preprocess_test ds{ds} ({n} triplets, both masks): card vs "
              f"CPU max abs diff {err:.3g}; seg_labels_u8 bit-exact")
        del dev_in, got
    r = np.random.default_rng(0).uniform(-0.1, 1.1, 1 << 20)
    r = r.astype(np.float32)
    with np.errstate(invalid="ignore"):  # the host cast wraps, on purpose
        host = (255 * r).astype(np.uint8)
    if not np.array_equal(tp.seg_labels_u8(torch.from_numpy(r).to(dev))
                          .cpu().numpy(), host):
        raise AssertionError("seg_labels_u8 does not wrap as the host does")
    x = fake_u8_inputs()
    got = tp.fake_u8(torch.from_numpy(x).to(dev)).cpu().numpy()
    bad = int((got != inverse_transform(x)).sum())
    print(f"  seg_labels_u8 bit-exact on {r.size} values in [-0.1, 1.1] "
          f"(the wrap mod 256 included); fake_u8 vs the f64 host "
          f"inverse_transform on {x.size} values: {bad} differ")
    if bad:
        raise AssertionError("fake_u8 is not bit-exact")
    torch.cuda.empty_cache()
    return rates


def repo_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def run_cli(run_dir: str, label: str, args: list,
            module: str = "sggan_tpu_torch.main", show=print) -> tuple:
    """``python -m <module>`` with ``args`` in ``run_dir``; returns
    (stdout, seconds), its exit and last lines given to ``show``.  Raises
    if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          cwd=run_dir, env=repo_env(), capture_output=True,
                          text=True, timeout=600)
    dt = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    shown = [ln for ln in lines if not ln.startswith("Processing image")]
    show(f"  python -m {module}, {label}: exit {proc.returncode} in "
         f"{dt:.1f} s")
    for ln in shown[-8:]:
        show(f"    | {ln}")
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"python -m {module} failed")
    return proc.stdout, dt


def test_beside_resume(run_dir: str, args: list) -> tuple:
    """``--phase test`` and a one-epoch ``--continue_train`` of ``run_dir``'s
    checkpoint side by side (neither timed; the test loads the latest
    checkpoint whole, the saved one or the resume's next): their
    (stdout, seconds)."""
    with ThreadPoolExecutor(2) as pool:
        test = pool.submit(run_cli, run_dir, "test",
                           ["--phase", "test", *args])
        resume = pool.submit(run_cli, run_dir, "resume for 1 epoch",
                             ["--phase", "train", "--continue_train",
                              "--epoch", "1", *args])
        return test.result(), resume.result()


def need(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def chunk_prints(nb: int, k: int, pf: int) -> list:
    """The steps an epoch of ``nb`` steps in chunks of ``k`` prints at
    under ``--print_freq`` ``pf``, by the JAX chunk loop's rule
    (sggan_tpu/train/fused.py:270)."""
    out, done = [], 0
    while done < nb:
        kc = min(k, nb - done)
        if done == 0 or (done - 1) // pf != (done + kc - 1) // pf:
            out.append(done + kc - 1)
        done += kc
    return out


def need_captured(out: str, k1_per_step: int, k: int = 8) -> None:
    """A CLI training run's output shows its step captured as a CUDA graph
    with ``k1_per_step`` K1 calls each way, ``k`` steps a chunk, and no
    per-step fallback."""
    need(" [*] train step captured as a CUDA graph" in out
         and f"(K1 calls a step: {k1_per_step} forward, {k1_per_step} "
             f"backward); {k} steps a chunk" in out,
         "the run did not capture its step as a CUDA graph of "
         f"{k1_per_step} + {k1_per_step} K1 calls, {k} steps a chunk")
    need("falling back" not in out, "the run fell back to per-step "
         "dispatch")


def trainer_phase(card: str, dev, work: str) -> dict:
    """Phase 16.  The trainer end to end through the CLI on the synthetic
    PNG set: train, test, resume; then one epoch in-process with K1's
    counts and a profiler window.  Returns the numbers for the summary."""
    from torch.profiler import ProfilerActivity, profile

    from sggan_tpu_torch.config import parse_args
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.train import fused
    from sggan_tpu_torch.train.trainer import Trainer
    from sggan_tpu_torch.utils.summary import read_scalars

    root = os.path.join(work, "datasets", "city")
    t_build = build_dataset(root, E2E_TRAIN)
    print(f"  dataset: {E2E_TRAIN} + {E2E_TEST} triplets of {SRC_H}x{SRC_W} "
          f"PNGs in {t_build:.1f} s")
    steps = E2E_TRAIN // E2E_B
    b_eff = 2 * E2E_B
    args = E2E_ARGS + ["--dataset_dir", root]
    run_dir = os.path.join(work, "cli")
    os.makedirs(run_dir)
    ck = os.path.join(run_dir, "checkpoint", "city")

    def saved_step(epoch: int) -> int:
        return torch.load(os.path.join(ck, "train", f"cp-{epoch:04d}.pt"),
                          weights_only=True)["step"]

    out, _ = run_cli(run_dir, f"train {E2E_EPOCHS} epochs",
                     ["--phase", "train", "--epoch", str(E2E_EPOCHS), *args])
    need(" [*] training split resident" in out,
         "the trainer did not take the resident split")
    need_captured(out, LAUNCHES_PER_STEP)
    losses = [(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"Gen_Loss: (\S+) Disc_Loss: (\S+)", out)]
    need(len(losses) == E2E_EPOCHS
         and all(math.isfinite(v) for p in losses for v in p),
         f"losses not finite at every print: {losses}")
    m = re.search(r"Training finished: step (\d+), (\d+) images in "
                  r"([\d.]+) s", out)
    need(m and int(m.group(1)) == E2E_EPOCHS * steps,
         "the run did not finish its steps")
    wall_rate = int(m.group(2)) / float(m.group(3))
    for part in ("gen", "disc", "train"):
        need(os.path.isfile(os.path.join(
            ck, part, f"cp-{E2E_EPOCHS - 1:04d}.pt")), f"no {part} checkpoint")
    need(saved_step(E2E_EPOCHS - 1) == E2E_EPOCHS * steps,
         "the checkpoint holds another step")
    test_dir = os.path.join(run_dir, "test")
    need(all(os.path.isfile(os.path.join(test_dir, f"s{i:04d}.png"))
             for i in range(E2E_TEST)), "the eval wrote no test PNGs")
    events = glob.glob(os.path.join(run_dir, "logs", "*", "train",
                                    "events.out.tfevents.*"))
    need(len(events) == 1, "no tfevents file")
    scalars = read_scalars(events[0])
    rates = [v for _, v in scalars["Images/sec"]]
    need(len(rates) == E2E_EPOCHS and "Mean IoU" in scalars,
         f"tfevents scalars {sorted(scalars)}")
    sustained = float(np.mean(rates[1:]))
    print(f"  [{card}] e2e fused-aug, {E2E_TRAIN} triplets, b={E2E_B} "
          f"doubled to {b_eff}/step, {steps} steps/epoch: epoch img/s "
          f"{[round(r, 2) for r in rates]} (StepTimer), sustained "
          f"(epochs >= 1) {sustained:.2f} img/s, whole run {wall_rate:.2f} "
          "img/s (train() wall: resident-split decode and upload, eval, "
          "saves included)")

    (out, _), (res, _) = test_beside_resume(run_dir, args)
    need(" [*] Load SUCCESS" in out, "--phase test did not load")
    need(all(os.path.isfile(os.path.join(test_dir, f"real_s{i:04d}.png"))
             for i in range(E2E_TEST)), "--phase test wrote no PNGs")
    out = res
    need(" [*] Load SUCCESS" in out, "--continue_train did not load")
    resumed = saved_step(E2E_EPOCHS)
    print(f"  resumed at step {saved_step(E2E_EPOCHS - 1)}, saved cp-"
          f"{E2E_EPOCHS:04d} at step {resumed}")
    need(resumed == (E2E_EPOCHS + 1) * steps,
         "--continue_train did not resume at the saved step")

    # one epoch in-process, eager (--scan_steps 1): K1's counts a step
    # and a profiler window of 2 steps
    own = os.path.join(work, "inproc")
    cfg = parse_args(["--phase", "train", "--epoch", "1", *args,
                      "--scan_steps", "1",
                      *(x for d in ("checkpoint", "test", "sample", "log",
                                    "profile")
                        for x in (f"--{d}_dir", os.path.join(own, d)))])
    tr = Trainer(cfg, device=dev)
    torch.cuda.empty_cache()
    reset_k1()  # the main path starts here
    tr.train()
    counts, routes = read_k1()
    want = {"fwd": add_routes(planned(step_sites(b_eff), "fwd", steps),
                              planned(gen_sites(E2E_TEST), "fwd",
                                      FWD_GRAPH_CALLS)),
            "bwd": planned(step_sites(b_eff), "bwd", steps)}
    print(f"  one epoch in-process: K1 forward {counts['fwd']}, backward "
          f"{counts['bwd']} ({steps} steps x {LAUNCHES_PER_STEP} each, plus "
          f"the capture of the eval's forward of {E2E_TEST} images, 23 x "
          f"{FWD_GRAPH_CALLS} forward); by route {routes}, planned {want}")
    need(counts["fwd"] == steps * LAUNCHES_PER_STEP + 23 * FWD_GRAPH_CALLS
         and counts["bwd"] == steps * LAUNCHES_PER_STEP,
         "the trainer did not run K1 37 + 37 times a step and 23 x 2 "
         "times in the eval's capture")
    need(routes == want, "the trainer's K1 calls left their planned routes")
    win = tr._prof
    need(win is not None and win.steps == 2, "no profiler window")
    wall_ms = 1e3 * win.seconds / win.steps
    print_breakdown(win.prof, win.steps, wall_ms, f"[{card}] profiler, 2 "
                    f"steps of the epoch loop (batch assembly, preprocess, "
                    f"step; b={b_eff})", LOOP_CATEGORIES)
    busy = sum(k[0] for k in kernel_times(win.prof, win.steps))

    # the batch assembly alone: gather, doubling, draws, preprocess
    ds = tr._maybe_device_dataset()
    make_batch = fused.make_batch_fn(cfg)
    idx = torch.arange(E2E_B, device=dev)

    def assemble():
        make_batch(ds.img, ds.seg, ds.cls, idx,
                   fused.step_draws(tr, ds.img.shape[1])[0])
    pre_ms = cuda_ms(assemble, PRE_ITERS, warmup=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            assemble()
        torch.cuda.synchronize()
    print_breakdown(prof, 2, pre_ms, f"[{card}] profiler, the batch "
                    f"assembly alone (b={b_eff} from the resident split)",
                    PRE_CATEGORIES)
    del tr, ds
    torch.cuda.empty_cache()
    return {"epoch_img_per_s": rates, "sustained_img_per_s": sustained,
            "wall_img_per_s": wall_rate, "trainer_launches": counts,
            "trainer_routes": routes, "loop_step_ms": wall_ms,
            "loop_busy_ms": busy, "loop_idle_share": 1 - busy / wall_ms,
            "assembly_ms": pre_ms}


# ----------------------------------------------------------------------
# The CLI's default nets: the U-Net and the pix2pix pair (phases 17-21)
# ----------------------------------------------------------------------

UNET_HW = [(128, 128), (256, 512)]
# the U-Net's 15 instance norms per forward as (C, act): e1, e2, e3,
# e4-e7, e8, then d1-d4, d5, d6, d7; every one at full resolution
UNET_SITES = [(64, "leaky_relu"), (128, "leaky_relu"), (256, "leaky_relu"),
              (512, "leaky_relu"), (512, "relu"), (512, None), (256, None),
              (128, None), (64, None)]
UNET_COUNT = [1, 1, 1, 4, 1, 4, 1, 1, 1]
UNET_B = 2               # the default batch 1, doubled by augmentation
UNET_WIDE_B = (8, 4, 2)  # 256x512: the largest that fits
UNET_ITERS = 8
# the default CLI (no net or loss flag) on phase 16's PNG set, 128x128
DEFAULT_TRAIN, DEFAULT_EPOCHS, DEFAULT_P2P_TRAIN = 48, 3, 8
UNET_CATEGORIES = [
    ("K1 backward", K1_BWD_KERNELS), ("K1 forward", K1_FWD_KERNELS),
    ("convolutions, all passes (cuDNN)", ("xmma", "conv", "cutlass", "gemm",
                                          "cudnn")),
    ("random draws (dropout masks)", ("distribution",)),
    ("Adam and EMA (foreach)", ("multi_tensor_apply",)),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",))]
# device time by the aten op that launched it: the conv and
# conv-transpose forwards apart, their backwards together (one aten op for
# both kinds); dropout's draws (uniforms, compared to keep) and its apply
# (x / keep, the select, and the select of the backward; the losses'
# few selects and divides on the logits join them).  The U-Net has no
# batch norm.
UNET_OPS = [("conv forward", ("aten::cudnn_convolution",)),
            ("conv-transpose forward", ("aten::cudnn_convolution_transpose",)),
            ("conv and conv-transpose backward",
             ("aten::convolution_backward",)),
            ("dropout draws: rand, lt", ("aten::rand", "aten::lt")),
            ("dropout apply: div, where", ("aten::div", "aten::where"))]


def d_sites(h: int, w: int, ndf: int = 64) -> list:
    """((H, W, C), act) of the semantic discriminator's instance norms at an
    h x w input: h1, h2, h3, then the VALID chain; all leaky_relu."""
    from sggan_tpu_torch.models.discriminator import _valid_chain
    hh, ww = h // 8, w // 8
    out = [(h // 4, w // 4, 2 * ndf), (hh, ww, 4 * ndf), (hh, ww, 8 * ndf)]
    for st in _valid_chain(hh, ww):
        hh, ww = (hh - 3) // st + 1, (ww - 3) // st + 1
        out.append((hh, ww, 8 * ndf))
    return [(hwc, "leaky_relu") for hwc in out]


def unet_sites(b: int, h: int, w: int) -> list:
    """(N, (H, W, C), act, calls) of the U-Net's 15 instance norms."""
    return [(b, (h, w, c), act, k)
            for (c, act), k in zip(UNET_SITES, UNET_COUNT)]


def unet_step_sites(b: int, h: int, w: int) -> list:
    """Every instance norm of one p2p step with the U-Net: the generator's
    15, the discriminator's in the generator loss (batch b) and in the
    one call over [real; fake] (batch 2b)."""
    ds = d_sites(h, w)
    return (unet_sites(b, h, w) + [(b, hwc, act, 1) for hwc, act in ds]
            + [(2 * b, hwc, act, 1) for hwc, act in ds])


def planned(sites, direction: str, times: int = 1,
            dtype=torch.bfloat16) -> dict:
    """K1 calls per route, from the plan, of ``times`` runs of ``sites``."""
    from sggan_tpu_torch.ops import cuda_in
    out = {}
    for n, hwc, _, calls in sites:
        r = cuda_in.plan(n, *hwc, dtype, direction).route
        out[r] = out.get(r, 0) + calls * times
    return out


def add_routes(*counts) -> dict:
    out = {}
    for c in counts:
        for r, k in c.items():
            out[r] = out.get(r, 0) + k
    return out


def reset_k1() -> None:
    from sggan_tpu_torch.ops import cuda_in
    cuda_in.launches = cuda_in.bwd_launches = 0
    cuda_in.route_launches.update(dict.fromkeys(cuda_in.route_launches, 0))


def read_k1() -> tuple:
    """K1's calls since ``reset_k1``: ({direction: calls}, {direction:
    {route: calls}})."""
    from sggan_tpu_torch.ops import cuda_in
    torch.cuda.synchronize()
    return ({"fwd": cuda_in.launches, "bwd": cuda_in.bwd_launches},
            {d: {r: cuda_in.route_launches[d, r]
                 for r in ("cluster", "stream", "scalar")
                 if cuda_in.route_launches[d, r]} for d in ("fwd", "bwd")})


def unet_route(h: int, c: int, dtype, direction: str) -> tuple:
    """(route, cluster) that K1 must take at a U-Net site at b=2
    (tests/test_torch_in_plan.py's table): at 128x128 a 16-CTA cluster at
    C = 64, 256 and 512 and the stream route at C = 128; in f32 the
    backward streams at every C; at 256x512 every site streams."""
    if h == 256 or c == 128 or (dtype, direction) == (torch.float32, "bwd"):
        return "stream", 1
    return "cluster", 16


def op_rows(prof, n_runs: int, wall_ms: float, title: str) -> dict:
    """Device ms per run by the aten op that launched the kernels
    (UNET_OPS), the busy time beside them; prints and returns the rows."""
    busy = sum(k[0] for k in kernel_times(prof, n_runs))
    # the host-side events: each one's device time is its kernels' and its
    # child ops'
    ops = {e.key: e for e in prof.key_averages()
           if not str(getattr(e, "device_type", "")).endswith("CUDA")}

    def dev_ms(e):
        us = getattr(e, "device_time_total", None)
        return (us if us is not None else e.cuda_time_total) / n_runs / 1e3
    rows = {label: sum(dev_ms(ops[k]) for k in keys if k in ops)
            for label, keys in UNET_OPS}
    print(f"  {title}, by op: busy {busy:.3f} ms of {wall_ms:.3f} ms wall")
    for label, ms in rows.items():
        print(f"    {label:34s} {ms:8.4f} ms")
    return rows


def unet_gates(gen, x, cd, masks) -> list:
    """The pre-activations at the U-Net's 10 gates (e1-e8 after IN, the
    sums before the relus of d3 and d7) in one forward, read by wrapping
    the module's own instance norm and relu."""
    import sggan_tpu_torch.models.generator_unet as gu
    pres = []
    real_in, real_relu = gu.instance_norm, gu.relu

    def rec_in(p, v, act=None, **kw):
        if act is not None:
            pres.append(real_in(p, v).float().cpu())
        return real_in(p, v, act=act, **kw)

    def rec_relu(v):
        pres.append(v.float().cpu())
        return real_relu(v)
    gu.instance_norm, gu.relu = rec_in, rec_relu
    try:
        with torch.no_grad():
            gen(x, {}, cd, masks)
    finally:
        gu.instance_norm, gu.relu = real_in, real_relu
    return pres


def unet_forward_phase(card: str, dev) -> dict:
    """Phase 17.  The U-Net (15 K1 calls a forward, with and without
    dropout masks) and the pix2pix generator (batch norm on its fresh
    moving stats, then on the batch's with masks) at 128x128, ngf 64, b=2,
    f32: the card's forward (TF32 off) against the same module's CPU
    forward, at phase 4's limit on the tanh output."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.train import evaluate
    from sggan_tpu_torch.train import step as tstep
    x = torch.rand(UNET_B, 128, 128, 3, generator=torch.Generator()
                   .manual_seed(17))
    errs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for net, kw, k1_calls in (("U-Net", {}, 30),
                                  ("pix2pix", {"use_pix2pix": True}, 0)):
            cfg = Config(ngf=NGF, compute_dtype="float32", **kw)
            gen = evaluate.build_generator(cfg)
            masks = tstep.dropout_masks(cfg, gen, torch.Generator()
                                        .manual_seed(18), UNET_B)

            def runs(g, xx, mm, on):
                st = g.init_bn_state(on)  # fresh moving stats; U-Net {}
                return {"inference": g(xx, st, torch.float32)[0],
                        "training, dropout": g(xx, st, torch.float32, mm,
                                               train=True)[0]}
            with torch.no_grad():
                t0 = time.perf_counter()
                ref = runs(gen, x, masks, "cpu")
                cpu_s = time.perf_counter() - t0
                before = cuda_in.launches
                got = runs(gen.to(dev), x.to(dev), [m.to(dev) for m in masks],
                           dev)
                calls = cuda_in.launches - before
            if calls != k1_calls:
                raise AssertionError(f"{net}: {calls} K1 calls in two "
                                     "forwards")
            for mode, r in ref.items():
                g = got[mode].cpu()
                d = (g - r).abs().max().item()
                errs[f"{net} {mode}"] = d
                print(f"  {net} f32 {mode} b={UNET_B} 128x128: card vs CPU "
                      f"max abs diff {d:.3g} (atol {SLICE_ATOL}); CPU pair "
                      f"{cpu_s:.1f} s; K1 calls on the card {calls}")
                if not (g.shape == r.shape == (UNET_B, 128, 128, 3)
                        and torch.isfinite(g).all() and d <= SLICE_ATOL):
                    raise AssertionError(f"{net} {mode} card forward "
                                         "disagrees with the CPU")
            del gen
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return errs


def unet_k1_sites() -> list:
    """(N, (H, W, C), act), once each, of every instance norm on the U-Net
    paths that phases 19-21 drive: the p2p step's (``unet_step_sites``) at
    128x128 b=2 and at 256x512 at every b of UNET_WIDE_B, the eval's
    forward of E2E_TEST images and the service's b=1 forward at 128x128."""
    sites = [s for b, h, w in ((UNET_B, 128, 128),
                               *((b, 256, 512) for b in UNET_WIDE_B))
             for s in unet_step_sites(b, h, w)]
    sites += unet_sites(E2E_TEST, 128, 128) + unet_sites(1, 128, 128)
    return list(dict.fromkeys((n, hwc, act) for n, hwc, act, _ in sites))


def unet_k1_phase(card: str, dev, errs: dict, bwd_errs: dict) -> dict:
    """Phase 18.  Both K1 kernels against their plain twins at every site
    of ``unet_k1_sites``, f32 and bf16, each call on the route its plan
    names, the generator's sites at b=2 on the route of ``unet_route``
    too; then the bf16 times of the generator's b=2 sites against the
    routes the plan did not take (``time_sites``).  Returns {(h, w):
    (sums, rows)}."""
    from sggan_tpu_torch.ops import cuda_in
    sites = unet_k1_sites()
    for dtype in (torch.float32, torch.bfloat16):
        for i, (n, (h, w, c), act) in enumerate(sites):
            p = {d: cuda_in.plan(n, h, w, c, dtype, d)
                 for d in ("fwd", "bwd")}
            if n == UNET_B and (c, act) in UNET_SITES and (h, w) in UNET_HW:
                for d in ("fwd", "bwd"):
                    if (p[d].route, p[d].cluster) != unet_route(h, c, dtype,
                                                                d):
                        raise AssertionError(f"K1 plan at ({n},{h},{w},{c})"
                                             f" {dtype} {d}: {p[d]}")
            reset_k1()
            f_err, b_err = k1_vs_plain(n, (h, w, c), act, dtype, dev,
                                       seed=200 + i)
            _, routes = read_k1()
            if routes != {d: {p[d].route: 2} for d in ("fwd", "bwd")}:
                raise AssertionError(f"K1 calls left their planned route: "
                                     f"{routes}, plan {p}")
            errs[dtype] = max(errs[dtype], f_err)
            bwd_errs[dtype] = max(bwd_errs[dtype], b_err)
        torch.cuda.empty_cache()
    print(f"  K1 held to its plain twins on its planned routes at "
          f"{len(sites)} U-Net path sites x 2 dtypes")
    out = {}
    for h, w in UNET_HW:
        # one act a width: the act changes one select, not the traffic
        sites = [(UNET_B, (h, w, c), "leaky_relu", k)
                 for c, k in ((64, 2), (128, 2), (256, 2), (512, 9))]
        out[h, w] = time_sites(card, dev, sites, f"the U-Net's 15 calls at "
                               f"{h}x{w} b={UNET_B}")
    return out


def unet_step_cell(card: str, dev, h: int, w: int, b: int,
                   n_steps: int, hist: bool = False) -> dict:
    """The bf16 p2p step with the U-Net (the default nets, dropout on) at
    h x w, batch b: ``n_steps`` steps from counts of 0 with K1's exact
    calls per step by route; then img/s by CUDA events, peak memory and a
    profiler breakdown of 2 steps (by kernel and by op) with the idle
    share.  With ``hist``, under ``--compat_fake_history`` (b the batch
    doubled by augmentation, a history of 9 + b), the history's count
    after each step as the JAX step's.  Raises torch.cuda.OutOfMemoryError
    if it does not fit."""
    from torch.profiler import ProfilerActivity, profile

    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import step as tstep
    cfg = Config(image_height=h, image_width=w, ngf=NGF, ndf=64,
                 segment_class=N_CLASS, batch_size=b // 2 if hist else b,
                 compute_dtype="bfloat16", compat_fake_history=hist)
    holder = [tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)]
    batch = train_batch(cfg, b, dev, seed=5)
    step_fn = tstep.build_step_fn(cfg)
    mask_gen = torch.Generator(device=dev).manual_seed(8)
    seen = []  # the history's count after each step

    def one():
        masks = tstep.dropout_masks(cfg, holder[0].gen_params, mask_gen, b)
        holder[0], m = step_fn(holder[0], batch, 1e-3, None, masks)
        seen.append(holder[0].pool.count)
        return m
    torch.cuda.reset_peak_memory_stats()
    reset_k1()  # this cell's main path starts here
    losses = torch.stack([torch.stack(list(one().values()))
                          for _ in range(n_steps)]).cpu()
    counts, routes = read_k1()
    sites = hist_step_sites(b, h, w) if hist else unet_step_sites(b, h, w)
    per = sum(c for *_, c in sites)
    want = {d: planned(sites, d, n_steps) for d in ("fwd", "bwd")}
    label = "p2p U-Net step" + (f" with a history of {9 + b}" if hist
                                else "")
    print(f"  [{card}] {label} bf16 {h}x{w} b={b}: {n_steps} steps, "
          f"K1 forward {counts['fwd']}, backward {counts['bwd']} ({per} "
          f"each a step expected); by route {routes}, planned {want}; "
          f"losses {[round(v, 4) for v in losses.flatten().tolist()]}"
          + (f"; the history's count {seen}" if hist else ""))
    need(counts == {"fwd": per * n_steps, "bwd": per * n_steps}
         and routes == want, f"the {label}'s K1 calls left their count or "
                             "their planned routes")
    need(bool(torch.isfinite(losses).all()) and holder[0].step == n_steps,
         f"the {label}'s losses are not finite")
    need(not hist or seen == hist_counts(b, n_steps),
         f"the history's count {seen} is not the JAX step's "
         f"{hist_counts(b, n_steps)}")
    iters = UNET_ITERS if b * h * w <= 2 * 128 * 128 else 4
    ms = cuda_ms(one, iters, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  [{card}] {label} bf16 {h}x{w} b={b}: {ms:.3f} ms, "
          f"{1e3 * b / ms:.1f} img/s, peak memory {peak:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            one()
        torch.cuda.synchronize()
    title = f"[{card}] profiler, {label} bf16 {h}x{w} b={b}"
    print_breakdown(prof, 2, ms, title, UNET_CATEGORIES)
    busy = sum(k[0] for k in kernel_times(prof, 2))
    rows = op_rows(prof, 2, ms, title)
    return {"hw": [h, w], "batch": b, "step_ms": ms,
            "img_per_s": 1e3 * b / ms, "peak_gib": peak, "busy_ms": busy,
            "idle_share": 1 - busy / ms, "by_op_ms": rows,
            "k1_per_step": {d: counts[d] // n_steps for d in counts},
            "k1_routes_per_step": {d: {r: k // n_steps for r, k in v.items()}
                                   for d, v in routes.items()}}


def unet_step_phase(card: str, dev) -> dict:
    """Phase 19.  One f32 p2p U-Net step, card against CPU, at 32x64 b=2
    with dropout masks fed (phase 8's limits; a generator gate within f32
    noise of 0 that the two devices put on opposite sides moves every
    gradient upstream of it, and then the full-width limits apply, as
    tests/test_torch_unet.py explains); then the bf16 step cells at
    128x128 b=2 and at 256x512 at the largest of UNET_WIDE_B that fits."""
    from sggan_tpu_torch.config import Config
    unet_card_vs_cpu(Config(image_height=32, image_width=64, ngf=4, ndf=4,
                            segment_class=8, batch_size=2,
                            compute_dtype="float32"), dev)
    cells = {}
    for (h, w), bs, n in (((128, 128), (UNET_B,), 6),
                          ((256, 512), UNET_WIDE_B, 2)):
        for b in bs:
            try:
                cells[f"{h}x{w}"] = unet_step_cell(card, dev, h, w, b, n)
                break
            except torch.cuda.OutOfMemoryError:
                print(f"  [{card}] p2p U-Net step bf16 {h}x{w} b={b}: out "
                      "of memory")
            finally:
                torch.cuda.empty_cache()
        need(f"{h}x{w}" in cells, f"no U-Net step fits at {h}x{w}")
    return cells


def unet_card_vs_cpu(small, dev) -> dict:
    """One f32 step of ``small`` (the U-Net, dropout masks fed, b=2),
    card against CPU: phase 8's limits, or the full-width ones where a
    generator gate falls on opposite sides on the two devices, counted.
    Returns the losses' difference, the worst rows and the flips."""
    from sggan_tpu_torch.train import step as tstep
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    loss_err, rows, _, dead_live = step_card_vs_cpu(small, 2)
    st = tstep.init_state(small, torch.Generator().manual_seed(0), "cpu")
    masks = tstep.dropout_masks(small, st.gen_params,
                                torch.Generator().manual_seed(7), 2)
    x = train_batch(small, 2, "cpu", seed=3)["real_a"]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    cpu_g = unet_gates(st.gen_params, x, torch.float32, masks)
    card_g = unet_gates(st.gen_params.to(dev), x.to(dev), torch.float32,
                        [m.to(dev) for m in masks])
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    flips = sum(int(((a >= 0) != (c >= 0)).sum())
                for a, c in zip(cpu_g, card_g))
    lim = (1e-3, float("inf")) if not flips else (STEP_MAX_REL, STEP_NORM_REL)
    print(f"    generator gates on opposite sides, card vs CPU: {flips}; "
          f"held at max |diff| / max |g| <= {lim[0]}"
          + (f", |diff| / |g| <= {lim[1]}" if flips else ""))
    need(loss_err <= 1e-4 and not dead_live
         and max(r[0] for r in rows) <= lim[0]
         and max(r[1] for r in rows) <= lim[1],
         "the card's U-Net step disagrees with the CPU's")
    return {"loss_max_rel": loss_err, "gate_flips": flips,
            "grad_max_rel": max(r[0] for r in rows),
            "grad_norm_rel": max(r[1] for r in rows)}


def default_cli_phase(card: str, dev, work: str, root: str) -> dict:
    """Phase 20.  ``python -m sggan_tpu_torch.main --phase train`` with no
    net or loss flag (the U-Net with the semantic discriminator, p2p loss,
    dropout on, b=1 doubled to 2, 128x128, bf16) on phase 16's PNG set,
    ``--train_size`` 48: train, test and resume, checked as phase 16 checks
    them; one in-process epoch with K1's exact calls a step; beside the
    last three, one short epoch with ``--use_pix2pix`` whose checkpoint
    carries both nets' BN state, moved by the steps."""
    from sggan_tpu_torch.config import parse_args
    from sggan_tpu_torch.train.trainer import Trainer
    from sggan_tpu_torch.utils.summary import read_scalars
    args = ["--dataset_dir", root, "--train_size", str(DEFAULT_TRAIN),
            "--print_freq", "1000", "--data_seed", "23"]
    run_dir = os.path.join(work, "default_cli")
    os.makedirs(run_dir)
    ck = os.path.join(run_dir, "checkpoint", "city")
    out, _ = run_cli(run_dir, f"no net or loss flag, train "
                     f"{DEFAULT_EPOCHS} epochs",
                     ["--phase", "train", "--epoch", str(DEFAULT_EPOCHS),
                      *args])
    need(" [*] training split resident" in out,
         "the default run did not take the resident split")
    need_captured(out, sum(c for *_, c in unet_step_sites(UNET_B, 128, 128)))
    losses = [(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"Gen_Loss: (\S+) Disc_Loss: (\S+)", out)]
    need(len(losses) == DEFAULT_EPOCHS
         and all(math.isfinite(v) for p in losses for v in p),
         f"losses not finite at every print: {losses}")
    m = re.search(r"Training finished: step (\d+), (\d+) images in "
                  r"([\d.]+) s", out)
    need(m and int(m.group(1)) == DEFAULT_EPOCHS * DEFAULT_TRAIN,
         "the default run did not finish its steps")
    wall_rate = int(m.group(2)) / float(m.group(3))
    gen_cp = torch.load(os.path.join(
        ck, "gen", f"cp-{DEFAULT_EPOCHS - 1:04d}.pt"), weights_only=True)
    need("e8.w" in gen_cp["params"] and gen_cp["bn"] == {},
         "the default run's checkpoint is not the U-Net's")
    events = glob.glob(os.path.join(run_dir, "logs", "*", "train",
                                    "events.out.tfevents.*"))
    need(len(events) == 1, "no tfevents file")
    rates = [v for _, v in read_scalars(events[0])["Images/sec"]]
    need(len(rates) == DEFAULT_EPOCHS, "no Images/sec per epoch")
    sustained = float(np.mean(rates[1:]))
    print(f"  [{card}] default config (U-Net, p2p, 128x128, b=1 doubled to "
          f"2): epoch img/s {[round(r, 2) for r in rates]} (StepTimer), "
          f"sustained (epochs >= 1) {sustained:.2f} img/s, whole run "
          f"{wall_rate:.2f} img/s")
    # the --use_pix2pix epoch (not timed) beside the test, the resume and
    # the in-process epoch (K1's counts, not timed); its lines shown after
    p2p_dir = os.path.join(work, "pix2pix_cli")
    os.makedirs(p2p_dir)
    p2p_log = []
    pool = ThreadPoolExecutor(1)
    p2p_run = pool.submit(
        run_cli, p2p_dir, "--use_pix2pix, 1 epoch",
        ["--phase", "train", "--epoch", "1", "--use_pix2pix", "--dataset_dir",
         root, "--train_size", str(DEFAULT_P2P_TRAIN), "--print_freq", "1"],
        show=p2p_log.append)
    pool.shutdown(wait=False)
    (out, _), (res, _) = test_beside_resume(run_dir, args)
    need(" [*] Load SUCCESS" in out and all(os.path.isfile(os.path.join(
        run_dir, "test", f"real_s{i:04d}.png")) for i in range(E2E_TEST)),
        "--phase test did not load or wrote no PNGs")
    out = res
    resumed = torch.load(os.path.join(ck, "train", f"cp-"
                                      f"{DEFAULT_EPOCHS:04d}.pt"),
                         weights_only=True)["step"]
    need(" [*] Load SUCCESS" in out
         and resumed == (DEFAULT_EPOCHS + 1) * DEFAULT_TRAIN,
         "--continue_train did not resume at the saved step")

    # one epoch in-process, eager (--scan_steps 1): K1's calls a step and
    # by route
    own = os.path.join(work, "default_inproc")
    cfg = parse_args(["--phase", "train", "--epoch", "1", *args,
                      "--scan_steps", "1",
                      *(x for d in ("checkpoint", "test", "sample", "log")
                        for x in (f"--{d}_dir", os.path.join(own, d)))])
    tr = Trainer(cfg, device=dev)
    reset_k1()  # this main path starts here
    tr.train()
    counts, routes = read_k1()
    sites = unet_step_sites(UNET_B, 128, 128)
    per = sum(c for *_, c in sites)
    want = {"fwd": add_routes(planned(sites, "fwd", DEFAULT_TRAIN),
                              planned(unet_sites(E2E_TEST, 128, 128), "fwd",
                                      FWD_GRAPH_CALLS)),
            "bwd": planned(sites, "bwd", DEFAULT_TRAIN)}
    print(f"  one default epoch in-process: K1 forward {counts['fwd']}, "
          f"backward {counts['bwd']} ({DEFAULT_TRAIN} steps x {per} each, "
          f"plus the capture of the eval's forward of {E2E_TEST} images, 15 "
          f"x {FWD_GRAPH_CALLS} forward); by route {routes}, planned {want}")
    need(counts == {"fwd": DEFAULT_TRAIN * per + 15 * FWD_GRAPH_CALLS,
                    "bwd": DEFAULT_TRAIN * per} and routes == want,
         "the default trainer's K1 calls left their count or routes")
    del tr
    torch.cuda.empty_cache()

    out, _ = p2p_run.result(timeout=600)
    print(*p2p_log, sep="\n")
    need_captured(out, 0)
    losses = [(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"Gen_Loss: (\S+) Disc_Loss: (\S+)", out)]
    need(len(losses) == len(chunk_prints(DEFAULT_P2P_TRAIN, 8, 1))
         and all(math.isfinite(v) for p in losses for v in p),
         f"pix2pix losses not finite, or not printed at the chunks: "
         f"{losses}")
    pck = os.path.join(p2p_dir, "checkpoint", "city")
    gen_cp = torch.load(os.path.join(pck, "gen", "cp-0000.pt"),
                        weights_only=True)
    disc_cp = torch.load(os.path.join(pck, "disc", "cp-0000.pt"),
                         weights_only=True)
    moved = gen_cp["bn"].get("up0_bn", {}).get("moving_mean")
    print(f"  pix2pix epoch: losses {losses[-1]}; checkpoint BN state: "
          f"generator {len(gen_cp['bn'])} norms, discriminator "
          f"{len(disc_cp['bn'])}")
    # at 128x128: 7 down blocks (BN on 6), 6 up blocks (BN on each)
    need(set(gen_cp["bn"]) == {*(f"down{i}_bn" for i in range(1, 7)),
                               *(f"up{i}_bn" for i in range(6))}
         and set(disc_cp["bn"]) == {"down1_bn", "down2_bn", "conv_bn"}
         and moved is not None and bool(moved.abs().max() > 0),
         "the pix2pix checkpoint carries no moved BN state")
    return {"sustained_img_per_s": sustained, "epoch_img_per_s": rates,
            "wall_img_per_s": wall_rate, "k1_per_step": per,
            "trainer_launches": counts, "trainer_routes": routes}


def unet_serve_phase(card: str, dev) -> dict:
    """Phase 21.  /translate with the U-Net at 128x128 (15 x 2 K1 calls
    at the start-up's capture, a request a replay of its kernels), then
    the U-Net's bf16 forward ms at b=1 and b=16, 128x128 and 256x512."""
    from PIL import Image

    from sggan_tpu_torch import serve as srv
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.train import evaluate
    cfg = Config(ngf=NGF, compute_dtype="bfloat16")
    before = cuda_in.launches
    httpd = srv.serve(cfg, port=0, block=False, device="cuda")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    lat = []
    try:
        need(cuda_in.launches - before == 15 * FWD_GRAPH_CALLS,
             "the U-Net service's start-up did not capture its forward")
        port = httpd.server_address[1]
        rng = np.random.default_rng(21)
        for ih, iw in ((128, 128), (512, 1024), (128, 128), (128, 128)):
            before = cuda_in.launches
            t0 = time.perf_counter()
            status, data = post(port, png(rng.integers(0, 256, (ih, iw, 3),
                                                       np.uint8)))
            lat.append((time.perf_counter() - t0) * 1e3)
            out = np.asarray(Image.open(io.BytesIO(data)))
            calls = cuda_in.launches - before
            print(f"  POST {ih}x{iw} to the U-Net: {status}, {out.shape}, "
                  f"{lat[-1]:.1f} ms, +{calls} K1 calls (a replay)")
            need(status == 200 and out.shape == (128, 128, 3)
                 and out.std() > 0 and calls == 0, "bad U-Net translation")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    gen = evaluate.build_generator(cfg).to(dev)
    fwd = {}
    with torch.inference_mode():
        for h, w in UNET_HW:
            for n, iters in ((1, 20), (16, 5)):
                x = torch.rand(n, h, w, 3, device=dev)
                fwd[f"{h}x{w}_b{n}"] = ms = cuda_ms(
                    lambda: gen(x, {}, torch.bfloat16), iters)
                print(f"  [{card}] U-Net forward bf16 {h}x{w} b={n}: "
                      f"{ms:.3f} ms ({ms / n:.3f} ms/image)")
                del x
    del gen
    torch.cuda.empty_cache()
    return {"translate_ms": lat, "forward_ms": fwd}


# ----------------------------------------------------------------------
# The cycle-consistency mode, --loss_mode cycle (phases 22-25)
# ----------------------------------------------------------------------

CYCLE_B = 8                     # bench.py:221-256's cycle cell
CYCLE_SWEEP = (2, 4, 8, 12, 16)  # phase 23's sites
# phase 24's step sweep
CYCLE_SWEEP_STEP = (8, 12, 16)
CYCLE_STEPS = 12
CYCLE_K1_PER_STEP = 166  # 6 x 23 generator + 2 x 7 (gen loss) + 2 x 7
# phase 25: 48 + 48 triplets of phase 16's PNGs, b=4 doubled to 8
CYCLE_CLI_TRAIN, CYCLE_CLI_B, CYCLE_CLI_EPOCHS = 48, 4, 3


def cycle_cfg(b: int):
    """bench.py:221-256's cycle cell: ResNet, 256x512, ngf and ndf 64, 34
    classes, pool 50, bf16, identity and gradient loss on (5 and 5), L1
    10."""
    from sggan_tpu_torch.config import Config
    return Config(image_height=H, image_width=W, ngf=NGF, ndf=64,
                  segment_class=N_CLASS, batch_size=b, max_size=50,
                  compute_dtype="bfloat16", loss_mode="cycle",
                  use_resnet=True, identity_lambda=5.0, Lg_lambda=5.0)


def cycle_step_sites(b: int) -> list:
    """(N, (H, W, C), act, calls per step) of every instance norm of one
    ResNet cycle step at batch ``b`` with the identity term: the
    generators' 23 in each of 6 calls, the discriminators' 7 in each of
    the generator loss's 2 calls (batch b) and of the 2 calls over [real;
    pooled fake] (batch 2b)."""
    return ([(n, hwc, act, 6 * c) for n, hwc, act, c in gen_sites(b)]
            + [(b, hwc, act, 2) for hwc, act in D_SITES]
            + [(2 * b, hwc, act, 2) for hwc, act in D_SITES])


def cycle_signs(st, batch, masks, cd) -> list:
    """Every value whose sign the cycle step's gradient follows, on the
    CPU: the generators' gates (the pre-activations of their instance
    norms' relus, the U-Net's leaky gates and its two relus) in the six
    calls of the step, the discriminators' gates in the generator loss's
    two calls, the four L1s' differences and the gradient losses' Sobel
    derivatives and |d fake| - |d real| (losses.gradloss_criterion).
    Read by wrapping the modules' own ops."""
    import sggan_tpu_torch.models.discriminator as dm
    import sggan_tpu_torch.models.generator_resnet as gr
    import sggan_tpu_torch.models.generator_unet as gu
    from sggan_tpu_torch.ops.deriv import sobel_xy
    vals = []
    saved = [(m, k, getattr(m, k)) for m, k in (
        (gr, "instance_norm"), (gu, "instance_norm"), (gu, "relu"),
        (dm, "instance_norm"), (dm, "leaky_relu"))]

    def rec(k, real):
        if k == "instance_norm":
            def f(p, v, act=None, **kw):
                if act is not None:
                    vals.append(real(p, v).float().cpu())
                return real(p, v, act=act, **kw)
            return f

        def g(v, *a, **kw):
            vals.append(v.float().cpu())
            return real(v, *a, **kw)
        return g
    for m, k, real in saved:
        setattr(m, k, rec(k, real))
    try:
        with torch.no_grad():
            ms = masks or (None,) * 4

            def gen(k, x, i):
                return st.gen_params[k](x, {}, cd, ms[i],
                                        train=masks is not None)[0]
            ra, rb = batch["real_a"].float(), batch["real_b"].float()
            fb, fa = gen("a2b", ra, 0), gen("b2a", rb, 1)
            cyc_a, cyc_b = gen("b2a", fb, 2), gen("a2b", fa, 3)
            idt_b, idt_a = gen("a2b", rb, 2), gen("b2a", ra, 3)
            st.disc_params["db"](fb, batch["mask_a"], cd)
            st.disc_params["da"](fa, batch["mask_b"], cd)
            vals += [(ra - cyc_a).cpu(), (rb - cyc_b).cpu(),
                     (idt_b - rb).cpu(), (idt_a - ra).cpu()]
            for f, r in ((fb, ra), (fa, rb)):
                (dxi, dyi), (dxt, dyt) = sobel_xy(f), sobel_xy(r)
                vals += [t.cpu() for t in (dxi, dyi, dxi.abs() - dxt.abs(),
                                           dyi.abs() - dyt.abs())]
    finally:
        for m, k, real in saved:
            setattr(m, k, real)
    return vals


def cycle_card_vs_cpu_phase(card: str, dev) -> dict:
    """Phase 22.  One f32 cycle step, card (kernels, TF32 off) against CPU
    (plain versions), from one seeded state, two-domain batch, pool draws
    and, for the U-Net, its four dropout mask sets: the ResNet and the
    U-Net at 32x64 b=2, ngf and ndf 4, 8 classes, pool 2.  Phase 8's
    limits, or, where a sign the gradient follows (``cycle_signs``) falls
    on opposite sides, the full-width ones, as phase 19 holds the U-Net."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import step as tstep
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for net, resnet in (("ResNet", True), ("U-Net", False)):
            cfg = Config(image_height=32, image_width=64, ngf=4, ndf=4,
                         segment_class=8, batch_size=2, max_size=2,
                         compute_dtype="float32", loss_mode="cycle",
                         use_resnet=resnet)
            print(f"  {net} cycle step, identity and gradient loss on:")
            loss_err, rows, _, dead_live = step_card_vs_cpu(cfg, 2)
            # the same state, batch and masks as step_grads draws them
            batch = cycle_batch(cfg, 2, "cpu", seed=3)
            signs = {}
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                for d in ("cpu", dev):
                    st = tstep.init_state(cfg, torch.Generator()
                                          .manual_seed(0), d)
                    masks = tstep.dropout_masks(
                        cfg, st.gen_params, torch.Generator().manual_seed(7),
                        2)
                    signs[str(d)] = cycle_signs(st, to_dev(batch, d),
                                                to_dev(masks, d),
                                                torch.float32)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            flips = sum(int(((a >= 0) != (c >= 0)).sum())
                        for a, c in zip(signs["cpu"], signs["cuda"]))
            lim = ((1e-3, float("inf")) if not flips
                   else (STEP_MAX_REL, STEP_NORM_REL))
            worst = (max(r[0] for r in rows), max(r[1] for r in rows))
            print(f"    signs on opposite sides, card vs CPU: {flips} of "
                  f"{sum(v.numel() for v in signs['cpu'])}; held at max "
                  f"|diff| / max |g| <= {lim[0]}"
                  + (f", |diff| / |g| <= {lim[1]}" if flips else ""))
            need(loss_err <= 1e-4 and not dead_live and worst[0] <= lim[0]
                 and worst[1] <= lim[1],
                 f"the card's {net} cycle step disagrees with the CPU's")
            out[net] = {"loss_max_rel": loss_err, "grad_max_rel": worst[0],
                        "grad_norm_rel": worst[1], "sign_flips": flips}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.cuda.empty_cache()
    return out


def cycle_k1_sites() -> tuple:
    """(N, (H, W, C), act), once each, of every instance norm on the cycle
    paths that phases 22-25 drive, less those phases 7 and 18 hold; and
    the count before the difference.  The paths: the ResNet cycle step at
    every b of CYCLE_SWEEP (phase 24) and at the CLI's b=8 (phase 25),
    the eval's forward of E2E_TEST images at 256x512, and the U-Net cycle
    step at 128x128 b=2, whose sites are the p2p step's."""
    held = set(step_k1_sites()) | set(unet_k1_sites())
    sites = [s for b in CYCLE_SWEEP for s in cycle_step_sites(b)]
    sites += gen_sites(E2E_TEST) + unet_step_sites(UNET_B, 128, 128)
    every = list(dict.fromkeys((n, hwc, act) for n, hwc, act, _ in sites))
    return [s for s in every if s not in held], len(every)


def cycle_k1_phase(card: str, dev, errs: dict, bwd_errs: dict) -> tuple:
    """Phase 23.  Both K1 kernels against their plain twins at every new
    site of ``cycle_k1_sites``, f32 and bf16, each call on the route its
    plan names (phase 7's limits); then both kernels timed at every site
    of one b=8 cycle step (``time_sites``)."""
    from sggan_tpu_torch.ops import cuda_in
    sites, every = cycle_k1_sites()
    for dtype in (torch.float32, torch.bfloat16):
        for i, (n, (h, w, c), act) in enumerate(sites):
            p = {d: cuda_in.plan(n, h, w, c, dtype, d)
                 for d in ("fwd", "bwd")}
            reset_k1()
            f_err, b_err = k1_vs_plain(n, (h, w, c), act, dtype, dev,
                                       seed=300 + i)
            _, routes = read_k1()
            need(routes == {d: {p[d].route: 2} for d in ("fwd", "bwd")},
                 f"K1 calls left their planned route: {routes}, plan {p}")
            errs[dtype] = max(errs[dtype], f_err)
            bwd_errs[dtype] = max(bwd_errs[dtype], b_err)
        torch.cuda.empty_cache()
    print(f"  K1 held to its plain twins on its planned routes at the "
          f"{len(sites)} sites of the {every} on the cycle paths that "
          "phases 7 and 18 do not hold, x 2 dtypes")
    return time_sites(card, dev, cycle_step_sites(CYCLE_B),
                      f"the {CYCLE_K1_PER_STEP} calls of one b={CYCLE_B} "
                      "cycle step")


def cycle_step_cell(card: str, dev, b: int, n_steps: int,
                    breakdown: bool) -> dict:
    """The bf16 ResNet cycle step of ``cycle_cfg(b)``: ``n_steps`` steps
    from counts of 0 with K1's exact calls per step by route and finite
    losses; then pairs/s by CUDA events, peak memory and the device's
    busy time over 2 profiled steps with the idle share, printed by
    category with ``breakdown``.  Raises torch.cuda.OutOfMemoryError if
    it does not fit."""
    from torch.profiler import ProfilerActivity, profile

    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    cfg = cycle_cfg(b)
    holder = [tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)]
    batch = cycle_batch(cfg, b, dev, seed=5)
    step_fn = tstep.build_step_fn(cfg)
    draw_gen = torch.Generator().manual_seed(6)

    def one():
        holder[0], m = step_fn(holder[0], batch, 1e-3, tpool.pool_draws(
            draw_gen, b, cfg.max_size))
        return torch.stack([m["gen_loss"], m["disc_loss"]])
    torch.cuda.reset_peak_memory_stats()
    reset_k1()  # this cell's main path starts here
    losses = torch.stack([one() for _ in range(n_steps)]).cpu()
    counts, routes = read_k1()
    sites = cycle_step_sites(b)
    per = sum(c for *_, c in sites)
    want = {d: planned(sites, d, n_steps) for d in ("fwd", "bwd")}
    print(f"  [{card}] cycle step bf16 256x512 b={b}: {n_steps} steps, K1 "
          f"forward {counts['fwd']}, backward {counts['bwd']} ({per} each "
          f"a step expected); by route {routes}, planned {want}; gen_loss "
          f"{[round(v, 4) for v in losses[:, 0].tolist()]}, disc_loss "
          f"{[round(v, 4) for v in losses[:, 1].tolist()]}")
    need(per == CYCLE_K1_PER_STEP
         and counts == {"fwd": per * n_steps, "bwd": per * n_steps}
         and routes == want, "the cycle step's K1 calls left their count "
                             "or their planned routes")
    need(bool(torch.isfinite(losses).all()) and holder[0].step == n_steps,
         "the cycle step's losses are not finite")
    ms = cuda_ms(one, 8, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            one()
        torch.cuda.synchronize()
    busy = sum(k[0] for k in kernel_times(prof, 2))
    print(f"  [{card}] cycle step bf16 256x512 b={b}: {ms:.3f} ms, "
          f"{1e3 * b / ms:.2f} pairs/s, peak memory {peak:.2f} GiB, device "
          f"busy {busy:.3f} ms ({100 * (1 - busy / ms):.1f}% idle)")
    if breakdown:
        print_breakdown(prof, 2, ms, f"[{card}] profiler, cycle step bf16 "
                        f"256x512 b={b}", STEP_CATEGORIES)
    return {"batch": b, "step_ms": ms, "pairs_per_s": 1e3 * b / ms,
            "peak_gib": peak, "busy_ms": busy, "idle_share": 1 - busy / ms,
            "k1_per_step": {d: counts[d] // n_steps for d in counts},
            "k1_routes_per_step": {d: {r: k // n_steps
                                       for r, k in v.items()}
                                   for d, v in routes.items()}}


def cycle_step_phase(card: str, dev) -> dict:
    """Phase 24.  The cycle step cell (main path) at b=8, 12 steps, with
    its profile; then the batch sweep over CYCLE_SWEEP_STEP, where a batch
    that runs out of memory is printed as not fitting (b=8 must run)."""
    keep = ("step_ms", "pairs_per_s", "peak_gib", "busy_ms", "idle_share")
    cell = cycle_step_cell(card, dev, CYCLE_B, CYCLE_STEPS, breakdown=True)
    torch.cuda.empty_cache()
    sweep = {CYCLE_B: {k: cell[k] for k in keep}}
    for b in CYCLE_SWEEP_STEP:
        if b == CYCLE_B:
            continue
        try:
            r = cycle_step_cell(card, dev, b, 2, breakdown=False)
            sweep[b] = {k: r[k] for k in keep}
        except torch.cuda.OutOfMemoryError:
            print(f"  [{card}] cycle step bf16 256x512 b={b}: does not fit "
                  "in the card's memory")
            sweep[b] = "does not fit"
        finally:
            torch.cuda.empty_cache()
    fits = {b: v for b, v in sweep.items() if isinstance(v, dict)}
    base = fits[CYCLE_B]["pairs_per_s"]
    big = {b: v["pairs_per_s"] for b, v in fits.items() if b >= 12}
    falls = any(v < base for v in big.values())
    print(f"  [{card}] sweep, pairs/s by b: "
          + ", ".join(f"{b}: {v['pairs_per_s']:.2f} ({v['peak_gib']:.1f} "
                      f"GiB, {100 * v['idle_share']:.0f}% idle)"
                      if isinstance(v, dict) else f"{b}: {v}"
                      for b, v in sorted(sweep.items()))
          + f"; at b >= 12 pairs/s {'falls below' if falls else 'holds at or above'}"
          f" b={CYCLE_B}'s" + ("" if big else " (no b >= 12 fits)"))
    return {"cell": cell, "sweep": {str(b): v for b, v in sweep.items()},
            "falls_at_b_ge_12": falls if big else None}


def cycle_cli_args(root: str) -> list:
    """Phase 25's flags: phase 16's at b=4 and ``--loss_mode cycle``."""
    args = list(E2E_ARGS)
    args[args.index("--batch_size") + 1] = str(CYCLE_CLI_B)
    args[args.index("--loss_mode") + 1] = "cycle"
    return args + ["--dataset_dir", root, "--train_size",
                   str(CYCLE_CLI_TRAIN)]


def cycle_cli_phase(card: str, dev, work: str, root: str) -> dict:
    """Phase 25.  ``python -m sggan_tpu_torch.main --loss_mode cycle
    --use_resnet`` on phase 16's PNG set with a trainB split of
    CYCLE_CLI_TRAIN triplets beside trainA (another seed), ``--train_size``
    48, phase 16's fused-aug flags at b=4 doubled to 8: train 3 epochs
    (both splits resident, finite losses, checkpoint of both generators,
    test PNGs, tfevents; sustained pairs/s), ``--phase test`` AtoB and
    BtoA (different PNGs), ``--continue_train`` 1 epoch (resumes at the
    saved step); then one in-process epoch with K1's exact calls."""
    from sggan_tpu_torch.config import parse_args
    from sggan_tpu_torch.train.trainer import Trainer
    from sggan_tpu_torch.utils.summary import read_scalars
    t_build = build_dataset(root, 0, splits=(("trainB", CYCLE_CLI_TRAIN),),
                            seed=1)
    print(f"  trainB: {CYCLE_CLI_TRAIN} triplets of {SRC_H}x{SRC_W} PNGs "
          f"from seed 1 in {t_build:.1f} s")
    steps = CYCLE_CLI_TRAIN // CYCLE_CLI_B
    b_eff = 2 * CYCLE_CLI_B
    args = cycle_cli_args(root)
    run_dir = os.path.join(work, "cycle_cli")
    os.makedirs(run_dir)
    ck = os.path.join(run_dir, "checkpoint", "city")

    def saved_step(epoch: int) -> int:
        return torch.load(os.path.join(ck, "train", f"cp-{epoch:04d}.pt"),
                          weights_only=True)["step"]

    out, _ = run_cli(run_dir, f"--loss_mode cycle, train "
                     f"{CYCLE_CLI_EPOCHS} epochs",
                     ["--phase", "train", "--epoch", str(CYCLE_CLI_EPOCHS),
                      *args])
    need(f" [*] training splits resident on device" in out
         and f"{CYCLE_CLI_TRAIN}+{CYCLE_CLI_TRAIN} triplets" in out,
         "the cycle run did not take both splits resident")
    need_captured(out, CYCLE_K1_PER_STEP)
    losses = [(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"Gen_Loss: (\S+) Disc_Loss: (\S+)", out)]
    need(len(losses) == CYCLE_CLI_EPOCHS
         and all(math.isfinite(v) for p in losses for v in p),
         f"losses not finite at every print: {losses}")
    m = re.search(r"Training finished: step (\d+), (\d+) images in "
                  r"([\d.]+) s", out)
    need(m and int(m.group(1)) == CYCLE_CLI_EPOCHS * steps,
         "the cycle run did not finish its steps")
    wall_rate = int(m.group(2)) / float(m.group(3))
    last = CYCLE_CLI_EPOCHS - 1
    gen_cp = torch.load(os.path.join(ck, "gen", f"cp-{last:04d}.pt"),
                        weights_only=True)
    need({"a2b.c1.w", "b2a.c1.w"} <= set(gen_cp["params"])
         and saved_step(last) == CYCLE_CLI_EPOCHS * steps,
         "the cycle checkpoint lacks a generator or holds another step")
    test_dir = os.path.join(run_dir, "test")
    need(all(os.path.isfile(os.path.join(test_dir, f"s{i:04d}.png"))
             for i in range(E2E_TEST)), "the eval wrote no test PNGs")
    events = glob.glob(os.path.join(run_dir, "logs", "*", "train",
                                    "events.out.tfevents.*"))
    need(len(events) == 1, "no tfevents file")
    rates = [v for _, v in read_scalars(events[0])["Images/sec"]]
    need(len(rates) == CYCLE_CLI_EPOCHS, "no Images/sec per epoch")
    sustained = float(np.mean(rates[1:]))
    print(f"  [{card}] cycle CLI, {CYCLE_CLI_TRAIN} + {CYCLE_CLI_TRAIN} "
          f"triplets, b={CYCLE_CLI_B} doubled to {b_eff} pairs a step, "
          f"{steps} steps an epoch: epoch pairs/s "
          f"{[round(r, 2) for r in rates]} (StepTimer), sustained (epochs "
          f">= 1) {sustained:.2f} pairs/s, whole run {wall_rate:.2f} pairs/s")

    def test(direction_dir):
        direction, tdir = direction_dir
        return run_cli(run_dir, f"test {direction}",
                       ["--phase", "test", "--which_direction", direction,
                        "--test_dir", tdir, *args])

    def resume():
        return run_cli(run_dir, "resume for 1 epoch",
                       ["--phase", "train", "--continue_train", "--epoch",
                        "1", *args])

    pngs = {}
    dirs = (("AtoB", "test"), ("BtoA", "test_btoa"))
    # side by side: both tests read the checkpoints; the resume (untimed)
    # writes the next, which either may load
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        resumed_run = pool.submit(resume)
        tested = list(pool.map(test, dirs))
        res, _ = resumed_run.result()
    for (direction, tdir), (out, _) in zip(dirs, tested):
        d = os.path.join(run_dir, tdir)
        need(" [*] Load SUCCESS" in out
             and all(os.path.isfile(os.path.join(d, f"real_s{i:04d}.png"))
                     for i in range(E2E_TEST)),
             f"--phase test {direction} did not load or wrote no PNGs")
        pngs[direction] = [open(os.path.join(d, f"s{i:04d}.png"), "rb")
                           .read() for i in range(E2E_TEST)]
    need(all(a != b for a, b in zip(pngs["AtoB"], pngs["BtoA"])),
         "BtoA wrote the same PNGs as AtoB")
    resumed = saved_step(CYCLE_CLI_EPOCHS)
    need(" [*] Load SUCCESS" in res
         and resumed == (CYCLE_CLI_EPOCHS + 1) * steps,
         "--continue_train did not resume at the saved step")

    # one epoch in-process, eager (--scan_steps 1): K1's calls a step and
    # by route
    own = os.path.join(work, "cycle_inproc")
    cfg = parse_args(["--phase", "train", "--epoch", "1", *args,
                      "--scan_steps", "1",
                      *(x for d in ("checkpoint", "test", "sample", "log")
                        for x in (f"--{d}_dir", os.path.join(own, d)))])
    tr = Trainer(cfg, device=dev)
    reset_k1()  # this main path starts here
    tr.train()
    counts, routes = read_k1()
    sites = cycle_step_sites(b_eff)
    want = {"fwd": add_routes(planned(sites, "fwd", steps),
                              planned(gen_sites(E2E_TEST), "fwd",
                                      FWD_GRAPH_CALLS)),
            "bwd": planned(sites, "bwd", steps)}
    print(f"  one cycle epoch in-process: K1 forward {counts['fwd']}, "
          f"backward {counts['bwd']} ({steps} steps x {CYCLE_K1_PER_STEP} "
          f"each, plus the capture of the eval's a2b forward of {E2E_TEST} "
          f"images, 23 x {FWD_GRAPH_CALLS} forward); by route {routes}, "
          f"planned {want}")
    need(counts == {"fwd": steps * CYCLE_K1_PER_STEP + 23 * FWD_GRAPH_CALLS,
                    "bwd": steps * CYCLE_K1_PER_STEP} and routes == want,
         "the cycle trainer's K1 calls left their count or routes")
    del tr
    torch.cuda.empty_cache()
    return {"sustained_pairs_per_s": sustained, "epoch_pairs_per_s": rates,
            "wall_pairs_per_s": wall_rate, "trainer_launches": counts,
            "trainer_routes": routes}


# ----------------------------------------------------------------------
# The deployment path: the exported artifact and the TF import (26-28)
# ----------------------------------------------------------------------

K1_OP = "sggan_tpu_torch.instance_norm.default"
# the plain instance norm's moments are reductions over H x W; nothing
# else of an inference forward reduces (batch norm reads moving stats)
PLAIN_REDUCTIONS = ("aten.sum", "aten.mean", "aten.var")
ART_ITERS, ART_WARMUP = 32, 3   # bench.py:147-175's inference cell
UNET_HW_SERVED = (128, 128)
# a fresh process that imports only utils.export: loads each artifact,
# runs one forward with K1's counts reset just before and read just after,
# saves the output; prints the counts and any model, trainer or JAX module
# it imported
FRESH_LOAD = r"""
import json, sys
import numpy as np, torch
from sggan_tpu_torch.ops import cuda_in
from sggan_tpu_torch.utils import export
out = {}
for label, path, x_path, y_path, f32 in json.loads(sys.argv[1]):
    torch.backends.cudnn.allow_tf32 = not f32
    torch.backends.cuda.matmul.allow_tf32 = not f32
    art = export.load(path, "cuda")
    x = torch.from_numpy(np.load(x_path)).cuda()
    torch.cuda.synchronize()
    cuda_in.launches = 0
    cuda_in.route_launches.update(dict.fromkeys(cuda_in.route_launches, 0))
    y = art(x)
    torch.cuda.synchronize()
    first = cuda_in.launches
    again = art(x)  # a replay of the graph the first call captured
    torch.cuda.synchronize()
    np.save(y_path, y.cpu().numpy())
    out[label] = {"k1": first, "k1_replay": cuda_in.launches - first,
                  "replay_max_abs": float((y - again).abs().max()),
                  "routes": {r: n for (d, r), n in
                             cuda_in.route_launches.items()
                             if d == "fwd" and n}}
    with torch.inference_mode():  # the program node by node, twice
        m1, m2 = art._module(x), art._module(x)
    out[label]["module_repeat_max_abs"] = float((m1 - m2).abs().max())
bad = sorted(m for m in sys.modules if m in ("jax", "sggan_tpu")
             or m.startswith(("jax.", "sggan_tpu.", "sggan_tpu_torch.models",
                              "sggan_tpu_torch.train")))
print(json.dumps({"counts": out, "imported": bad}))
"""


def artifact_cases(work: str, root: str) -> dict:
    """label -> (run dir, flags, K1 sites of a b=1 forward, compute dtype,
    image size) of every artifact phase 26 exports: phase 16's ResNet
    checkpoint (bf16, and again in f32), phase 20's U-Net and pix2pix
    ones, phase 25's cycle one in both directions."""
    e2e = E2E_ARGS + ["--dataset_dir", root]
    f32 = list(e2e)
    f32[f32.index("--compute_dtype") + 1] = "float32"
    cyc = cycle_cli_args(root)
    bf16, hw = torch.bfloat16, UNET_HW_SERVED
    cases = {
        "resnet": ("cli", e2e, gen_sites(1), bf16, (H, W)),
        "resnet_f32": ("cli", f32, gen_sites(1), torch.float32, (H, W)),
        "unet": ("default_cli", ["--dataset_dir", root],
                 unet_sites(1, *hw), bf16, hw),
        "pix2pix": ("pix2pix_cli", ["--use_pix2pix", "--dataset_dir", root],
                    [], bf16, hw),
        "cycle_AtoB": ("cycle_cli", cyc + ["--which_direction", "AtoB"],
                       gen_sites(1), bf16, (H, W)),
        "cycle_BtoA": ("cycle_cli", cyc + ["--which_direction", "BtoA"],
                       gen_sites(1), bf16, (H, W)),
    }
    out = {}
    for label, (d, flags, sites, dtype, size) in cases.items():
        run_dir = os.path.join(work, d)
        out[label] = (run_dir, flags + ["--checkpoint_dir", os.path.join(
            run_dir, "checkpoint")], sites, dtype, size)
    return out


def u8(y: np.ndarray) -> np.ndarray:
    """The service's PNG levels of a [-1, 1] output."""
    return ((y + 1.0) / 2.0 * 255).astype(np.uint8).astype(int)


def artifact_phase(card: str, dev, work: str, root: str,
                   after_exports) -> dict:
    """Phase 26.  ``python -m sggan_tpu_torch.serve --export`` on the
    checkpoints of phases 16, 20 and 25 (all at once, one process each),
    each printing checkpoint_loaded=True; every graph holds one K1 op node
    per instance norm (23, 15, 0) and no plain reduction; a fresh process
    that imports only ``utils.export`` runs each artifact once with K1's
    exact calls on the planned routes; each output against the checkpoint
    service's (``Trainer.generate``): f32 within phase 4's limit with
    TF32 off, bf16 within one PNG level, AtoB and BtoA apart; then the
    service with ``--artifact``: /healthz, four PNGs within one level of
    the checkpoint service's, 23 K1 calls a request, a garbage body 400.
    ``after_exports()`` is called once the exports have ended."""
    from PIL import Image

    from sggan_tpu_torch import serve as srv
    from sggan_tpu_torch.config import parse_args
    from sggan_tpu_torch.utils import export as gexport

    cases = artifact_cases(work, root)
    art_dir = os.path.join(work, "artifacts")
    os.makedirs(art_dir)
    paths = {k: os.path.join(art_dir, f"{k}.pt2") for k in cases}

    def export(label):
        run_dir, flags, *_ = cases[label]
        return run_cli(run_dir, f"--export {label}", ["--export",
                       "--artifact", paths[label], *flags],
                       module="sggan_tpu_torch.serve")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cases)) as pool:  # one process each
        exported = dict(zip(cases, pool.map(export, cases)))
    print(f"  {len(cases)} exports side by side in "
          f"{time.perf_counter() - t0:.1f} s")
    after_exports()
    res = {"export_s": {}, "graph": {}}
    for label, (out, secs) in exported.items():
        need(f"exported {paths[label]} (checkpoint_loaded=True)" in out,
             f"--export {label} did not load its checkpoint")
        ops = gexport.graph_ops(gexport.load(paths[label]).program)
        k1_nodes = ops.get(K1_OP, 0)
        plain = {k: n for k, n in ops.items()
                 if k.startswith(PLAIN_REDUCTIONS)}
        want = sum(c for *_, c in cases[label][2])
        print(f"  {label}: {os.path.getsize(paths[label]) / 2**20:.1f} MiB, "
              f"{sum(ops.values())} graph nodes, {k1_nodes} K1 op nodes "
              f"(want {want}), plain reductions {plain}")
        need(k1_nodes == want and not plain,
             f"the {label} graph does not hold one K1 op per instance norm")
        res["export_s"][label] = secs
        res["graph"][label] = {"nodes": sum(ops.values()),
                               "k1_op_nodes": k1_nodes}

    # a fresh process runs each artifact once: K1's calls and routes
    rng = np.random.default_rng(26)
    xs, jobs = {}, []
    for label, (_, _, _, dtype, (h, w)) in cases.items():
        xs[label] = rng.random((1, h, w, 3), np.float32)
        x_path = os.path.join(art_dir, f"{label}_x.npy")
        np.save(x_path, xs[label])
        jobs.append([label, paths[label], x_path,
                     os.path.join(art_dir, f"{label}_y.npy"),
                     dtype == torch.float32])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_LOAD,
                           json.dumps(jobs)], cwd=REPO, env=repo_env(),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError("the fresh process did not run the artifacts")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"  fresh process, {len(jobs)} artifacts in "
          f"{time.perf_counter() - t0:.1f} s: imported {fresh['imported']}")
    need(not fresh["imported"], "loading an artifact imported the model's "
         "Python or JAX")
    res["fresh_k1"] = fresh["counts"]
    for label, (_, _, sites, dtype, _) in cases.items():
        got = fresh["counts"][label]
        want = planned(sites, "fwd", FWD_GRAPH_CALLS, dtype=dtype)
        print(f"  {label}: the first b=1 call (the graph's warm-up and "
              f"capture), K1 {got['k1']} calls by route {got['routes']}, "
              f"planned {want}; a second call (a replay) {got['k1_replay']} "
              f"K1 calls, max abs {got['replay_max_abs']:.3g} from the "
              f"first; the GraphModule run twice node by node: max abs "
              f"{got['module_repeat_max_abs']:.3g}")
        # a replay repeats the first call bitwise where the program's own
        # kernels do (cuDNN may pick an algorithm that sums with atomics),
        # else within the limit the artifact is held to below: f32 phase
        # 4's, bf16 a PNG level (2 / 255 of [-1, 1])
        need(got["k1"] == sum(want.values()) and got["routes"] == want
             and got["k1_replay"] == 0
             and (got["replay_max_abs"] == 0
                  or got["module_repeat_max_abs"] > 0)
             and got["replay_max_abs"] <= (
                 SLICE_ATOL if dtype == torch.float32 else 2 / 255),
             f"the {label} artifact's K1 calls left their count or routes, "
             "or its replay differs where the program repeats itself")

    # each artifact against the checkpoint service on the same input
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    ys, res["vs_eager"] = {}, {}
    for label, (_, flags, _, dtype, _) in cases.items():
        f32 = dtype == torch.float32
        torch.backends.cudnn.allow_tf32 = not f32
        torch.backends.cuda.matmul.allow_tf32 = not f32
        svc = srv._Service(parse_args(flags), device=dev)
        need(svc.loaded, f"the {label} checkpoint service found no "
             "checkpoint")
        ref = svc._fn(xs[label])
        ys[label] = y = np.load(os.path.join(art_dir, f"{label}_y.npy"))
        need(y.shape == ref.shape and np.isfinite(y).all(),
             f"{label}: artifact output {y.shape}")
        err = float(np.abs(y - ref).max())
        levels = int(np.abs(u8(y[0]) - u8(ref[0])).max())
        res["vs_eager"][label] = {"max_abs": err, "max_levels": levels}
        limit = (f"atol {SLICE_ATOL}, TF32 off" if f32 else
                 "one PNG level")
        print(f"  {label} artifact vs Trainer.generate: max abs "
              f"{err:.3g}, {levels} PNG levels ({limit})")
        need(err <= SLICE_ATOL if f32 else levels <= 1,
             f"the {label} artifact disagrees with the checkpoint service")
        del svc
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    apart = float(np.abs(ys["cycle_AtoB"] - ys["cycle_BtoA"]).max())
    print(f"  cycle AtoB vs BtoA artifacts: max abs {apart:.3f}")
    need(apart > 0.05, "the AtoB and BtoA artifacts serve the same images")

    # the service on the artifact (main path), against the checkpoint
    # service's PNGs of the same bodies, made first
    cfg = parse_args(cases["resnet"][1])
    ck_svc = srv._Service(cfg, device=dev)
    bodies = [png(rng.integers(0, 256, (ih, iw, 3), np.uint8))
              for ih, iw in ((H, W), (1024, 2048), (H, W), (H, W))]
    refs = [np.asarray(Image.open(io.BytesIO(ck_svc.translate_png(body))))
            .astype(int) for body in bodies]
    del ck_svc
    reset_k1()  # the main path's count starts here
    httpd = srv.serve(cfg, port=0, block=False, device="cuda",
                      artifact=paths["resnet"])
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    lat, levels = [], []
    try:
        port = httpd.server_address[1]
        need(read_k1()[0]["fwd"] == 23 * FWD_GRAPH_CALLS, "the artifact "
             "service's warm-up did not capture K1's 23 calls")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        print(f"  healthz {health}")
        need(health["artifact"] is True and health["checkpoint_loaded"]
             is True and health["backend"] == "cuda",
             "/healthz does not report the loaded artifact")
        for body, ref in zip(bodies, refs):
            before = read_k1()[0]["fwd"]
            t0 = time.perf_counter()
            status, data = post(port, body)
            lat.append((time.perf_counter() - t0) * 1e3)
            calls = read_k1()[0]["fwd"] - before
            out = np.asarray(Image.open(io.BytesIO(data))).astype(int)
            levels.append(int(np.abs(out - ref).max()))
            ih, iw = Image.open(io.BytesIO(body)).size[::-1]
            print(f"  POST {ih}x{iw} to the artifact: {status}, {out.shape},"
                  f" {lat[-1]:.1f} ms, +{calls} K1 calls (a replay), "
                  f"{levels[-1]} levels from the checkpoint service's PNG")
            need(status == 200 and out.shape == (H, W, 3) and calls == 0
                 and levels[-1] <= 1, "bad translation through the artifact")
        try:
            post(port, b"this is not an image")
            raise AssertionError("garbage body was not refused")
        except urllib.error.HTTPError as e:
            print(f"  POST garbage: {e.code}")
            need(e.code == 400, "garbage body not answered 400")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    counts, routes = read_k1()
    need(counts["fwd"] == 23 * FWD_GRAPH_CALLS and routes["fwd"] == planned(
        gen_sites(1), "fwd", FWD_GRAPH_CALLS), "the artifact service's K1 "
         "calls left their count or routes")
    torch.cuda.empty_cache()
    res.update(http_launches=counts["fwd"], translate_ms=lat,
               http_max_levels=max(levels))
    return {"res": res, "paths": paths, "cases": cases}


def k1_share(prof, n_runs: int) -> tuple:
    """(busy ms, K1's ms) per run of a torch.profiler trace."""
    kern = kernel_times(prof, n_runs)
    return (sum(k[0] for k in kern),
            sum(k[0] for k in kern if any(t in k[2] for t in K1_FWD_KERNELS)))


def inference_cell_phase(card: str, dev, work: str, art: dict) -> dict:
    """Phase 27.  bench.py:147-175's inference cell: the generator's
    artifact (``utils.export.export_generator`` on phase 16's ResNet
    checkpoint at 256x512, and phase 20's U-Net at 128x128, bf16) at b=1
    and b=16, 32 calls after 3 by CUDA events, through its CUDA graph
    (``artifact``), beside its GraphModule run node by node from Python
    (``graph_module``, the artifact before its graph) and the eager
    forward of the same weights; a profiler window of each (busy, idle
    share, K1's share); the b=1 vs b=16 gap; and the host cost of a K1
    call through the registered op against the wrapper alone."""
    from torch.profiler import ProfilerActivity, profile

    from sggan_tpu_torch.config import parse_args
    from sggan_tpu_torch.ops import cuda_in, norm
    from sggan_tpu_torch.train import evaluate
    from sggan_tpu_torch.train.trainer import Trainer
    from sggan_tpu_torch.utils import checkpoint as ckpt
    from sggan_tpu_torch.utils import export as gexport

    out = {}
    for label, key in (("resnet_256x512", "resnet"),
                       ("unet_128x128", "unet")):
        _, flags, _, _, hw = art["cases"][key]
        cfg = parse_args(flags)
        tr = Trainer(cfg.replace(phase="test"), device=dev)
        tr.state = ckpt.load(tr.state, cfg.checkpoint_dir, cfg.dataset_dir)
        need(tr.state is not None, f"no checkpoint for {label}")
        gen, gen_bn = evaluate.eval_generator(tr), tr.state.gen_bn
        cell = {}
        for b in (1, 16):
            path = os.path.join(work, "artifacts", f"{key}_gen_b{b}.pt2")
            gexport.save(path, gexport.export_generator(
                gen, hw, b, torch.bfloat16, gen_bn))
            prog = gexport.load(path, dev)
            x = torch.rand(b, *hw, 3, device=dev)

            def eager():
                with torch.inference_mode():
                    return evaluate.gen_forward(cfg, gen, x, gen_bn)

            def graph_module():  # the program's nodes, each from Python
                with torch.inference_mode():
                    return prog._module(x)

            row = {}
            for name, fn in (("artifact", lambda: prog(x)),
                             ("graph_module", graph_module),
                             ("eager", eager)):
                ms = cuda_ms(fn, ART_ITERS, warmup=ART_WARMUP)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as p:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                busy, k1 = k1_share(p, 3)
                row[name] = {"ms_per_call": ms, "ms_per_image": ms / b,
                             "img_per_s": 1e3 * b / ms, "busy_ms": busy,
                             "idle_share": 1 - busy / ms,
                             "k1_share_of_busy": k1 / busy}
                print(f"  [{card}] {label} bf16 b={b} {name}: {ms:.3f} ms "
                      f"a call, {ms / b:.3f} ms/image, {1e3 * b / ms:.1f} "
                      f"img/s; busy {busy:.3f} ms ({100 * (1 - busy / ms):.1f}"
                      f"% idle), K1 {100 * k1 / busy:.1f}% of busy")
            cell[f"b{b}"] = row
            del prog, x
            torch.cuda.empty_cache()
        a1, a16 = cell["b1"]["artifact"], cell["b16"]["artifact"]
        cell["ms_per_image_b1_over_b16"] = (a1["ms_per_image"]
                                            / a16["ms_per_image"])
        cell["b1_host_ms"] = a1["ms_per_call"] - a1["busy_ms"]
        print(f"  [{card}] {label}: a b=1 image costs "
              f"{cell['ms_per_image_b1_over_b16']:.2f}x a b=16 one; the "
              f"host holds {cell['b1_host_ms']:.3f} ms of b=1's "
              f"{a1['ms_per_call']:.3f} ms")
        out[label] = cell
        del tr, gen
        torch.cuda.empty_cache()

    # a K1 call's host cost through the op: a site small enough that the
    # host sets the pace (the U-Net's last at b=1 is 128x128x64)
    x, g, b = site_inputs(1, (8, 8, 64), torch.bfloat16, dev, seed=27)
    with torch.inference_mode():
        host = {"op_us": 1e3 * cuda_ms(lambda: norm.instance_norm_op(
                    x, g, b, 1e-3, "relu", 0.3), 400, warmup=20),
                "wrapper_us": 1e3 * cuda_ms(lambda: cuda_in.
                    instance_norm_cuda(x, g, b, 1e-3, "relu", 0.3), 400,
                    warmup=20)}
    print(f"  [{card}] a K1 call at (1,8,8,64), host-bound: through the op "
          f"{host['op_us']:.1f} us, the wrapper alone "
          f"{host['wrapper_us']:.1f} us")
    out["k1_call_host_us"] = host
    return out


def selftest_start(work: str) -> subprocess.Popen:
    """``python -m sggan_tpu_torch.utils.import_tf --selftest`` in the
    background (minutes of pure-Python checksums at full width), its
    bundles under ``work``."""
    tmp = os.path.join(work, "selftest_tmp")
    os.makedirs(tmp)
    return subprocess.Popen(
        [sys.executable, "-m", "sggan_tpu_torch.utils.import_tf",
         "--selftest"], cwd=work, env={**repo_env(), "TMPDIR": tmp},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


TF_FLAGS = ["--use_resnet", "--img_height", str(H), "--img_width", str(W),
            "--segment_class", str(N_CLASS), "--compute_dtype", "bfloat16",
            "--dataset_dir", "city"]
TF_CHILD = ("import json, sys, chip_smoke; "
            "print(json.dumps(chip_smoke.tf_import_write(sys.argv[1])))")


def tf_import_start(work: str) -> subprocess.Popen:
    """Phase 28's host part in a process of its own, a session leader
    (its import_tf child is killed with it): ``tf_import_write``.  Started
    beside phase 29, whose fresh processes leave the host's other cores
    idle."""
    return subprocess.Popen([sys.executable, "-c", TF_CHILD, work], cwd=REPO,
                            env=repo_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def tf_import_write(work: str) -> dict:
    """Reference-TF2 bundles of a ResNet generator (ngf 64) and a semantic
    discriminator (ndf 64, 34 classes, 256x512) written by the port's
    ``tf_bundle`` from seeded weights; ``python -m
    sggan_tpu_torch.utils.import_tf`` makes cp-0000.pt of them (pure-
    Python checksums; it builds the train state on the card), which must
    hold the source weights exactly.  The source generator's weights are
    saved beside them for ``tf_import_phase``; returns the lines to show
    and the seconds."""
    from sggan_tpu_torch.models.discriminator import Discriminator
    from sggan_tpu_torch.models.generator_resnet import GeneratorResnet
    from sggan_tpu_torch.utils import tf_bundle, tf_weights
    from sggan_tpu_torch.utils.bridge import params_from_jax, params_to_jax

    d = os.path.join(work, "tf_import")
    rng = np.random.default_rng(28)

    def move_1d(tree):
        # the init's unit gammas and zero betas and biases moved by seeded
        # noise, so that every leaf is a distinct check
        return {k: move_1d(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                if v.ndim == 1 else v for k, v in tree.items()}

    nets = {"gen": (GeneratorResnet(
                ngf=NGF, generator=torch.Generator().manual_seed(28)),
                "resnet"),
            "disc": (Discriminator(
                ndf=64, n_class=N_CLASS, image_size=(H, W),
                generator=torch.Generator().manual_seed(29)),
                "discriminator")}
    src, log = {}, []
    t0 = time.perf_counter()
    for which, (net, kind) in nets.items():
        tree = move_1d(params_to_jax(net.state_dict()))
        kw = ({"n_valid": len([k for k in tree if re.fullmatch(r"v\d+", k)])}
              if kind == "discriminator" else {})
        flat, attrs = tf_weights.extract_flat_weights(kind, tree, **kw)
        prefix = os.path.join(d, "tf", which, "cp-0021.ckpt")
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        tf_bundle.write_keras_weights(prefix, flat, attrs, compress=True)
        src[which] = (prefix, params_from_jax(tree))
        log.append(f"  {which}: {len(flat)} weights "
                   f"({sum(w.size for w in flat) / 1e6:.2f} M) written as "
                   f"{prefix}")
    write_s = time.perf_counter() - t0
    out, import_s = run_cli(d, "TF bundles to cp-0000.pt",
                            ["--gen_src", src["gen"][0], "--disc_src",
                             src["disc"][0], *TF_FLAGS, "--checkpoint_dir",
                             os.path.join(d, "checkpoint")],
                            module="sggan_tpu_torch.utils.import_tf",
                            show=log.append)
    line = json.loads(out.strip().splitlines()[-1])
    need(line["ok"] and line["net"] == "resnet" and line["disc"]
         and line["epoch"] == 0, f"import_tf printed {line}")
    for which, part in (("gen", "gen"), ("disc", "disc")):
        saved = torch.load(os.path.join(d, "checkpoint", "city", part,
                                        "cp-0000.pt"), weights_only=True,
                           map_location="cpu")["params"]
        want = src[which][1]
        need(saved.keys() == want.keys() and all(
            torch.equal(saved[k], want[k]) for k in want),
            f"the imported {which} is not the source weights")
    torch.save(src["gen"][1], os.path.join(d, "src_gen.pt"))
    return {"log": log, "write_s": write_s, "import_s": import_s}


def tf_import_phase(card: str, dev, work: str, job_out: tuple,
                    selftest: subprocess.Popen) -> dict:
    """Phase 28.  ``tf_import_start``'s job, ended: ``job_out`` its
    (stdout, stderr, exit code, seconds waited for it); the import holds
    the source weights exactly; the service serves its cp-0000.pt
    (checkpoint_loaded) within one PNG level of the eager forward of the
    source weights; ``--selftest``, started beside phase 29, passes."""
    from sggan_tpu_torch import serve as srv
    from sggan_tpu_torch.config import parse_args
    from sggan_tpu_torch.models.generator_resnet import GeneratorResnet
    from sggan_tpu_torch.train import evaluate
    from sggan_tpu_torch.utils import tf_weights

    jout, jerr, rc, waited = job_out
    print(f"  the bundles' write and import_tf, beside phase 29 (waited "
          f"{waited:.1f} s after it): exit {rc}")
    if rc:
        print(jerr[-4000:], file=sys.stderr)
        raise AssertionError("the TF bundles' write or import failed")
    res = json.loads(jout.strip().splitlines()[-1])
    print(*res["log"], sep="\n")
    d = os.path.join(work, "tf_import")
    cfg = parse_args([*TF_FLAGS, "--checkpoint_dir",
                      os.path.join(d, "checkpoint")])
    svc = srv._Service(cfg, device=dev)
    need(svc.loaded, "the service did not load the imported checkpoint")
    gen = GeneratorResnet(ngf=NGF, generator=torch.Generator().manual_seed(0))
    gen.load_state_dict(torch.load(os.path.join(d, "src_gen.pt"),
                                   weights_only=True))
    gen = gen.to(dev).eval()
    x = np.random.default_rng(28).random((1, H, W, 3), np.float32)
    got = svc._fn(x)
    ref = evaluate.generate(cfg, gen, x, dev)
    levels = int(np.abs(u8(got[0]) - u8(ref[0])).max())
    print(f"  the service on the imported checkpoint vs the eager forward of "
          f"the source weights: {levels} PNG levels (limit 1)")
    need(levels <= 1, "the service does not serve the imported weights")
    del svc, gen

    t0 = time.perf_counter()
    sout, serr = selftest.communicate(timeout=900)
    wait_s = time.perf_counter() - t0
    if selftest.returncode:
        print(serr[-4000:], file=sys.stderr)
    want = {"ok": True, "selftest": {
        "resnet": len(tf_weights.resnet_layout()),
        "unet": len(tf_weights.unet_layout()),
        "discriminator": len(tf_weights.discriminator_layout(3)),
        "pix2pix_gen": len(tf_weights.pix2pix_gen_layout()),
        "pix2pix_disc": len(tf_weights.pix2pix_disc_layout())}}
    got_line = sout.strip().splitlines()[-1] if sout.strip() else ""
    print(f"  --selftest (in the background since phase 29; waited "
          f"{wait_s:.1f} s): {got_line}")
    need(selftest.returncode == 0 and json.loads(got_line) == want,
         "import_tf --selftest failed")
    return {"write_s": res["write_s"], "import_s": res["import_s"],
            "max_levels": levels, "selftest": want["selftest"]}


# ----------------------------------------------------------------------
# CUDA graphs: --scan_steps and the fixed-shape forward (phase 29)
# ----------------------------------------------------------------------

GRAPH_STEPS = 8          # steps each way from one snapshot, an epoch
GRAPH_CHUNKS = (8, 3)    # one whole chunk; 3 + 3 + 2, a tail
GRAPH_TIMED_EPOCHS = 1   # timed epochs each way, after one that warms up
K1_KERNEL = re.compile(r"\bin_(fwd_cluster|stats|apply|bwd_cluster|"
                       r"bwd_stats|bwd_apply)<")


def graph_cases() -> dict:
    """label -> (config, K1 sites of one step) of phase 29's step cells:
    the ResNet sggan step at 256x512 b=8 doubled to 16, and the same under
    ``--remat`` (whose forward sites are its own: each resblock's two
    norms again); the default p2p U-Net at 128x128 b=1 doubled to 2,
    dropout on; the pix2pix pair there with batch norm; the ResNet cycle
    step at 256x512 b=4 doubled to 8.  bf16, pool 50, 34 classes, no
    saves, one print an epoch."""
    from sggan_tpu_torch.config import Config
    quiet = dict(save_freq=0, print_freq=1000, data_seed=29)
    sggan = Config(image_height=H, image_width=W, ngf=NGF, ndf=64,
                   segment_class=N_CLASS, batch_size=B_TRAIN // 2,
                   loss_mode="sggan", use_resnet=True, **quiet)
    again = [(B_TRAIN, (H // 4, W // 4, 4 * NGF), act, 9)
             for act in ("relu", None)]
    return {
        "sggan_resnet_b16": (sggan, step_sites(B_TRAIN)),
        "sggan_resnet_b16_remat": (sggan.replace(remat=True), {
            "fwd": step_sites(B_TRAIN) + again, "bwd": step_sites(B_TRAIN)}),
        "p2p_unet_b2": (Config(**quiet), unet_step_sites(UNET_B, 128, 128)),
        "pix2pix_b2": (Config(use_pix2pix=True, **quiet), []),
        "cycle_resnet_b8": (cycle_cfg(CYCLE_B // 2).replace(**quiet),
                            cycle_step_sites(CYCLE_B)),
    }


def graph_trainer(cfg, dev, n_steps: int, seed: int = 0):
    """(a Trainer of ``cfg`` on the card at lr 1e-3, its resident split
    (a pair under the cycle mode) of ``n_steps`` batches of sources
    twice the image size)."""
    from sggan_tpu_torch.train.trainer import Trainer
    from sggan_tpu_torch.utils.hbm import SyntheticSplit
    tr = Trainer(cfg, device=dev)
    tr.lr.fill_(float(np.float32(1e-3)))
    src = (2 * cfg.image_height, 2 * cfg.image_width)
    splits = [SyntheticSplit(n_steps * cfg.batch_size, src,
                             cfg.segment_class, dev, seed + i)
              for i in range(2 if tr.cycle else 1)]
    return tr, tuple(splits) if tr.cycle else splits[0]


def train_snapshot(tr) -> tuple:
    """Every tensor a step writes, the step, the pool's count and both
    generators' states."""
    from sggan_tpu_torch.train.step import state_tensors
    with torch.no_grad():
        tensors = {k: t.clone() for k, t in state_tensors(tr.state).items()}
    return (tensors, tr.state.step, tr.state.pool.count,
            tr.data_gen.get_state(), tr.pool_gen.get_state())


def train_restore(tr, snap: tuple) -> None:
    from sggan_tpu_torch.train.step import state_tensors
    tensors, step, count, data_state, pool_state = snap
    with torch.no_grad():
        for k, t in state_tensors(tr.state).items():
            t.copy_(tensors[k])
    tr.state = tr.state._replace(step=step,
                                 pool=tr.state.pool._replace(count=count))
    tr.data_gen.set_state(data_state)
    tr.pool_gen.set_state(pool_state)


def loop_epoch(tr, ds, epoch: int, graph=None) -> torch.Tensor:
    """One epoch of the trainer's loop over ``ds``: the eager steps
    (``fused.run_epoch_fused``, ``--scan_steps 1``), or chunks of
    ``tr.cfg.scan_steps`` through ``graph`` (``fused.run_epoch_chunked``).
    Returns the steps' (gen, disc) losses, (steps, 2) on the card."""
    from sggan_tpu_torch.train import fused
    gl, dl = [], []
    if graph is None:
        fused.run_epoch_fused(tr, epoch, ds, fused.make_batch_fn(tr.cfg), gl,
                              dl, tr.state.step, time.time())
    else:
        fused.run_epoch_chunked(tr, epoch, graph, gl, dl, tr.state.step,
                                time.time())
    return torch.stack([torch.stack(gl), torch.stack(dl)], 1)


def k1_window(fn, n_runs: int, want: dict, tries: int = 6) -> dict:
    """``k1_kernel_calls`` of a profiler window over ``fn()``, which runs
    ``n_runs`` times what the counts are per.  The window is padded by a
    pause at each end, since the profiler drops a kernel whose converted
    time falls outside it; and a trace may drop an event all the same
    (``perf_in.device_ms``), so a window that does not hold ``want`` is
    taken again with a pause twice as long, up to ``tries`` windows, each
    said on stdout and stderr.  Returns the last window's counts."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        pad = 0.05 * 2 ** attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        got = k1_kernel_calls(prof, n_runs)
        if got == want:
            break
        for f in (sys.stdout, sys.stderr):
            print(f"  profiler: window {attempt + 1} (padded by {pad:.2f} s)"
                  f" holds K1's kernels for {got}, not {want}", file=f,
                  flush=True)
    return got


def k1_kernel_calls(prof, n_runs: int) -> dict:
    """K1's calls per run by direction and route, from the kernels a
    trace holds: a cluster call is one ``in_fwd_cluster`` or
    ``in_bwd_cluster`` kernel, a two-pass call one stats and one apply
    kernel; raises when a stats kernel has no apply kernel."""
    n = {}
    for _, cnt, name in kernel_times(prof, n_runs):
        m = K1_KERNEL.search(name)
        if m:
            n[m.group(1)] = n.get(m.group(1), 0) + cnt
    need(n.get("stats", 0) == n.get("apply", 0)
         and n.get("bwd_stats", 0) == n.get("bwd_apply", 0),
         f"K1's two-pass kernels unpaired in the trace: {n}")
    out = {"fwd": {"cluster": n.get("fwd_cluster", 0),
                   "stream": n.get("stats", 0)},
           "bwd": {"cluster": n.get("bwd_cluster", 0),
                   "stream": n.get("bwd_stats", 0)}}
    return {d: {r: c for r, c in v.items() if c} for d, v in out.items()}


def differing(a: dict, b: dict) -> list:
    """Names of the tensors of two snapshots that are not bitwise equal."""
    return [k for k in a if not torch.equal(a[k], b[k])]


def step_graph_gate(card: str, label: str, tr, ds, sites) -> dict:
    """Phase 29's gate of one step cell (the caller makes cuDNN
    deterministic): from one snapshot, ``GRAPH_STEPS`` eager steps, then
    the same steps through the graph in chunks of each of
    ``GRAPH_CHUNKS``; losses and every state tensor bitwise equal; K1's
    calls recorded at the capture as planned; the collectives' counts
    recorded at the capture an eager step's (none for one process); a
    profiler window of an epoch's replays names K1's kernels for those
    calls each."""
    from sggan_tpu_torch.train import fused
    snap = train_snapshot(tr)
    c0 = fused.comm_counts()
    eager = loop_epoch(tr, ds, 0).cpu()
    comm = {k: (v - c0[k]) // GRAPH_STEPS
            for k, v in fused.comm_counts().items()}
    need(all(v - c0[k] == GRAPH_STEPS * comm[k]
             for k, v in fused.comm_counts().items()),
         f"{label}: the eager steps' collectives differ from step to step")
    ref = train_snapshot(tr)
    want = {d: planned(sites[d] if isinstance(sites, dict) else sites, d)
            for d in ("fwd", "bwd")}
    res = {"eager_losses": eager.tolist(),
           "collectives_per_eager_step": comm}
    for k in GRAPH_CHUNKS:
        train_restore(tr, snap)
        tr.cfg = tr.cfg.replace(scan_steps=k)
        graph = fused.StepGraph(tr, ds, fused.make_batch_fn(tr.cfg))
        got = loop_epoch(tr, ds, 0, graph).cpu()
        after = train_snapshot(tr)
        bad = differing(ref[0], after[0])
        same = (torch.equal(got, eager) and not bad
                and after[1:3] == ref[1:3])
        (f, b), by_route = graph.k1_calls
        routes = {d: {r: n for (dd, r), n in by_route.items() if dd == d}
                  for d in ("fwd", "bwd")}
        print(f"  [{card}] {label} K={k}: {GRAPH_STEPS} steps through the "
              f"graph vs eager: losses "
              f"{'bitwise equal' if torch.equal(got, eager) else 'DIFFER'}, "
              f"{len(ref[0]) - len(bad)} of {len(ref[0])} state tensors "
              f"bitwise equal (differ: {bad[:8]}); step {after[1]}, pool "
              f"{after[2]}; K1 at the capture {f} + {b} by route {routes} "
              f"(planned {want})")
        need(same, f"{label}: the graph's steps are not the eager steps")
        need(routes == want, f"{label}: K1's calls at the capture left "
             "their count or routes")
        need(graph.comm_calls == comm, f"{label}: the collectives recorded "
             f"at the capture {graph.comm_calls}, an eager step's {comm}")
        res[f"k{k}"] = {"bitwise": same, "k1_at_capture": routes,
                        "collectives_at_capture": graph.comm_calls}
        if k == GRAPH_CHUNKS[0]:
            # a window of one more epoch's replays: K1's own kernels, a
            # step's calls each
            seen = k1_window(lambda: loop_epoch(tr, ds, 1, graph),
                             GRAPH_STEPS, want)
            print(f"  [{card}] {label}: a profiler window of {GRAPH_STEPS} "
                  f"replays, K1's kernels a replay by route {seen}")
            need(seen == want, f"{label}: the replays did not launch K1's "
                 "kernels for the planned calls")
            res["k1_kernels_per_replay"] = seen
        del graph
        torch.cuda.empty_cache()
    return res


def loop_timing(card: str, label: str, tr, ds) -> dict:
    """The trainer's loop eager (``--scan_steps 1``) then through the
    step's graph (``--scan_steps`` 8) on ``tr`` and ``ds``, cuDNN's
    defaults: each a warm-up epoch (the graph's capture), then
    ``GRAPH_TIMED_EPOCHS`` epochs by CUDA events (step ms, img/s) and one
    more under the profiler (busy, idle share); the peak memory allocated
    and reserved since the warm-up, the graph's private pool included."""
    from torch.profiler import ProfilerActivity, profile

    from sggan_tpu_torch.train import fused
    out = {}
    b_eff = fused.effective_batch(tr.cfg)
    for name in ("eager", "graph"):
        graph = None
        if name == "graph":
            tr.cfg = tr.cfg.replace(scan_steps=GRAPH_CHUNKS[0])
            graph = fused.StepGraph(tr, ds, fused.make_batch_fn(tr.cfg))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loop_epoch(tr, ds, 0, graph)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for e in range(GRAPH_TIMED_EPOCHS):
            loop_epoch(tr, ds, 1 + e, graph)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (GRAPH_TIMED_EPOCHS * GRAPH_STEPS)
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30,
                torch.cuda.max_memory_reserved() / 2 ** 30)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loop_epoch(tr, ds, 1 + GRAPH_TIMED_EPOCHS, graph)
            torch.cuda.synchronize()
        kern = kernel_times(prof, GRAPH_STEPS)
        busy = sum(k[0] for k in kern)
        out[name] = {"step_ms": ms, "busy_ms": busy,
                     "idle_share": 1 - busy / ms, "peak_gib": peak[0],
                     "peak_reserved_gib": peak[1],
                     "img_per_s": 1e3 * b_eff / ms,
                     # (ms, launches) a step of each NCCL kernel, by name
                     "nccl_kernels": {n: [t, c] for t, c, n in kern
                                      if "nccl" in n.lower()}}
        print(f"  [{card}] {label} {name}: {ms:.3f} ms a step of the loop, "
              f"{1e3 * b_eff / ms:.2f} {'pairs' if tr.cycle else 'img'}/s, "
              f"busy {busy:.3f} ms ({100 * (1 - busy / ms):.1f}% idle), "
              f"peak {peak[0]:.2f} GiB allocated, {peak[1]:.2f} reserved")
        del graph
    out["graph_over_eager_ms"] = out["graph"]["step_ms"] / out["eager"][
        "step_ms"]
    return out


def forward_graph_gate(card: str, dev) -> dict:
    """Phase 29's forward graphs: ``evaluate.generate`` through
    ``ForwardGraphs`` against the eager generate, the ResNet at 256x512
    and the U-Net at 128x128, bf16, b=1 and 16: bitwise equal (cuDNN
    deterministic), K1's calls twice a forward at the first call (the
    warm-up and the capture) and none at a replay, a profiler window of
    one replay naming K1's kernels for a forward's calls; then the
    graph's ms a call beside eager's."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import evaluate
    from sggan_tpu_torch.utils.cuda_graph import ForwardGraphs
    out = {}
    for label, cfg, sites in (
            ("resnet_256x512", Config(use_resnet=True, image_height=H,
                                      image_width=W, ngf=NGF), gen_sites),
            ("unet_128x128", Config(ngf=NGF),
             lambda n: unet_sites(n, 128, 128))):
        gen = evaluate.build_generator(cfg).to(dev)
        for b in (1, 16):
            x = torch.rand(b, *cfg.image_size, 3, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(b))
            graphs = ForwardGraphs()
            want = planned(sites(b), "fwd")
            det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                y_eager = evaluate.generate(cfg, gen, x, dev)
                reset_k1()
                y_graph = evaluate.generate(cfg, gen, x, dev, graphs=graphs)
                first, routes = read_k1()
                y_again = evaluate.generate(cfg, gen, x, dev, graphs=graphs)
                replay = read_k1()[0]["fwd"] - first["fwd"]
                seen = k1_window(lambda: evaluate.generate(
                    cfg, gen, x, dev, graphs=graphs), 1,
                    {"fwd": want, "bwd": {}})["fwd"]
            finally:
                torch.backends.cudnn.deterministic = det
            same = (np.array_equal(y_graph, y_eager)
                    and np.array_equal(y_again, y_eager))
            print(f"  [{card}] {label} b={b} forward graph vs eager: "
                  f"{'bitwise equal' if same else 'DIFFER'}; K1 at the "
                  f"first call {first['fwd']} by route {routes['fwd']} "
                  f"(twice {want}), at a replay {replay}")
            need(same, f"{label} b={b}: the forward graph's output is not "
                 "the eager forward's")
            need(first["fwd"] == 2 * sum(want.values()) and routes["fwd"]
                 == {r: 2 * c for r, c in want.items()} and replay == 0,
                 f"{label} b={b}: the forward graph's K1 calls")
            need(seen == want, f"{label} b={b}: a replay did not launch "
                 f"K1's kernels for a forward's calls: {seen}")
            row = {"bitwise": same, "k1_kernels_per_replay": seen}
            # cuDNN's defaults: the graph's first call here captures anew
            for name, gs in (("eager", None), ("graph", graphs)):
                row[f"{name}_ms"] = cuda_ms(lambda: evaluate.generate(
                    cfg, gen, x, dev, graphs=gs), 20 if b == 1 else 5)
            print(f"  [{card}] {label} b={b} generate (input upload to the "
                  f"output on the host): eager {row['eager_ms']:.3f} ms, "
                  f"graph {row['graph_ms']:.3f} ms a call")
            out[f"{label}_b{b}"] = row
            del graphs, x
            torch.cuda.empty_cache()
        del gen
        torch.cuda.empty_cache()
    return out


FRESH_CHILD = ("import json, sys, torch, chip_smoke; print(json.dumps("
               "getattr(chip_smoke, sys.argv[1])(sys.argv[2], "
               "torch.device('cuda'))))")


def run_fresh(card: str, fn: str, timeout: int) -> dict:
    """``chip_smoke.<fn>(card, device)`` in a fresh process, its output
    shown and its last line's JSON returned: late in a long process the
    profiler drops kernels from short traces (PERF.md section 7), which
    phase 29 counts, and phase 32 needs the card's memory to itself."""
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([sys.executable, "-u", "-c", FRESH_CHILD, fn,
                                 card], cwd=REPO, env=repo_env(),
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        # shown as it comes, one line behind: the last line is the result
        last = None
        try:
            for ln in proc.stdout:
                if last is not None:
                    print(last, end="", flush=True)
                last = ln
            proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        print(f"  {fn} in a fresh process: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode:
            err.seek(0)
            print((last or "") + err.read()[-4000:], file=sys.stderr)
            raise AssertionError(f"{fn} failed")
    return json.loads(last)


def graphs_phase(card: str, dev) -> dict:
    """Phase 29's step cells as CUDA graphs (``--scan_steps``): each
    cell's gate (``step_graph_gate``) and its loop eager beside the graph
    (``loop_timing``); ``graphs_hist_phases`` runs it first in its
    process."""
    out = {"steps": {}, "timing": {}}
    for label, (cfg, sites) in graph_cases().items():
        tr, ds = graph_trainer(cfg, dev, GRAPH_STEPS)
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            out["steps"][label] = step_graph_gate(card, label, tr, ds, sites)
        finally:
            torch.backends.cudnn.deterministic = det
        out["timing"][label] = loop_timing(card, label, tr, ds)
        del tr, ds
        torch.cuda.empty_cache()
    return out


# the ResNet sggan step's two buckets at 256x512, ngf and ndf 64, 34
# classes: its gradients and loss (no batch norm), f32 (phase 36, PR 14)
DP_BUCKET_BYTES = 90165916
NCCL_CELLS = ("sggan_resnet_b16", "pix2pix_b2")


def one_rank_nccl():
    """The default process group of this process alone, over NCCL on the
    current card (``tcp://localhost`` on a free port)."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    return dist.group.WORLD


def nccl_graph_phase(card: str, dev) -> dict:
    """Phase 39, part 1, in phase 29's process after its cells: the
    data-parallel step over a group of one NCCL rank on the card (built
    with ``keep_one``, which the trainer never passes, so that its
    buckets' all-reduces are NCCL calls), in the ResNet sggan cell and the
    pix2pix cell of phase 29 (whose bucket carries the batch norms'
    stats): ``step_graph_gate`` (8 eager steps and the same through the
    graph in chunks of 8 and of 3, bitwise; K1's calls at the capture and
    in a window of replays; the collectives recorded at the capture an
    eager step's: 2 all-reduces, and the ResNet's bytes), then
    ``loop_timing`` with the NCCL kernels of a window of replays."""
    import torch.distributed as dist

    from sggan_tpu_torch.train.step import build_step_fn
    phase("39 the multi-rank step as a CUDA graph, part 1 (main path): the "
          "data-parallel step over a group of one NCCL rank on the card, "
          "its collectives in the step's graph")
    group = one_rank_nccl()
    out = {"backend": dist.get_backend(group),
           "nccl": str(torch.cuda.nccl.version()),
           "steps": {}, "timing": {}}
    cases = graph_cases()
    try:
        for label in NCCL_CELLS:
            cfg, sites = cases[label]
            tr, ds = graph_trainer(cfg, dev, GRAPH_STEPS)
            tr.group = group
            tr.step_fn = build_step_fn(cfg, group, keep_one=True)
            det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                res = step_graph_gate(card, f"nccl {label}", tr, ds, sites)
            finally:
                torch.backends.cudnn.deterministic = det
            comm = res["collectives_per_eager_step"]
            print(f"  [{card}] nccl {label}: a step's collectives, eager "
                  f"and at the capture: {comm}")
            need(comm["dp.all_reduce_calls"] == 2 and (
                label != "sggan_resnet_b16"
                or comm["dp.all_reduce_bytes"] == DP_BUCKET_BYTES),
                 f"nccl {label}: a step's all-reduces {comm}, not 2 buckets"
                 f" (the ResNet's {DP_BUCKET_BYTES} bytes)")
            out["steps"][label] = res
            t = out["timing"][label] = loop_timing(card, f"nccl {label}",
                                                   tr, ds)
            for name in ("eager", "graph"):
                kern = t[name]["nccl_kernels"]
                print(f"  [{card}] nccl {label} {name}: NCCL kernels a step "
                      + (", ".join(f"{n[:70]} {ms:.4f} ms x{c}"
                                   for n, (ms, c) in kern.items())
                         if kern else "none in the trace"))
            del tr, ds
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def graphs_hist_phases(card: str, dev) -> dict:
    """Phase 29's step cells (``graphs_phase``), then phase 39's part 1
    (``nccl_graph_phase``), then phase 29's forward graphs
    (``forward_graph_gate``), then phase 33 (``hist_phase``), then phase
    38 (``orbax_phase``, beside phase 28's host work), in one fresh
    process: the profiler windows that count K1's kernels come in its
    first minutes, each taken again when a trace drops one
    (``k1_window``)."""
    graphs = graphs_phase(card, dev)
    nccl = nccl_graph_phase(card, dev)
    graphs["forward"] = forward_graph_gate(card, dev)
    return {"graphs": graphs, "nccl_graph": nccl,
            "hist": hist_phase(card, dev), "orbax": orbax_phase(card, dev)}


# ----------------------------------------------------------------------
# The generator's layer forms and --remat (phases 30-32)
# ----------------------------------------------------------------------

# (label, (N, H, W, Cin), Cout, k) of the ResNet's reflect convs: c1, and
# a resblock conv (the other 17 alike)
REFLECT_SITES = [("c1", (B_TRAIN, H, W, 3), NGF, 7),
                 ("resblock", (B_TRAIN, H // 4, W // 4, 4 * NGF), 4 * NGF,
                  3)]
REFLECT_ITERS = 10
# phase 31: the 7x7 64 -> 3 head at best_block's (8, 4) and these
HEAD_BLOCKS = [(8, 4), (4, 4), (4, 8), (2, 2)]
HEAD_BATCHES = (8, 16)
HEAD_ITERS = 10
# phase 32's largest-batch search: at most this many probes a search
MAX_PROBES = 8
LB_FIRST, LB_FILL = (4, 8), 0.95  # largest_batch's first probes, its aim
# where phase 32's searches start: the answers measured on the H100 (80
# GB, 700 W; PERF.md section 5), so that a search probes near the limit
# only; the answer is still a batch that fits beside one that does not
LB_GUESS = {"sggan_resnet_2048x1024": {"plain": 15, "remat": 25},
            "cycle_resnet_512x1024": {"plain": 11, "remat": 20}}


def held_to(name: str, got, ref, dtype) -> dict:
    """One tensor of a form against its plain twin's: in f32 within 1e-5
    of the twin's largest element; in bf16 at phase 13's limits: a value
    within two ulps of the largest's binade, a gradient STEP_NORM_REL in
    norm and STEP_MAX_REL of its largest pointwise."""
    d = got.float() - ref.float()
    scale = ref.float().abs().max().item()
    err = d.abs().max().item()
    norm = (d.norm() / ref.float().norm()).item()
    if dtype == torch.float32:
        ok = err <= 1e-5 * scale
    elif name == "y":
        ok = err <= 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    else:
        ok = norm <= STEP_NORM_REL and err <= STEP_MAX_REL * scale
    return {"max_abs": err, "scale": scale, "norm_rel": norm, "ok": ok}


def conv_grads(f, x, w, dy, cd, need_dx: bool = True) -> tuple:
    """(y, dx or None, dw) of ``f({"w": w}, x, cd, bias=False)``, the
    backward fed ``dy``."""
    xl = x.detach().requires_grad_(need_dx)
    wl = w.detach().requires_grad_(True)
    y = f({"w": wl}, xl, cd, bias=False)
    gs = torch.autograd.grad(y, (xl, wl) if need_dx else (wl,), dy)
    return (y.detach(), *gs) if need_dx else (y.detach(), None, gs[0])


class net_forms:
    """Inside: the ResNet generator with ``conv`` as its reflect conv and,
    with ``block``, its head at that block (a (1, 1) head is that conv
    too); the parent's forms are ``conv2d_reflect_ref`` at (1, 1)."""

    def __init__(self, conv, block=None):
        self.conv, self.block = conv, block

    def __enter__(self):
        from sggan_tpu_torch.models import generator_resnet as gr
        from sggan_tpu_torch.ops import s2d
        self.saved = (gr.conv2d_reflect, s2d.head_block)
        gr.conv2d_reflect = self.conv
        if self.block is not None:
            s2d.head_block = lambda k, cout, h, w: self.block

    def __exit__(self, *exc):
        from sggan_tpu_torch.models import generator_resnet as gr
        from sggan_tpu_torch.ops import s2d
        gr.conv2d_reflect, s2d.head_block = self.saved


def kernel_listing(fn, iters: int) -> list:
    """``kernel_times`` of a profiler window of ``iters`` calls of ``fn``
    after a warm-up: (device ms a call, launches a call, name)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return kernel_times(prof, iters)


def busy_ms(fn, iters: int) -> float:
    """Device ms of one call of ``fn``: all kernels' time in a profiler
    window of ``iters`` calls after a warm-up, over ``iters``.  A window
    that holds no kernel is taken again (``perf_in.device_ms``), up to
    three; the window is padded by a pause at each end."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        ms = sum(k[0] for k in kernel_times(prof, iters))
        if ms > 0:
            return ms
    raise AssertionError("three profiler windows held no kernel")


def category_ms(prof, n_runs: int, categories) -> dict:
    """(device ms, launches) per run of each category of a trace (the
    first category a kernel's name matches, as ``print_breakdown``), and
    of all kernels under "busy"."""
    kern = kernel_times(prof, n_runs)
    out = {"busy": (sum(k[0] for k in kern), sum(k[1] for k in kern))}
    for cat, keys in categories:
        mine = [k for k in kern if any(t in k[2] for t in keys)]
        kern = [k for k in kern if k not in mine]
        out[cat] = (sum(k[0] for k in mine), sum(k[1] for k in mine))
    return out


def step_profile(cfg, b: int, dev, n_runs: int = 2) -> dict:
    """``category_ms`` of ``n_runs`` steps of ``cfg`` at batch ``b``, after
    one that warms up, from a fresh state."""
    from torch.profiler import ProfilerActivity, profile

    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    cfg = cfg.replace(batch_size=b)
    holder = [tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)]
    make = cycle_batch if cfg.loss_mode == "cycle" else train_batch
    batch = make(cfg, b, dev, seed=5)
    step_fn = tstep.build_step_fn(cfg)
    draw_gen = torch.Generator().manual_seed(6)

    def one():
        holder[0] = step_fn(holder[0], batch, 1e-3, tpool.pool_draws(
            draw_gen, b, cfg.max_size))[0]
    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_runs):
            one()
        torch.cuda.synchronize()
    out = category_ms(prof, n_runs, STEP_CATEGORIES)
    del holder, batch
    torch.cuda.empty_cache()
    return out


def reflect_phase(card: str, dev) -> dict:
    """Phase 30.  The reflect pad's Function against its plain twin (the
    gather, autograd's index adjoint), and both forms of the reflect conv
    (the pad-free Function; the gather + VALID conv) against theirs
    (``conv2d_reflect_ref``), at c1 and a resblock conv, f32 (TF32 off,
    as the caller leaves it) and bf16: value, dx, dw; each form's forward
    + backward timed by CUDA events; then the profiler's reflect pads in
    one ResNet sggan step at b=16 and one cycle step at b=8, in the
    parent's forms and in the path's (one profiled step each, after one
    that warms up: the profiler's own processing of a cycle step's events
    is most of this phase's time)."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.ops import layers as tl
    forms = {"pad_free": tl.conv2d_reflect_pad_free,
             "gather": tl.conv2d_reflect_gather,
             "plain": tl.conv2d_reflect_ref}
    path = next(k for k, f in forms.items() if f is tl.conv2d_reflect)
    out = {"path_form": path, "sites": {}}
    for label, shape, cout, k in REFLECT_SITES:
        p = k // 2
        need_dx = label != "c1"  # c1 reads the image: no dx in the net
        for cd in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(30)
            x = torch.randn(shape, generator=g, device=dev).to(cd)
            w = torch.randn(cout, shape[3], k, k, generator=g, device=dev) \
                / math.sqrt(shape[3] * k * k)
            dy = torch.randn(*shape[:3], cout, generator=g,
                             device=dev).to(cd)
            dyp = torch.randn(shape[0], shape[1] + 2 * p, shape[2] + 2 * p,
                              shape[3], generator=g, device=dev).to(cd)

            def pad_grads(f):
                xl = x.detach().requires_grad_(True)
                y = f(xl, p)
                return y.detach(), torch.autograd.grad(y, xl, dyp)[0]
            (yp, dxp), (yr, dxr) = (pad_grads(tl.reflect_pad),
                                    pad_grads(tl.reflect_pad_ref))
            pad_dx = held_to("dx", dxp, dxr, cd)
            need(torch.equal(yp, yr) and pad_dx["ok"],
                 f"{label} {cd}: the reflect pad's Function disagrees with "
                 f"its plain twin: dx {pad_dx}")
            ref = conv_grads(tl.conv2d_reflect_ref, x, w, dy, cd)
            row = {"pad_dx": pad_dx}
            for name in ("pad_free", "gather"):
                got = conv_grads(forms[name], x, w, dy, cd)
                row[name] = {t: held_to(t, a, b, cd) for t, a, b in
                             zip(("y", "dx", "dw"), got, ref)}
                need(all(v["ok"] for v in row[name].values()),
                     f"{label} {cd}: {name} disagrees with the plain "
                     f"twin: {row[name]}")
            del ref, got, yp, yr, dxp, dxr
            ms = {name: cuda_ms(lambda f=f: conv_grads(f, x, w, dy, cd,
                                                       need_dx),
                                REFLECT_ITERS, warmup=3)
                  for name, f in forms.items()}
            ms.update({f"dev_{name}": busy_ms(
                lambda f=f: conv_grads(f, x, w, dy, cd, need_dx),
                REFLECT_ITERS) for name, f in forms.items()})
            with torch.no_grad():  # the forward alone, as serving runs it
                ms.update({f"fwd_{name}": cuda_ms(
                    lambda f=f: f({"w": w}, x, cd, bias=False),
                    REFLECT_ITERS, warmup=3) for name, f in forms.items()})
            ms.update({f"pad_{name}": cuda_ms(lambda f=f: pad_grads(f),
                                              REFLECT_ITERS, warmup=3)
                       for name, f in (("function", tl.reflect_pad),
                                       ("plain", tl.reflect_pad_ref))})
            row["ms"] = ms
            key = f"{label} {str(cd)[6:]}"
            out["sites"][key] = row
            print(f"  [{card}] {key} {tuple(shape)} -> {cout}, k{k}: "
                  + "; ".join(f"{n} y/dx/dw max abs "
                              + "/".join(f"{row[n][t]['max_abs']:.3g}"
                                         for t in ("y", "dx", "dw"))
                              for n in ("pad_free", "gather"))
                  + f"; the pad's dx {pad_dx['max_abs']:.3g}")
            print(f"  [{card}] {key} forward + backward"
                  f"{'' if need_dx else ' (dw only, as in the net)'}: "
                  f"pad-free {ms['pad_free']:.3f} ms, gather + VALID "
                  f"{ms['gather']:.3f} ms, plain twin {ms['plain']:.3f} "
                  f"ms; device {ms['dev_pad_free']:.3f} / "
                  f"{ms['dev_gather']:.3f} / {ms['dev_plain']:.3f} ms; "
                  f"forward alone {ms['fwd_pad_free']:.3f} / "
                  f"{ms['fwd_gather']:.3f} / {ms['fwd_plain']:.3f} ms; "
                  f"the pad alone with its dx: Function "
                  f"{ms['pad_function']:.3f} ms, plain "
                  f"{ms['pad_plain']:.3f} ms")
            del x, dy, dyp
            torch.cuda.empty_cache()
    faster = {key: {by: min(("pad_free", "gather"),
                            key=lambda n: r["ms"][pre + n])
                    for by, pre in (("events", ""), ("device", "dev_"))}
              for key, r in out["sites"].items()}
    print(f"  the faster form by site, by events and by device time: "
          f"{faster}")
    out["faster"] = faster
    base = Config(image_height=H, image_width=W, ngf=NGF, ndf=64,
                  segment_class=N_CLASS, max_size=50,
                  compute_dtype="bfloat16", loss_mode="sggan",
                  use_resnet=True)
    cat = "reflect pads and their adjoints"
    out["steps"] = {}
    # the step in the parent's forms, then in each form of the reflect
    # conv on the path's head: device time by category
    variants = {"parent": (tl.conv2d_reflect_ref, (1, 1)),
                "gather": (tl.conv2d_reflect_gather, None),
                "pad_free": (tl.conv2d_reflect_pad_free, None)}
    for label, cfg, b in (("sggan_resnet_b16", base, B_TRAIN),
                          ("cycle_resnet_b8", cycle_cfg(CYCLE_B), CYCLE_B)):
        res = {}
        for name, (conv, block) in variants.items():
            with net_forms(conv, block):
                res[name] = step_profile(cfg, b, dev, n_runs=1)
        out["steps"][label] = res
        print(f"  [{card}] {label}, profiler over 1 step, ms (launches) a "
              "step: " + "; ".join(
                  f"{name}: {cat} {r[cat][0]:.3f} ({r[cat][1]}), "
                  f"convolutions {r['convolutions'][0]:.3f}, copies and "
                  f"casts {r['copies and casts'][0]:.3f}, busy "
                  f"{r['busy'][0]:.3f}" for name, r in res.items()))
    busy = {name: sum(out["steps"][k][name]["busy"][0]
                      for k in out["steps"]) for name in variants}
    out["faster_in_steps"] = min(("gather", "pad_free"), key=busy.get)
    print(f"  the steps' busy summed: {busy}; faster in the steps: "
          f"{out['faster_in_steps']}; the path's conv2d_reflect is {path}")
    return out


def head_phase(card: str, dev) -> dict:
    """Phase 31.  The 7x7 64 -> 3 head at (8 and 16, 256, 512), bf16,
    forward + backward (dx and dw): cuDNN's plain conv after the reflect
    pad or pad-free (``conv2d_reflect``), beside ``conv2d_valid_s2d``
    after the pad and ``conv2d_reflect_s2d`` at ``best_block``'s and the
    other HEAD_BLOCKS, each held to the plain twin; the table; then the
    generator with ``pad_free_head`` true, false and by default, f32 card
    against the CPU at 256x512."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.models.generator_resnet import GeneratorResnet
    from sggan_tpu_torch.ops import layers as tl
    from sggan_tpu_torch.ops import s2d
    from sggan_tpu_torch.train.step import pad_free_head
    best = s2d.best_block(7, 3, H, W)
    blocks = [best] + [r for r in HEAD_BLOCKS if r != best]

    def forms():
        yield "(1, 1) pad + conv", lambda p, x, cd, bias: tl.conv2d(
            p, tl.reflect_pad(x, 3), 1, "VALID", cd)
        yield "(1, 1) conv2d_reflect", lambda p, x, cd, bias: \
            tl.conv2d_reflect(p, x, cd)
        for r in blocks:
            yield f"{r} pad + conv2d_valid_s2d", \
                lambda p, x, cd, bias, r=r: s2d.conv2d_valid_s2d(
                    p, tl.reflect_pad(x, 3), r, cd)
            yield f"{r} conv2d_reflect_s2d", \
                lambda p, x, cd, bias, r=r: s2d.conv2d_reflect_s2d(
                    p, x, r, cd)

    cd = torch.bfloat16
    table, device = {}, {}
    rule = s2d.head_block(7, 3, H, W)
    # the path's two heads at its block, kernel by kernel
    listed = {f"{rule} pad + conv2d_valid_s2d": None,
              f"{rule} conv2d_reflect_s2d": None}
    for n in HEAD_BATCHES:
        g = torch.Generator(device=dev).manual_seed(31)
        x = torch.randn(n, H, W, NGF, generator=g, device=dev).to(cd)
        w = torch.randn(3, NGF, 7, 7, generator=g, device=dev) \
            / math.sqrt(NGF * 49)
        dy = torch.randn(n, H, W, 3, generator=g, device=dev).to(cd)
        ref = conv_grads(tl.conv2d_reflect_ref, x, w, dy, cd)
        for name, f in forms():
            got = conv_grads(f, x, w, dy, cd)
            held = {t: held_to(t, a, b, cd)
                    for t, a, b in zip(("y", "dx", "dw"), got, ref)}
            need(all(v["ok"] for v in held.values()),
                 f"head {name} b={n} disagrees with the plain twin: {held}")
            table.setdefault(name, {})[n] = cuda_ms(
                lambda f=f: conv_grads(f, x, w, dy, cd), HEAD_ITERS,
                warmup=3)
            if n == HEAD_BATCHES[-1] and name in listed:
                listed[name] = kernel_listing(
                    lambda f=f: conv_grads(f, x, w, dy, cd), 3)
            device.setdefault(name, {})[n] = busy_ms(
                lambda f=f: conv_grads(f, x, w, dy, cd), HEAD_ITERS)
        del x, dy, ref, got
        torch.cuda.empty_cache()
    print(f"  [{card}] the head, 7x7 64 -> 3 at 256x512 bf16, forward + "
          f"backward (dx, dw), ms a call over {HEAD_ITERS}: CUDA events | "
          "device (profiler)")
    for name, row in table.items():
        print(f"    {name:34s} " + "  ".join(
            f"b={n}: {ms:8.3f} | {device[name][n]:8.3f}"
            for n, ms in row.items()))
    n = HEAD_BATCHES[-1]
    for name, rows in listed.items():
        print(f"  [{card}] {name} at b={n}, device ms a call by kernel:")
        for ms, cnt, kname in rows[:10]:
            print(f"      {ms:8.4f} ms  x{cnt:<3d} {kname[:90]}")
    fastest = {"events": min(table, key=lambda k: table[k][n]),
               "device": min(device, key=lambda k: device[k][n])}
    print(f"  fastest at b={n}: {fastest}; best_block (the TPU's cost "
          f"model) {best}; head_block, the path's rule, {rule}")
    out = {"events": {k: {str(n): v for n, v in r.items()}
                      for k, r in table.items()},
           "device": {k: {str(n): v for n, v in r.items()}
                      for k, r in device.items()},
           "fastest": fastest, "best_block": list(best),
           "head_block": list(rule)}
    # the generator's three head settings, f32 card vs CPU (phase 4's)
    gen = GeneratorResnet(ngf=NGF, generator=torch.Generator().manual_seed(0))
    gx = torch.Generator().manual_seed(1)
    x_cpu = torch.round(torch.rand(1, H, W, 3, generator=gx) * 255.0)
    default = pad_free_head(Config(use_resnet=True))
    errs = {}
    with torch.inference_mode():
        refs = {v: gen(x_cpu, {}, torch.float32, pad_free_head=v)[0]
                for v in (True, False)}
        gen = gen.to(dev)
        for name, v in (("true", True), ("false", False),
                        ("default", default)):
            got = gen(x_cpu.to(dev), {}, torch.float32,
                      pad_free_head=v)[0].cpu()
            errs[name] = (got - refs[v]).abs().max().item()
            need(got.shape == (1, H, W, 3) and bool(torch.isfinite(got).all())
                 and errs[name] <= SLICE_ATOL,
                 f"pad_free_head {name}: the f32 card forward disagrees with "
                 f"the CPU")
    print(f"  the generator, f32 card vs CPU at 256x512, max abs diff by "
          f"pad_free_head: {errs} (atol {SLICE_ATOL}; the default is "
          f"{default})")
    out["generator_card_vs_cpu"] = errs
    del gen
    torch.cuda.empty_cache()
    return out


def remat_extra(cfg) -> int:
    """K1 forward calls that ``--remat`` adds to one step of ``cfg``: the
    instance norms inside the recomputed units (the ResNet's 9 resblocks,
    2 each; the U-Net's 15 stages, 1 each) of every generator call whose
    output the generator loss differentiates: 1 in the sggan and p2p
    steps, 6 in the cycle step with its identity term (4 without)."""
    per_call = 2 * 9 if cfg.use_resnet else 15
    calls = (6 if cfg.identity_lambda else 4) if cfg.loss_mode == "cycle" \
        else 1
    return per_call * calls


def remat_cells() -> dict:
    """label -> (config, batch, K1 sites of one step) of phase 32's step
    cells: the ResNet sggan step 256x512 b=16, the default p2p U-Net
    128x128 b=2 (masks fed), the ResNet cycle step 256x512 b=8; bf16."""
    from sggan_tpu_torch.config import Config
    return {
        "sggan_resnet_b16": (Config(
            image_height=H, image_width=W, ngf=NGF, ndf=64,
            segment_class=N_CLASS, batch_size=B_TRAIN, max_size=50,
            compute_dtype="bfloat16", loss_mode="sggan", use_resnet=True),
            step_sites(B_TRAIN)),
        "p2p_unet_b2": (Config(
            image_height=128, image_width=128, ngf=NGF, ndf=64,
            segment_class=N_CLASS, batch_size=UNET_B,
            compute_dtype="bfloat16"), unet_step_sites(UNET_B, 128, 128)),
        "cycle_resnet_b8": (cycle_cfg(CYCLE_B), cycle_step_sites(CYCLE_B)),
    }


def step_grads_once(cfg, state, batch, draws, masks):
    """(losses, gen grads, disc grads) of one step's ``losses_and_grads``
    (the state is not changed), K1's calls by direction, peak GiB."""
    from sggan_tpu_torch.train import cycle as tcycle
    from sggan_tpu_torch.train import step as tstep
    fn = tcycle.losses_and_grads if cfg.loss_mode == "cycle" \
        else tstep.losses_and_grads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_k1()
    m, gg, dg, *_ = fn(cfg, state, batch, draws, masks)
    counts, routes = read_k1()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return (torch.stack([m["gen_loss"], m["disc_loss"]]), gg, dg), \
        counts, routes, peak


def remat_step_cells(card: str, dev) -> dict:
    """Phase 32's step cells: from one state, the step's losses and
    gradients with ``--remat`` and without it (both on the head that
    ``--remat`` defaults to, the pre-padded one), cuDNN deterministic:
    bitwise equal; K1's exact calls (forward + ``remat_extra``, the
    backward's unchanged) on the planned routes; peak memory and the
    forward + backward's ms each way."""
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, (cfg, sites) in remat_cells().items():
            b = cfg.batch_size
            plain = cfg.replace(pad_free_head=False)
            remat = cfg.replace(remat=True)
            need(tstep.pad_free_head(remat) is False, "--remat's head")
            state = tstep.init_state(plain, torch.Generator().manual_seed(0),
                                     dev)
            h, w = cfg.image_size
            make = cycle_batch if cfg.loss_mode == "cycle" else train_batch
            batch = make(cfg, b, dev, seed=5)
            draws = tpool.pool_draws(torch.Generator().manual_seed(6), b,
                                     cfg.max_size)
            masks = tstep.dropout_masks(
                cfg, state.gen_params,
                torch.Generator(device=dev).manual_seed(7), b)
            res, extra = {}, remat_extra(cfg)
            for name, c in (("plain", plain), ("remat", remat)):
                got, counts, routes, peak = step_grads_once(
                    c, state, batch, draws, masks)
                if name == "plain":
                    again = []
                elif cfg.use_resnet:  # each resblock's two norms again
                    again = [(b, (h // 4, w // 4, 4 * NGF), act, extra // 2)
                             for act in ("relu", None)]
                else:  # the U-Net's 15, once each
                    again = unet_sites(b, h, w)
                want = {"fwd": planned(sites + again, "fwd"),
                        "bwd": planned(sites, "bwd")}
                per = sum(c for *_, c in sites)
                ms = cuda_ms(lambda c=c: step_grads_once(
                    c, state, batch, draws, masks), 3, warmup=1)
                res[name] = {"out": got, "k1": counts, "routes": routes,
                             "peak_gib": peak, "ms": ms}
                print(f"  [{card}] {label} {name}: K1 forward "
                      f"{counts['fwd']}, backward {counts['bwd']} by route "
                      f"{routes} (planned {want}); peak {peak:.2f} GiB; "
                      f"forward + backward {ms:.3f} ms")
                need(counts == {"fwd": per + (extra if name == "remat"
                                              else 0), "bwd": per}
                     and routes == want,
                     f"{label} {name}: K1's calls left their count or "
                     "their planned routes")
            (la, ga, da), (lb, gb, db) = (res["plain"]["out"],
                                          res["remat"]["out"])
            bad = [k for k in ga if not torch.equal(ga[k], gb[k])] + \
                [k for k in da if not torch.equal(da[k], db[k])]
            same = torch.equal(la, lb) and not bad
            print(f"  [{card}] {label}: --remat vs without, losses "
                  f"{la.tolist()} {'bitwise equal' if torch.equal(la, lb) else 'DIFFER ' + str(lb.tolist())}; "
                  f"{len(ga) + len(da) - len(bad)} of {len(ga) + len(da)} "
                  f"gradients bitwise equal (differ: {bad[:6]}); peak "
                  f"{res['plain']['peak_gib']:.2f} -> "
                  f"{res['remat']['peak_gib']:.2f} GiB; forward + backward "
                  f"{res['plain']['ms']:.3f} -> {res['remat']['ms']:.3f} ms")
            need(same, f"{label}: --remat changed the losses or gradients")
            out[label] = {
                "bitwise": same, "k1_plain": res["plain"]["k1"],
                "k1_remat": res["remat"]["k1"], "remat_extra_fwd": extra,
                **{f"{k}_{n}": res[n][k] for n in ("plain", "remat")
                   for k in ("peak_gib", "ms")}}
            del state, batch, res, ga, gb, da, db
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def largest_batch(card: str, label: str, cfg, dev, guess: int = 0) -> tuple:
    """The largest batch of ``cfg``'s step that fits on the card.  Given a
    ``guess``, probes there and walks one batch at a time, up while it
    fits and down while it does not, until a batch that fits sits beside
    one that does not (at most MAX_PROBES probes).  Else: probes at
    b=4 and 8, then at the batch where a straight line through their peaks
    reaches LB_FILL of the card's memory, walked up one batch at a time
    while it fits, or one down after it does not, then bisected, at most
    MAX_PROBES probes (the peak grows with the batch in a straight line,
    so the guess is within a batch or two, and the costly probes near
    the limit are few); a probe builds the state and runs two steps, a
    warm-up and the probe's own.  Only ``torch.cuda.OutOfMemoryError`` is
    caught, and only here.  Returns (largest, [(batch, fits, peak
    GiB)])."""
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    probes = []

    def fits(b: int) -> bool:
        c = cfg.replace(batch_size=b)
        state = batch = None
        torch.cuda.reset_peak_memory_stats()
        try:
            state = tstep.init_state(c, torch.Generator().manual_seed(0),
                                     dev)
            batch = device_batch(c, b, dev, seed=5)
            step_fn = tstep.build_step_fn(c)
            draw_gen = torch.Generator().manual_seed(6)
            for _ in range(2):
                state, _ = step_fn(state, batch, 1e-3, tpool.pool_draws(
                    draw_gen, b, c.max_size))
            torch.cuda.synchronize()
            ok = True
        except torch.cuda.OutOfMemoryError:
            ok = False
        del state, batch
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.empty_cache()
        probes.append((b, ok, peak))
        print(f"    {label} b={b}: {'fits' if ok else 'out of memory'} "
              f"(peak {peak:.2f} GiB)")
        return ok

    lo, hi = 0, None
    if guess:
        b = guess
        while len(probes) < MAX_PROBES and b >= 1 and (
                hi is None or hi - lo > 1):
            if fits(b):
                lo, b = b, b + 1
            else:
                hi, b = b, b - 1
        return lo, probes
    for b in LB_FIRST:
        if not fits(b):
            hi = b
            break
        lo = b
    if hi is None:
        (b0, _, p0), (b1, _, p1) = probes[-2:]
        slope = (p1 - p0) / (b1 - b0)
        total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
        b = max(b1 + 1, int((LB_FILL * total - (p0 - slope * b0)) / slope)
                if slope > 0 else 2 * b1)
        while len(probes) < MAX_PROBES and hi is None:
            if fits(b):
                lo, b = b, b + 1
            else:
                hi = b
        if hi is not None and hi - 1 > lo and len(probes) < MAX_PROBES:
            if fits(hi - 1):
                lo = hi - 1
            else:
                hi -= 1
    while hi is not None and hi - lo > 1 and len(probes) < MAX_PROBES:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo, probes


def remat_phase(card: str, dev) -> dict:
    """Phase 32.  ``--remat``: the step cells (``remat_step_cells``), then
    the largest batch that fits for the ResNet sggan step at 2048x1024
    and the ResNet cycle step at 512x1024, with and without it."""
    out = {"steps": remat_step_cells(card, dev), "largest_batch": {}}
    sggan = remat_cells()["sggan_resnet_b16"][0]
    for label, cfg in (
            ("sggan_resnet_2048x1024",
             sggan.replace(image_height=1024, image_width=2048)),
            ("cycle_resnet_512x1024",
             cycle_cfg(1).replace(image_height=512, image_width=1024))):
        res = {}
        for name, c in (("plain", cfg), ("remat", cfg.replace(remat=True))):
            res[name], probes = largest_batch(card, f"{label} {name}", c,
                                              dev, LB_GUESS[label][name])
            res[f"{name}_probes"] = probes
        print(f"  [{card}] {label}: the largest batch that fits, without "
              f"--remat {res['plain']}, with it {res['remat']}")
        need(res["plain"] >= 1 and res["remat"] >= res["plain"],
             f"{label}: --remat's largest batch {res['remat']} is below "
             f"{res['plain']}, or a batch of 1 does not fit")
        out["largest_batch"][label] = res
    return out


def forms_phases(card: str, dev) -> dict:
    """Phases 30-32 in one process, the f32 twins with TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("30 the reflect layers: the pad's Function and the pad-free "
          "reflect conv against their plain twins; both forms timed")
    out = {"reflect": reflect_phase(card, dev)}
    phase("31 the head: cuDNN's conv beside the space-to-depth forms; the "
          "generator under each --pad_free_head")
    out["head"] = head_phase(card, dev)
    phase("32 --remat (main path): bitwise against the step without it, "
          "K1's exact counts, peak memory, the largest batch")
    out["remat"] = remat_phase(card, dev)
    return out


# ----------------------------------------------------------------------
# --compat_fake_history, --eval_crf, the memory probe and the recon eval
# (phases 33-35)
# ----------------------------------------------------------------------

# (h, w, b) of phase 33's step cells, b the batch doubled by augmentation:
# the default config (a history of 11) and 256x512 b=4 doubled (17)
HIST_CELLS = ((128, 128, UNET_B), (256, 512, 8))
HIST_STEPS = 12
HIST_CLI_TRAIN, HIST_CLI_EPOCHS, HIST_CLI_K = 48, 2, 4
CRF_SMALL, CRF_BIG = (128, 128, 3), (512, 1024, 34)  # (H, W, classes)
CRF_TIMER = r"""
import json, sys, time
import numpy as np
from sggan_tpu_torch.metrics import crf
h, w, c = map(int, sys.argv[1:4])
t0 = time.perf_counter()
crf._lib()
build_s = time.perf_counter() - t0
rng = np.random.default_rng(0)
probs = np.ascontiguousarray(rng.dirichlet(np.ones(c), (h, w)).astype(
    np.float32).transpose(2, 0, 1))
img = rng.integers(0, 256, (h, w, 3), np.uint8)
t0 = time.perf_counter()
q = crf.dense_crf(img, probs)
ms = 1e3 * (time.perf_counter() - t0)
print(json.dumps({"hw": [h, w], "classes": c, "ms_per_image": ms,
                  "finite": bool(np.isfinite(q).all()),
                  "library_wait_s": build_s}))
"""


def hist_counts(b: int, n: int, count: int = 0) -> list:
    """The history's count after each of ``n`` steps of ``b`` fakes from
    ``count``: it grows by ``b`` until it reaches 10, then starts again
    (sggan_tpu/train/step.py:196-201)."""
    out = []
    for _ in range(n):
        count = (0 if count >= 10 else count) + b
        out.append(count)
    return out


def hist_step_sites(b: int, h: int, w: int) -> list:
    """Every instance norm of one ``--compat_fake_history`` step with the
    U-Net at batch ``b``: the generator's 15, the discriminator's over the
    history (N = 9 + b) in the generator loss and over [seg; history]
    (N = b + 9 + b) in the discriminator loss."""
    k = 9 + b
    ds = d_sites(h, w)
    return (unet_sites(b, h, w) + [(k, hwc, act, 1) for hwc, act in ds]
            + [(b + k, hwc, act, 1) for hwc, act in ds])


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it: its model name, or where a
    sandbox hides that, its vendor, family, model and clock; with the
    logical CPUs."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break  # the first processor's fields
            key, _, val = line.partition(":")
            info[key.strip()] = val.strip()
    name = info.get("model name", "")
    if name in ("", "unknown"):
        name = (f"{info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')}"
                f" at {info.get('cpu MHz', '?')} MHz (model name hidden)")
    return f"{name}, {os.cpu_count()} logical CPUs"


def crf_timer_start(hwc) -> subprocess.Popen:
    """The native CRF on one seeded image of ``hwc`` in a process of its
    own (host only: it runs beside the card's phases)."""
    return subprocess.Popen([sys.executable, "-c", CRF_TIMER,
                             *map(str, hwc)], cwd=REPO, env=repo_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def crf_timer_result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    if proc.returncode:
        print(err[-4000:], file=sys.stderr)
        raise AssertionError("the native CRF's timing run failed")
    return json.loads(out.strip().splitlines()[-1])


def hist_phase(card: str, dev) -> dict:
    """Phase 33, in phase 29's fresh process: ``--compat_fake_history``.
    Both K1 kernels against their plain twins at the discriminator's
    sites over the history and over [seg; history] (N = 11, 13 at
    128x128; 17, 25 at 256x512), f32 and bf16, each call on its planned
    route, the forward's output of its own moments (``k1_vs_plain``'s
    ``own_moments``); the f32 history step card against CPU at 32x64
    with a history of 6 earlier fakes (``unet_card_vs_cpu``); the bf16
    step cells of HIST_CELLS (``unet_step_cell`` with the history); then
    the trainer's loop over a resident split of the default config with
    the flag, eager against the step's graph, bitwise
    (``step_graph_gate``), and both timed (``loop_timing``)."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.ops import cuda_in
    phase("33 --compat_fake_history (main path): K1 at the history's "
          "sites, the step card vs CPU, the step cells, eager vs the "
          "step's graph")
    errs = {"float32": 0.0, "bfloat16": 0.0}
    bwd_errs = dict(errs)
    sites = list(dict.fromkeys(
        (n, hwc, act) for h, w, b in HIST_CELLS
        for n, hwc, act, _ in hist_step_sites(b, h, w) if n != b))
    for dtype in (torch.float32, torch.bfloat16):
        for i, (n, (h, w, c), act) in enumerate(sites):
            p = {d: cuda_in.plan(n, h, w, c, dtype, d)
                 for d in ("fwd", "bwd")}
            reset_k1()
            f_err, b_err = k1_vs_plain(n, (h, w, c), act, dtype, dev,
                                       seed=330 + i, own_moments=True)
            _, routes = read_k1()
            need(routes == {d: {p[d].route: 2} for d in ("fwd", "bwd")},
                 f"K1 calls left their planned route: {routes}, plan {p}")
            name = str(dtype)[6:]
            errs[name] = max(errs[name], f_err)
            bwd_errs[name] = max(bwd_errs[name], b_err)
        torch.cuda.empty_cache()
    print(f"  K1 held to its plain twins on its planned routes at "
          f"{len(sites)} history sites (N = "
          f"{sorted({n for n, *_ in sites})}) x 2 dtypes")
    small = Config(image_height=32, image_width=64, ngf=4, ndf=4,
                   segment_class=8, batch_size=1, compute_dtype="float32",
                   compat_fake_history=True)
    parity = unet_card_vs_cpu(small, dev)
    cells = {}
    for h, w, b in HIST_CELLS:
        cells[f"{h}x{w}"] = unet_step_cell(card, dev, h, w, b, HIST_STEPS,
                                           hist=True)
        torch.cuda.empty_cache()
    cfg = Config(compat_fake_history=True, save_freq=0, print_freq=1000,
                 data_seed=33)
    tr, ds = graph_trainer(cfg, dev, GRAPH_STEPS)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gate = step_graph_gate(card, "hist_unet_b2", tr, ds,
                               hist_step_sites(UNET_B, 128, 128))
    finally:
        torch.backends.cudnn.deterministic = det
    timing = loop_timing(card, "hist_unet_b2", tr, ds)
    return {"k1_max_abs_err": {"fwd": errs, "bwd": bwd_errs},
            "f32_card_vs_cpu": parity, "step": cells, "graph": gate,
            "timing": timing}


def hist_cli_phase(card: str, dev, work: str, root: str, crf_big,
                   graphs: dict) -> dict:
    """Phase 34.  ``python -m sggan_tpu_torch.main --compat_fake_history
    --eval_crf --scan_steps 4`` with no net or loss flag on phase 20's PNG
    set: train HIST_CLI_EPOCHS epochs (through the step's graph, finite
    losses, the saved history's count that of the JAX step), then resume
    for one epoch (the count continues); the eval of the checkpoint
    in-process, each fake refined with the CRF; the CRF library held to
    the numpy mean field at 16x16 and timed on the host (``crf_big``: the
    512x1024x34 image's process, started before phase 29); the MFU of
    phase 29's graph steps."""
    from sggan_tpu_torch.config import parse_args
    from sggan_tpu_torch.metrics import crf
    from sggan_tpu_torch.train import evaluate
    from sggan_tpu_torch.train.trainer import Trainer
    from sggan_tpu_torch.utils import checkpoint as ckpt
    from sggan_tpu_torch.utils import flops
    args = ["--dataset_dir", root, "--train_size", str(HIST_CLI_TRAIN),
            "--print_freq", "1000", "--data_seed", "34",
            "--compat_fake_history", "--eval_crf", "--scan_steps",
            str(HIST_CLI_K)]
    run_dir = os.path.join(work, "hist_cli")
    os.makedirs(run_dir)
    ck = os.path.join(run_dir, "checkpoint", "city")

    def saved(epoch: int) -> dict:
        return torch.load(os.path.join(ck, "train", f"cp-{epoch:04d}.pt"),
                          weights_only=True)

    out, dt = run_cli(run_dir, f"--compat_fake_history --eval_crf "
                      f"--scan_steps {HIST_CLI_K}, train {HIST_CLI_EPOCHS} "
                      "epochs", ["--phase", "train", "--epoch",
                                 str(HIST_CLI_EPOCHS), *args])
    need(" [*] training split resident" in out,
         "the history run did not take the resident split")
    per = sum(c for *_, c in hist_step_sites(UNET_B, 128, 128))
    need_captured(out, per, HIST_CLI_K)
    losses = [(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"Gen_Loss: (\S+) Disc_Loss: (\S+)", out)]
    need(len(losses) == HIST_CLI_EPOCHS
         and all(math.isfinite(v) for p in losses for v in p),
         f"losses not finite at every print: {losses}")
    n = HIST_CLI_EPOCHS * HIST_CLI_TRAIN
    first = saved(HIST_CLI_EPOCHS - 1)
    need(first["step"] == n
         and first["pool_count"] == hist_counts(UNET_B, n)[-1]
         and first["pool_buffer"]["fake"].shape == (9 + UNET_B, 128, 128, 3),
         f"the checkpoint's history: step {first['step']}, count "
         f"{first['pool_count']}, not {n} and {hist_counts(UNET_B, n)[-1]}")
    out, dt_resume = run_cli(run_dir, "resume for 1 epoch",
                             ["--phase", "train", "--continue_train",
                              "--epoch", "1", *args])
    again = saved(HIST_CLI_EPOCHS)
    want = hist_counts(UNET_B, n + HIST_CLI_TRAIN)[-1]
    print(f"  the history's count: {first['pool_count']} after {n} steps, "
          f"{again['pool_count']} after the resume's {HIST_CLI_TRAIN} "
          f"(continued: {want}; started again: "
          f"{hist_counts(UNET_B, HIST_CLI_TRAIN)[-1]})")
    need(" [*] Load SUCCESS" in out and again["step"] == n + HIST_CLI_TRAIN
         and again["pool_count"] == want,
         "--continue_train did not continue the history's count")

    # the eval of the checkpoint, in-process: every fake refined
    own = os.path.join(work, "hist_eval")
    cfg = parse_args(["--phase", "test", *args,
                      *(x for d in ("checkpoint", "test", "sample", "log")
                        for x in (f"--{d}_dir", os.path.join(
                            run_dir if d == "checkpoint" else own, d)))])
    tr = Trainer(cfg, device=dev)
    tr.state = ckpt.load(tr.state, cfg.checkpoint_dir, cfg.dataset_dir)
    calls = []
    plain_crf = evaluate.dense_crf

    def counted(img, probs):
        calls.append(probs.shape)
        return plain_crf(img, probs)
    evaluate.dense_crf = counted
    try:
        t0 = time.perf_counter()
        _, score = tr.test_during_train(0)
        eval_s = time.perf_counter() - t0
    finally:
        evaluate.dense_crf = plain_crf
    tr.cfg = cfg.replace(eval_crf=False)
    _, plain = tr.test_during_train(0)
    print(f"  the eval under --eval_crf: {len(calls)} fakes refined "
          f"({calls[:1]}) in {eval_s:.2f} s; Mean IoU {score['Mean IoU']} "
          f"(without the CRF {plain['Mean IoU']}), Overall Acc "
          f"{score['Overall Acc']} ({plain['Overall Acc']})")
    need(len(calls) == E2E_TEST and calls[0] == (3, 128, 128),
         "the eval did not refine every fake with the CRF")
    del tr
    torch.cuda.empty_cache()

    # the library, from native/crf/ into sggan_tpu_torch/_build/
    lib = crf._lib()
    rng = np.random.default_rng(16)
    probs = np.ascontiguousarray(rng.dirichlet(np.ones(3) * 2.0, (16, 16))
                                 .astype(np.float32).transpose(2, 0, 1))
    img = rng.integers(0, 255, (16, 16, 3), np.uint8)
    q_np = crf._mean_field_numpy(np.ascontiguousarray(
        crf.unary_from_softmax(probs).transpose(1, 2, 0)), img, crf.MAX_ITER)
    agree = float((crf.dense_crf(img, probs).argmax(0)
                   == q_np.transpose(2, 0, 1).argmax(0)).mean())
    need(agree > 0.9, f"the native CRF agrees with the numpy mean field on "
                      f"{agree:.3f} of the pixels at 16x16")
    h, w, c = CRF_SMALL
    probs = np.ascontiguousarray(rng.dirichlet(np.ones(c), (h, w)).astype(
        np.float32).transpose(2, 0, 1))
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    crf.dense_crf(img, probs)
    t0 = time.perf_counter()
    for _ in range(5):
        crf.dense_crf(img, probs)
    small_ms = 1e3 * (time.perf_counter() - t0) / 5
    big = crf_timer_result(crf_big)
    need(big["finite"], "the CRF's 512x1024x34 output is not finite")
    cpu = host_cpu()
    print(f"  the native CRF ({os.path.basename(lib._name)}, built from "
          f"native/crf/): agrees with the numpy mean field on {agree:.3f} "
          f"of 16x16; {small_ms:.1f} ms an image at {h}x{w}x{c}, "
          f"{big['ms_per_image']:.1f} ms at "
          f"{'x'.join(map(str, CRF_BIG))}, one host thread of {cpu} "
          f"(host times, beside {card})")

    # MFU of phase 29's graph steps (a loop step, batch assembly included)
    peak = BF16_FLOPS_PER_S
    mfu = {}
    for label, fl in (
            ("sggan_resnet_b16", flops.sggan_train_step(H, W, B_TRAIN, NGF,
                                                        64, N_CLASS)),
            ("cycle_resnet_b8", flops.cycle_train_step(H, W, CYCLE_B, NGF,
                                                       64, N_CLASS))):
        ms = graphs["timing"][label]["graph"]["step_ms"]
        mfu[label] = {"step_flops": fl["step_flops"], "graph_step_ms": ms,
                      "tflops_per_s": fl["step_flops"] / ms / 1e9,
                      "mfu": fl["step_flops"] / (ms * 1e-3) / peak}
        print(f"  [{card}] {label}: {fl['step_flops'] / 1e12:.3f} TFLOP a "
              f"step (utils/flops.py) in {ms:.3f} ms through the graph: "
              f"{mfu[label]['tflops_per_s']:.1f} TFLOP/s, MFU "
              f"{100 * mfu[label]['mfu']:.2f}% of {peak / 1e12:.0f} "
              "TFLOP/s dense bf16")
    return {"cli_train_s": dt, "cli_resume_s": dt_resume,
            "count_after": [first["pool_count"], again["pool_count"]],
            "eval_crf": {"refined": len(calls), "seconds": eval_s,
                         "score": {k: score[k] for k in (
                             "Overall Acc", "Mean IoU")},
                         "without_crf": {k: plain[k] for k in (
                             "Overall Acc", "Mean IoU")}},
            "crf": {"host_cpu": cpu, "threads": 1, "agree_16x16": agree,
                    "ms_per_image": {"x".join(map(str, CRF_SMALL)): small_ms,
                                     "x".join(map(str, CRF_BIG)):
                                     big["ms_per_image"]}},
            "mfu": mfu}


def recon_start(work: str, root: str) -> subprocess.Popen:
    """Phase 35's ``python -m sggan_tpu_torch.cycle_recon_eval`` on phase
    25's checkpoint, trainB as the B side, started beside phase 26 (which
    checks values); its output goes to a file of ``work``."""
    log = open(os.path.join(work, "recon.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "sggan_tpu_torch.cycle_recon_eval",
             os.path.join(work, "cycle_cli"), os.path.join(root, "trainB"),
             "use_resnet=true", f"image_height={H}", f"image_width={W}",
             f"segment_class={N_CLASS}", f"dataset_dir={root}"],
            cwd=work, env=repo_env(), stdout=log, stderr=subprocess.STDOUT,
            text=True)
    finally:
        log.close()


def recon_wait(work: str, proc: subprocess.Popen) -> str:
    """``recon_start``'s process waited for: its output; raises if it
    failed."""
    proc.wait(timeout=600)
    with open(os.path.join(work, "recon.log")) as f:
        out = f.read()
    print(f"  python -m sggan_tpu_torch.cycle_recon_eval, phase 25's "
          f"checkpoint (beside phase 26): exit {proc.returncode}")
    for ln in [x for x in out.strip().splitlines()
               if not x.startswith("Processing image")][-8:]:
        print(f"    | {ln}")
    if proc.returncode:
        raise AssertionError("python -m sggan_tpu_torch.cycle_recon_eval "
                             "failed")
    return out


def probe_recon_phase(card: str, work: str, recon_out: str) -> dict:
    """Phase 35.  ``python -m sggan_tpu_torch.utils.hbm`` in fresh
    processes: the ResNet sggan step at 2048x1024 under ``--remat`` at
    b=2 doubled to 4 must fit (phase 32 finds the largest); at b=64
    doubled to 128 without it must run out of memory, with the bytes of
    torch's message parsed.  Then ``cycle_recon_eval``'s output on phase 25's
    checkpoint (``recon_start``, run beside phase 26): finite scores, both
    strips."""
    base = ["--use_resnet", "--loss_mode", "sggan", "--img_height", "1024",
            "--img_width", "2048", "--segment_class", str(N_CLASS),
            "--probe_kind", "step"]
    probes = {}
    for label, extra in (("fit", ["--remat", "--batch_size", "2",
                                  "--probe_items", "2"]),
                         ("oom", ["--batch_size", "64", "--probe_items",
                                  "64"])):
        out, dt = run_cli(work, f"the memory probe, {label}", base + extra,
                          module="sggan_tpu_torch.utils.hbm")
        res = json.loads(out.strip().splitlines()[-1])
        res["seconds"] = dt
        probes[label] = res
        print(f"  [{card}] probe {label}: fits {res.get('fits')}, peak "
              f"{res.get('total_bytes', 0) / 2 ** 30:.2f} GiB allocated of "
              f"{res.get('device_total_bytes', 0) / 2 ** 30:.2f}"
              + (f"; the OOM's bytes: used {res['oom_used_bytes']}, limit "
                 f"{res['oom_limit_bytes']}, tried "
                 f"{res.get('oom_tried_bytes')}"
                 if "oom_used_bytes" in res else ""))
    fit, oom = probes["fit"], probes["oom"]
    need(fit.get("fits") is True and fit["kind"] == "step"
         and 0 < fit["total_bytes"] <= fit["device_total_bytes"],
         f"the probe of a batch that fits: {fit}")
    need(oom.get("fits") is False and "error" in oom
         and oom.get("oom_limit_bytes", 0) > 0
         and oom.get("oom_used_bytes", 0) > 0,
         f"the probe of a batch that does not fit: {oom}")
    run_dir = os.path.join(work, "cycle_cli")
    line = [ln for ln in recon_out.splitlines() if ln.startswith("RECON ")]
    rec = json.loads(line[0][len("RECON "):]) if line else {}
    strips = [os.path.join(run_dir, "recon", f"{d}_fake_recon.png")
              for d in "ab"]
    print(f"  [{card}] cycle recon on phase 25's checkpoint: {rec}")
    need(rec.keys() >= {"cyc_a_l1", "idt_a_l1", "cyc_b_l1", "idt_b_l1"}
         and all(math.isfinite(v) for v in rec.values())
         and all(os.path.isfile(p) for p in strips),
         "cycle_recon_eval gave no finite scores or no strips")
    return {"probe": probes, "recon": rec}


# ----------------------------------------------------------------------
# Data parallelism, --mesh_data 2 (phase 36)
# ----------------------------------------------------------------------

DP_N, DP_STEPS, DP_SHARD_B, DP_LR = 2, 3, 2, 1e-3
# part 1: phase 8's small size, f32, a shard of 2 (the global batch 4)
DP_SMALL = dict(image_height=32, image_width=64, ngf=4, ndf=4,
                segment_class=8, batch_size=DP_SHARD_B, max_size=2,
                compute_dtype="float32", mesh_data=DP_N)
DP_MODES = {
    "sggan_resnet": dict(loss_mode="sggan", use_resnet=True, gen_ema=0.999),
    "p2p_unet": dict(loss_mode="p2p", use_resnet=False,
                     dropout_mode="intended"),
    "pix2pix": dict(loss_mode="p2p", use_pix2pix=True,
                    dropout_mode="intended"),
    "cycle_resnet": dict(loss_mode="cycle", use_resnet=True, use_lsgan=True,
                         identity_lambda=5.0, Lg_lambda=5.0),
}
# part 2: the ResNet sggan CLI at full width, 8 files a step doubled to 16
# (8 a rank), on phase 16's PNG set
DP_CLI_B, DP_CLI_TRAIN = 8, 32
DP_CLI_ARGS = ["--batch_size", str(DP_CLI_B), "--use_augmentation",
               "--img_height", str(H), "--img_width", str(W),
               "--loss_mode", "sggan", "--use_resnet", "--segment_class",
               str(N_CLASS), "--compute_dtype", "bfloat16", "--max_size",
               "50", "--data_seed", "19", "--save_freq", "0",
               "--print_freq", "1", "--host_downscale", "2",
               "--train_size", str(DP_CLI_TRAIN), "--epoch", "1"]
# the p2p ResNet in f32 at 128x256, 4 files a step doubled to 8 (4 a
# rank), on both paths: no pool and no batch norm, so the mean of the
# shards' means is the batch's, and the resident epoch's loss is held to
# the host iterator's at DP_LOSS_REL over 2 steps, with cuDNN
# deterministic (its atomics' run-to-run noise grows through Adam's
# sign-like first updates); on a set of DP_P2P_TRAIN triplets
# (``dp_p2p_dataset``), since the host iterator cuts --train_size after
# its shuffle and the resident split before it, in both packages
DP_P2P_B, DP_P2P_TRAIN, DP_LOSS_REL = 4, 8, 1e-4
DP_P2P_ARGS = ["--batch_size", str(DP_P2P_B), "--use_augmentation",
               "--img_height", str(H // 2), "--img_width", str(W // 2),
               "--loss_mode", "p2p", "--use_resnet", "--segment_class",
               str(N_CLASS), "--compute_dtype", "float32", "--data_seed",
               "19", "--save_freq", "0", "--print_freq", "1",
               "--host_downscale", "2", "--epoch", "1"]
HOST_PATH = ["--device_dataset_mb", "0"]
# part 2's runs: (flags, run directory, steps, dataset); "resident" is
# the CLI's defaults (the split resident on each rank, --scan_steps 8)
DP_STEPS_CLI = DP_CLI_TRAIN // DP_CLI_B
DP_STEPS_P2P = DP_P2P_TRAIN // DP_P2P_B
DP_RUNS = {"resident": (DP_CLI_ARGS, "dp_cli", DP_STEPS_CLI, "city"),
           "host": (DP_CLI_ARGS + HOST_PATH, "dp_host", DP_STEPS_CLI,
                    "city"),
           "p2p": (DP_P2P_ARGS, "dp_p2p", DP_STEPS_P2P, "p2p"),
           "p2p_host": (DP_P2P_ARGS + HOST_PATH, "dp_p2p_host",
                        DP_STEPS_P2P, "p2p")}
DP_CHILD = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.dp_rank(*sys.argv[1:]))")
NCCL_CHILD = ("import sys, chip_smoke; "
              "sys.exit(chip_smoke.nccl_try())")


def dp_start(job: str, *args: str, child: str = DP_CHILD,
             env_extra=None, world: int = DP_N, nccl: bool = False) -> list:
    """``job`` as ``world`` ranks in processes of their own, each with the
    environment torchrun gives a rank and ``LOCAL_RANK=0``: the ranks
    share the one card (with ``nccl``, ``LOCAL_RANK`` its rank: a card
    each).  Returns the processes."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = []
    for r in range(world):
        env = dict(repo_env(), RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r) if nccl else "0",
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=port, **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", child, job, *args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def dp_wait(procs: list, label: str, timeout: int,
            check: bool = True) -> list:
    """The ranks' (exit code, stdout, stderr), each rank's output shown
    (its last lines); raises if one failed, with ``check``."""
    t0 = time.perf_counter()
    outs = []
    for p in procs:
        left = max(1.0, timeout - (time.perf_counter() - t0))
        try:
            out, err = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            err += f"\n(killed after {timeout} s)"
        outs.append((p.returncode, out, err))
    print(f"  {label}: {len(procs)} process{'es' * (len(procs) > 1)}, "
          f"exit {[o[0] for o in outs]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for r, (rc, out, err) in enumerate(outs):
        for ln in out.strip().splitlines()[-6:]:
            print(f"    rank {r} | {ln[:200]}")
        if rc and check:
            print(err[-4000:], file=sys.stderr)
    if check and any(o[0] for o in outs):
        raise AssertionError(f"{label}: a rank failed")
    return outs


def dp_rank(job: str, work: str, *args: str) -> int:
    """One rank of phase 36: joins the gloo group on ``cuda:0`` (NCCL
    refuses two ranks on one card) before ``main``, whose own call is
    then a no-op, runs ``job`` and prints its numbers as the last line,
    after a line naming any JAX module it imported."""
    import torch.distributed as dist

    from sggan_tpu_torch.parallel import distributed
    distributed.initialize(backend="gloo")
    dev = distributed.device("cuda")
    try:
        res = {"parity": dp_parity_rank, "cli": dp_cli_rank}[job](
            work, dev, *args)
    finally:
        dist.barrier()
        distributed.shutdown()
    banned = sorted(m for m in sys.modules if m in ("jax", "sggan_tpu")
                    or m.startswith(("jax.", "sggan_tpu.")))
    print(f"imported JAX modules: {banned}")
    print(json.dumps(res), flush=True)
    return 1 if banned else 0


def dp_batches(cfg) -> list:
    """The global batches of part 1 (both shards), on the host."""
    make = cycle_batch if cfg.loss_mode == "cycle" else train_batch
    return [make(cfg, DP_N * DP_SHARD_B, "cpu", seed=40 + t)
            for t in range(DP_STEPS)]


def dp_cpu_state(st) -> dict:
    from sggan_tpu_torch.train.step import state_tensors
    out = {k: v.detach().cpu().clone() for k, v in state_tensors(st).items()}
    out["pool.count"] = torch.tensor(st.pool.count)
    return out


def dp_parity_rank(work: str, dev) -> dict:
    """Part 1 in one rank: every mode's DP_STEPS data-parallel steps on
    this rank's shard, with the draws of ``parallel.dp.own_shard`` from
    generators the ranks share; saves the state before and after each
    step, the losses and K1's calls a step."""
    import torch.distributed as dist

    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.parallel import dp
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    group, r, b = dist.group.WORLD, dist.get_rank(), DP_SHARD_B
    out = {}
    for mode, kw in DP_MODES.items():
        cfg = Config(**DP_SMALL, **kw)
        st = tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)
        dp.broadcast_state(st, group)
        step_fn = tstep.build_step_fn(cfg)
        pool_gen = torch.Generator().manual_seed(11)
        mask_gen = torch.Generator().manual_seed(12)
        rec = {"states": [dp_cpu_state(st)], "losses": [], "k1": []}
        for batch in dp_batches(cfg):
            shard = to_dev({k: v[r * b:(r + 1) * b]
                            for k, v in batch.items()}, dev)
            draws = dp.own_shard(lambda: tpool.pool_draws(
                pool_gen, b, cfg.max_size), group)
            masks = to_dev(dp.own_shard(lambda: tstep.dropout_masks(
                cfg, st.gen_params, mask_gen, b), group), dev)
            reset_k1()
            st, m = step_fn(st, shard, DP_LR, draws, masks)
            counts, _ = read_k1()
            rec["k1"].append([counts["fwd"], counts["bwd"]])
            rec["losses"].append({k: v.item() for k, v in m.items()})
            rec["states"].append(dp_cpu_state(st))
        torch.save(rec, os.path.join(work, f"dp_{mode}_rank{r}.pt"))
        out[mode] = {"losses": rec["losses"], "k1_per_step": rec["k1"]}
    return out


def dp_parity_check(card: str, dev, work: str) -> dict:
    """Part 1 held: for each mode and step, one process on the card
    computes both shards' losses and gradients from the state rank 0
    started the step from (each shard with its rank's pool rows) and the
    same draws, and averages them; the ranks' losses at rel 1e-4, their
    gradients (from Adam's first moments: g = (mu_t - b1 mu_(t-1)) / (1 -
    b1)) within 1e-3 of each tensor's largest (phase 8's limits at this
    size), K1's calls a step those of one shard's step, and the two ranks'
    parameters, Adam moments and counts, EMA and BN stats bitwise equal
    after every step."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import cycle as tcycle
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    b = DP_SHARD_B
    res = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for mode, kw in DP_MODES.items():
            cfg = Config(**{**DP_SMALL, **kw, "mesh_data": 1})
            cycle = cfg.loss_mode == "cycle"
            mod = tcycle if cycle else tstep
            ranks = [torch.load(os.path.join(work, f"dp_{mode}_rank{r}.pt"))
                     for r in range(DP_N)]
            st = tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)
            names = tstep.state_tensors(st)
            pool_gen = torch.Generator().manual_seed(11)
            mask_gen = torch.Generator().manual_seed(12)
            worst_loss = worst_grad = 0.0
            k1_ref = []
            for t, batch in enumerate(dp_batches(cfg)):
                before = [rk["states"][t] for rk in ranks]
                with torch.no_grad():  # the step's start: rank 0's state
                    for k, v in names.items():
                        if not k.startswith("pool."):
                            v.copy_(before[0][k])
                draws = [tpool.pool_draws(pool_gen, b, cfg.max_size)
                         for _ in range(DP_N)]
                masks = [tstep.dropout_masks(cfg, st.gen_params, mask_gen, b)
                         for _ in range(DP_N)]
                outs = []
                for s in range(DP_N):
                    pool = tpool.PoolState(
                        {k[5:]: v.to(dev) for k, v in before[s].items()
                         if k.startswith("pool.") and k != "pool.count"},
                        int(before[s]["pool.count"]))
                    shard = to_dev({k: v[s * b:(s + 1) * b]
                                    for k, v in batch.items()}, dev)
                    reset_k1()
                    outs.append(mod.losses_and_grads(
                        cfg, st._replace(pool=pool), shard, draws[s],
                        to_dev(masks[s], dev)))
                    if s == 0:
                        counts, _ = read_k1()
                        k1_ref.append([counts["fwd"], counts["bwd"]])
                for k in outs[0][0]:
                    want = sum(o[0][k].item() for o in outs) / DP_N
                    got = ranks[0]["losses"][t][k]
                    worst_loss = max(worst_loss, abs(got - want) / abs(want))
                for i, o in ((1, "g"), (2, "d")):
                    for k in outs[0][i]:
                        want = sum(x[i][k] for x in outs).cpu() / DP_N
                        mu = ranks[0]["states"][t + 1][f"{o}_opt.mu.{k}"]
                        mu0 = before[0][f"{o}_opt.mu.{k}"]
                        got = (mu - cfg.beta1 * mu0) / (1 - cfg.beta1)
                        if want.any():
                            worst_grad = max(worst_grad, (
                                (got - want).abs().max()
                                / want.abs().max()).item())
                after = [rk["states"][t + 1] for rk in ranks]
                for k, v in after[0].items():
                    if not k.startswith("pool.") and \
                            not torch.equal(v, after[1][k]):
                        raise AssertionError(
                            f"dp {mode} step {t}: the ranks' {k} differ")
            k1_ranks = [rk["k1"] for rk in ranks]
            print(f"  [{card}] dp {mode}: losses max rel diff "
                  f"{worst_loss:.3g} (limit 1e-4), gradients max |diff| / "
                  f"max |g| {worst_grad:.3g} (limit 1e-3) against one "
                  f"process averaging both shards; K1 calls a step per "
                  f"rank {k1_ranks[0]} (one shard's step {k1_ref}); "
                  "replicas bitwise equal")
            need(worst_loss <= 1e-4 and worst_grad <= 1e-3,
                 f"dp {mode}: the ranks disagree with both shards' mean")
            need(all(k == k1_ref for k in k1_ranks),
                 f"dp {mode}: K1's calls a step per rank {k1_ranks}, one "
                 f"shard's {k1_ref}")
            res[mode] = {"loss_max_rel": worst_loss,
                         "grad_max_rel": worst_grad,
                         "k1_per_rank_per_step": k1_ref[0],
                         "losses": ranks[0]["losses"]}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return res


def dp_cli_rank(work: str, dev, resume: str = "0",
                runs: str = "resident") -> dict:
    """Part 2 in one rank: the runs of ``DP_RUNS`` named in ``runs``
    (comma-separated) one after the other in this process, each
    ``dp_cli_run``'s, the "resident" one resumed with ``resume`` "1":
    {run: its numbers}."""
    import gc
    out = {}
    for name in runs.split(","):
        out[name] = dp_cli_run(work, dev, name,
                               resume == "1" and name == "resident")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dp_cli_run(work: str, dev, name: str, resume: bool) -> dict:
    """``sggan_tpu_torch.main`` trains (or resumes) part 2's run ``name``
    over the ranks, the sggan runs with a profiler window of 2 steps, the
    p2p runs with cuDNN deterministic; returns this rank's losses, K1's
    calls, the step and the window's numbers."""
    from sggan_tpu_torch import main as tmain
    from sggan_tpu_torch.parallel import dp
    from sggan_tpu_torch.train.trainer import Trainer

    r = torch.distributed.get_rank()
    args, sub, steps, data = DP_RUNS[name]
    run = os.path.join(work, sub)
    argv = ["--phase", "train", "--mesh_data", str(DP_N), *args,
            "--dataset_dir", os.path.join(work, "datasets", data),
            "--checkpoint_dir", os.path.join(run, "checkpoint"),
            *(x for d in ("test", "sample", "log")
              + (() if name.startswith("p2p") else ("profile",))
              for x in (f"--{d}_dir", os.path.join(run, f"{d}{r}")))]
    if resume:
        argv.append("--continue_train")
    runs, losses = [], []
    train = Trainer.train

    def kept(self):
        step = self.step_fn

        def kept_losses(*a, **k):  # device scalars: no sync a step
            state, m = step(*a, **k)
            losses.append(m["gen_loss"])
            return state, m
        self.step_fn = kept_losses
        runs.append((self, train(self)))
        return runs[-1][1]
    Trainer.train = kept
    reset_k1()
    before = dp.bytes_reduced, dp.reductions
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = name.startswith("p2p")
    t0 = time.perf_counter()
    try:
        tmain.main(argv)
    finally:
        Trainer.train = train
        torch.backends.cudnn.deterministic = det
    wall = time.perf_counter() - t0
    counts, routes = read_k1()
    tr, last = runs[-1]
    win = tr._prof
    out = {"rank": r, "step": tr.state.step, "gen_loss": last["gen_loss"],
           "step_losses": [float(x) for x in losses],
           "k1": counts, "k1_routes": routes, "seconds": wall,
           "bytes_reduced_per_step": (dp.bytes_reduced - before[0]) // steps,
           "all_reduces_per_step": (dp.reductions - before[1]) / steps}
    if win is not None and win.steps:
        wall_ms = 1e3 * win.seconds / win.steps
        busy = sum(k[0] for k in kernel_times(win.prof, win.steps))
        comm = range_ms(win.prof, ("dp.all_reduce",), win.steps)
        out.update(step_ms=wall_ms, busy_ms=busy,
                   idle_share=1 - busy / wall_ms,
                   all_reduce_ms=comm.get("dp.all_reduce"),
                   window_steps=win.steps)
    if name == "resident" and not resume:
        out["all_reduce_alone"] = dp_all_reduce_alone(tr, dev)
    return out


def dp_all_reduce_alone(tr, dev) -> dict:
    """Each net's bucket (its gradients, BN stats and loss, f32) all-reduced
    by itself over the ranks with the card idle before it: the median ms of
    5 after a warm-up, by host clock around a device synchronisation."""
    import torch.distributed as dist

    from sggan_tpu_torch.parallel.dp import bn_leaves
    st, out = tr.state, {}
    for name, net, bn in (("gen", st.gen_params, st.gen_bn),
                          ("disc", st.disc_params, st.disc_bn)):
        n = sum(p.numel() for p in net.parameters()) + sum(
            t.numel() for t in bn_leaves(bn)) + 1
        x = torch.zeros(n, device=dev)
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        out[name] = {"bytes": 4 * n, "ms": float(np.median(ms[1:]))}
    return out


def nccl_try() -> int:
    """One rank of the NCCL attempt: two ranks on one card, one
    all-reduce; prints the outcome either way."""
    from sggan_tpu_torch.parallel import distributed
    try:
        distributed.initialize(backend="nccl", timeout_s=60)
        x = torch.ones(4, device=distributed.device("cuda"))
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        print(f"NCCL all_reduce gave {x.tolist()}", flush=True)
    except Exception as e:  # the outcome is the finding
        print(f"NCCL refused: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:300]}", flush=True)
    finally:
        try:
            distributed.shutdown()
        except Exception as e:
            print(f"NCCL shutdown: {type(e).__name__}", flush=True)
    return 0


def dp_train(card: str, dev, work: str, e2e: dict) -> dict:
    """Phase 36, part 2 (main path): the full-width ResNet sggan CLI over
    two gloo ranks sharing the card, alone on it, at the CLI's defaults
    (each rank on the split resident on its card, ``--scan_steps 8``),
    then the same run on the host iterator in the same processes (each
    rank's step is timed on both): equal finite losses, each rank's
    resident line, K1's calls a step per rank, only rank 0 printing and
    writing, the checkpoint with both ranks' pool rows."""
    from sggan_tpu_torch.utils.summary import read_scalars

    run = os.path.join(work, "dp_cli")
    steps = DP_STEPS_CLI
    outs = dp_wait(dp_start("cli", work, "0", "resident,host"),
                   "train 1 epoch over 2 gloo ranks (python -m "
                   "sggan_tpu_torch.main --mesh_data 2) on the resident "
                   "split, then on the host iterator", 600)
    both = [json.loads(o[1].strip().splitlines()[-1]) for o in outs]
    res, host = [x["resident"] for x in both], [x["host"] for x in both]
    for o in outs:
        need("imported JAX modules: []" in o[1], "a dp rank imported JAX")
    for r, o in enumerate(outs):
        need(f" [*] training split resident on device on rank {r} ("
             in o[1], f"rank {r} did not hold the split on its card")
    need("from the split resident on each rank's card; --scan_steps 8: "
         "chunks of 8 eager steps" in outs[0][1]
         and "from the host iterator (the split is not resident: "
         "--device_dataset_mb 0)" in outs[0][1],
         "the coordinator did not print each run's path")
    for xs in (res, host):
        losses = [x["gen_loss"] for x in xs]
        need(math.isfinite(losses[0]) and losses[0] == losses[1],
             f"the ranks' epoch losses {losses}")
        need(all(x["step"] == steps for x in xs), "the ranks' steps")
    need(" [*] data parallel over 2 ranks (gloo)" in outs[0][1]
         and "Epoch: [ 0]" in outs[0][1] and "Epoch:" not in outs[1][1],
         "only the coordinator prints the run's lines")
    ck = os.path.join(run, "checkpoint", "city")
    saved = torch.load(os.path.join(ck, "train", "cp-0000.pt"),
                       weights_only=True)
    need(saved["step"] == steps and saved["pool_buffer"]["fake"].shape[0]
         == 50 * DP_N, "the checkpoint's step or pool rows")
    need(all(os.path.isfile(os.path.join(run, "test0", f"s{i:04d}.png"))
             for i in range(E2E_TEST)), "rank 0 wrote no eval PNGs")
    events = glob.glob(os.path.join(run, "log0", "*", "train",
                                    "events.out.tfevents.*"))
    need(len(events) == 1 and "Mean IoU" in read_scalars(events[0]),
         "rank 0 wrote no tfevents")
    need(not any(os.path.exists(os.path.join(run, f"{d}1"))
                 for d in ("test", "sample", "log")),
         "rank 1 wrote eval PNGs, samples or tfevents")
    eval_fwd = 23 * FWD_GRAPH_CALLS
    for xs in (res, host):
        k1 = [x["k1"] for x in xs]
        need(k1[1] == {"fwd": steps * LAUNCHES_PER_STEP,
                       "bwd": steps * LAUNCHES_PER_STEP}
             and k1[0] == {"fwd": steps * LAUNCHES_PER_STEP + eval_fwd,
                           "bwd": steps * LAUNCHES_PER_STEP},
             f"K1's calls per rank {k1}: {LAUNCHES_PER_STEP} + "
             f"{LAUNCHES_PER_STEP} a step, and the coordinator's eval "
             "capture")
    for x, h in zip(res, host):
        need("step_ms" in x and x["all_reduce_ms"] and "step_ms" in h,
             f"rank {x['rank']}: no profiler window with the all-reduce")
        print(f"  [{card}] rank {x['rank']}, two ranks sharing one card, "
              f"not a scaling number, b={DP_CLI_B} doubled to "
              f"{2 * DP_CLI_B}, {DP_CLI_B} a rank (profiler, "
              f"{x['window_steps']} steps): resident split step "
              f"{x['step_ms']:.3f} ms, device busy {x['busy_ms']:.3f} ms, "
              f"idle {100 * x['idle_share']:.1f}%, dp.all_reduce "
              f"{x['all_reduce_ms']:.3f} ms; host iterator step "
              f"{h['step_ms']:.3f} ms, busy {h['busy_ms']:.3f} ms, idle "
              f"{100 * h['idle_share']:.1f}%, dp.all_reduce "
              f"{h['all_reduce_ms']:.3f} ms (the profiler's range: the "
              "gloo collective through host memory and its wait for the "
              f"backward's kernels); {x['bytes_reduced_per_step']} bytes "
              f"in {x['all_reduces_per_step']:g} all-reduces a step; each "
              f"bucket alone, card idle: {x['all_reduce_alone']}; K1 "
              f"{x['k1']}")
    print(f"  [{card}] beside phase 16's one-process loop step: "
          f"{e2e.get('loop_step_ms')} ms at b={2 * E2E_B} (busy "
          f"{e2e.get('loop_busy_ms')} ms, idle "
          f"{e2e.get('loop_idle_share')})")
    return {"ranks": res, "host_ranks": host,
            "launches_dp": {d: res[1]["k1"][d] // steps
                            for d in ("fwd", "bwd")}}


def dp_p2p_dataset(work: str) -> None:
    """``work``/datasets/p2p: the first DP_P2P_TRAIN train triplets of
    the PNG set and its test split, as symlinks."""
    src = os.path.join(work, "datasets", "city")
    dst = os.path.join(work, "datasets", "p2p")
    for sub in ("", "_seg", "_seg_class"):
        os.makedirs(os.path.join(dst, "trainA" + sub))
        for i in range(DP_P2P_TRAIN):
            os.symlink(os.path.join(src, "trainA" + sub, f"s{i:04d}.png"),
                       os.path.join(dst, "trainA" + sub, f"s{i:04d}.png"))
        os.symlink(os.path.join(src, "testA" + sub),
                   os.path.join(dst, "testA" + sub))


def dp_follow_start(work: str) -> dict:
    """The rest of phase 36, started together beside phase 26 (which
    checks values; none of these is timed): part 1's parity ranks,
    the two-rank ``--continue_train`` of part 2's checkpoint, then in the
    same ranks the p2p ResNet on the resident split and on the host
    iterator, one process's ``--phase test`` of it, and the NCCL
    attempt."""
    run = os.path.join(work, "dp_cli")
    args = [*DP_CLI_ARGS, "--dataset_dir",
            os.path.join(work, "datasets", "city"), "--checkpoint_dir",
            os.path.join(run, "checkpoint"), "--test_dir",
            os.path.join(run, "test_one")]
    dp_p2p_dataset(work)
    return {"parity": dp_start("parity", work),
            "resume": dp_start("cli", work, "1", "resident,p2p,p2p_host"),
            "test": [subprocess.Popen(
                [sys.executable, "-m", "sggan_tpu_torch.main", "--phase",
                 "test", *args], cwd=run, env=repo_env(),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)],
            "nccl": dp_start("", child=NCCL_CHILD,
                             env_extra={"NCCL_DEBUG": "WARN"})}


def dp_follow_check(card: str, dev, work: str, procs: dict) -> dict:
    """Waits for ``dp_follow_start``'s processes and holds them: the
    parity (``dp_parity_check``), the resume at the saved step, the p2p
    ResNet's resident epoch against its host-iterator epoch, the test
    phase's load; prints NCCL's outcome."""
    run = os.path.join(work, "dp_cli")
    steps = DP_STEPS_CLI
    dp_wait(procs["parity"], "part 1, the parity ranks", 600)
    outs = dp_wait(procs["resume"], "--continue_train 1 epoch over 2 gloo "
                   "ranks, then the p2p ResNet on the resident split and "
                   "on the host iterator", 600)
    test = dp_wait(procs["test"], "one process, --phase test of the dp "
                   "checkpoint", 600)
    n_outs = dp_wait(procs["nccl"], "NCCL at world 2 on one card", 120,
                     check=False)
    nccl_said = sorted({ln.strip()[:300] for o in n_outs
                        for ln in (o[1] + o[2]).splitlines()
                        if ln.startswith("NCCL") or "Duplicate GPU" in ln})
    print(f"  NCCL's outcome: {nccl_said}")
    need(" [*] Load SUCCESS" in test[0][1], "--phase test did not load")
    both = [json.loads(o[1].strip().splitlines()[-1]) for o in outs]
    again = [x["resident"] for x in both]
    ck = os.path.join(run, "checkpoint", "city", "train", "cp-0001.pt")
    need(" [*] Load SUCCESS" in outs[0][1]
         and all(x["step"] == 2 * steps for x in again)
         and torch.load(ck, weights_only=True)["step"] == 2 * steps,
         "--continue_train did not resume at the saved step")
    p2p = {k: [x[k] for x in both] for k in ("p2p", "p2p_host")}
    for k, xs in p2p.items():
        need(math.isfinite(xs[0]["gen_loss"])
             and xs[0]["gen_loss"] == xs[1]["gen_loss"]
             and all(x["step"] == DP_STEPS_P2P for x in xs),
             f"{k}: the ranks' epoch losses or steps {xs}")
    got, ref = p2p["p2p"][0]["gen_loss"], p2p["p2p_host"][0]["gen_loss"]
    rel = abs(got - ref) / abs(ref)
    print(f"  [{card}] the p2p ResNet, f32, {H // 2}x{W // 2}, "
          f"b={DP_P2P_B} doubled to {2 * DP_P2P_B}, {DP_STEPS_P2P} steps "
          f"over 2 ranks, cuDNN deterministic: epoch generator loss "
          f"{got!r} on the resident split, {ref!r} on the host iterator, "
          f"rel {rel:.3g} (limit {DP_LOSS_REL:g}); a step's "
          f"{p2p['p2p'][0]['step_losses']} and "
          f"{p2p['p2p_host'][0]['step_losses']}")
    need(rel <= DP_LOSS_REL, "the p2p ResNet's resident epoch loss is off "
         "its host-iterator epoch's")
    return {"parity": dp_parity_check(card, dev, work),
            "resume": again, "nccl": nccl_said,
            "p2p_resident_vs_host": {"gen_loss": [got, ref], "rel": rel,
                                     "ranks": p2p}}


def dp_alone() -> int:
    """Phase 36 by itself (``python -c "import chip_smoke;
    chip_smoke.dp_alone()"``): the build, a PNG set, part 1 and part 2."""
    from sggan_tpu_torch.ops import _build
    card, dev = card_line(), torch.device("cuda")
    print(card)
    _build.build("instance_norm")
    work = os.path.join(REPO, "_smoke")
    shutil.rmtree(work, ignore_errors=True)
    build_dataset(os.path.join(work, "datasets", "city"), DP_CLI_TRAIN)
    phase("36 data parallelism: two gloo ranks on the card")
    res = dp_train(card, dev, work, {})
    res.update(dp_follow_check(card, dev, work, dp_follow_start(work)))
    shutil.rmtree(work)
    print(json.dumps({"dp": res}))
    return 0


# ----------------------------------------------------------------------
# Spatial sharding, --mesh_space (phase 37)
# ----------------------------------------------------------------------

# part 1: the CPU tests' four step cases at 32x64, f32, 2 samples a data
# row, against one process on the whole plane
SP_B_ROW, SP_LR = 2, 1e-3
SP_SMALL = dict(image_height=32, image_width=64, ngf=4, ndf=4,
                segment_class=8, max_size=2, compute_dtype="float32",
                use_lsgan=True, L1_lambda=10.0, Lg_lambda=5.0)
SP_CASES = {
    "resnet_d2s2": dict(loss_mode="sggan", use_resnet=True, gen_ema=0.999,
                        mesh_data=2, mesh_space=2),
    "resnet_s2w2": dict(loss_mode="sggan", use_resnet=True, mesh_space=2,
                        mesh_space_w=2),
    "unet_s2": dict(loss_mode="sggan", use_resnet=False,
                    dropout_mode="intended", mesh_space=2),
    "cycle_s2": dict(loss_mode="cycle", use_resnet=True,
                     identity_lambda=5.0, mesh_space=2),
    # the pix2pix pair: batch norm with the moments across ranks, the
    # plane gathered at depth (the CPU tests' test_torch_spatial_pix2pix*)
    "p2p_s2": dict(loss_mode="p2p", use_pix2pix=True, use_resnet=False,
                   dropout_mode="intended", mesh_space=2),
    "p2p_s2w2": dict(loss_mode="p2p", use_pix2pix=True, use_resnet=False,
                     dropout_mode="intended", mesh_space=2, mesh_space_w=2),
}
SP_LOSS_REL, SP_GRAD_REL = 1e-6, 1e-4
# the new BN states against one process's (its batch norms' two-pass
# variance beside the sharded E[x^2] - mean^2)
SP_BN_TOL = dict(rtol=1e-4, atol=1e-5)
# part 2: the ResNet sggan CLI at full width, 8 files a step doubled to 16
# by augmentation (the CLI's default), each rank their 128 x 512 blocks,
# on phase 16's PNG set; then one step at 512x1024 on a 2 x 2 grid
SP_CLI_B, SP_CLI_TRAIN = 8, 32
SP_CLI_ARGS = ["--batch_size", str(SP_CLI_B), "--img_height", str(H),
               "--img_width", str(W), "--loss_mode", "sggan", "--use_resnet",
               "--segment_class", str(N_CLASS), "--compute_dtype",
               "bfloat16", "--max_size", "50", "--data_seed", "19",
               "--save_freq", "0", "--print_freq", "1", "--host_downscale",
               "2", "--train_size", str(SP_CLI_TRAIN), "--epoch", "1",
               "--mesh_space", "2"]
# and the pix2pix pair in the p2p mode, the same widths and batches, on
# the host iterator (the ResNet sggan run takes the CLI's default, the
# split resident on each rank)
SP_P2P_ARGS = ["--device_dataset_mb", "0",
               "--batch_size", str(SP_CLI_B), "--img_height", str(H),
               "--img_width", str(W), "--use_pix2pix", "--loss_mode", "p2p",
               "--compute_dtype", "bfloat16", "--data_seed", "19",
               "--save_freq", "0", "--print_freq", "1", "--host_downscale",
               "2", "--train_size", str(SP_CLI_TRAIN), "--epoch", "1",
               "--mesh_space", "2"]
SP_WIDE = (512, 1024, 2)  # H, W, b of the 2 x 2 grid's step
SP_CHILD = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.sp_rank(*sys.argv[1:]))")


def sp_cfg(kw: dict, **extra):
    from sggan_tpu_torch.config import Config
    d = kw.get("mesh_data", 1)
    return Config(**{**SP_SMALL, **kw, "batch_size": SP_B_ROW * d,
                     **extra})


def sp_world(kw: dict) -> int:
    return (kw.get("mesh_data", 1) * kw.get("mesh_space", 1)
            * kw.get("mesh_space_w", 1))


def sp_sites(cfg) -> int:
    """K1's sites in one spatial step (each a forward and a backward
    call): the generators' 23 (ResNet) or 15 (U-Net) a call, the patch-
    head D's 3 a call; sggan: one generator call, D in the generator loss
    and over [real; fake]; cycle: 4 generator calls (6 with the identity
    term) and 4 D calls; none for the pix2pix pair (batch norm)."""
    if cfg.use_pix2pix:
        return 0
    g = 23 if cfg.use_resnet else 15
    if cfg.loss_mode == "cycle":
        return (4 + 2 * bool(cfg.identity_lambda)) * g + 4 * 3
    return g + 2 * 3


def sp_reset() -> None:
    from sggan_tpu_torch.ops import cuda_in
    reset_k1()
    cuda_in.sp_launches.update(dict.fromkeys(cuda_in.sp_launches, 0))


def sp_batch(cfg, seed: int) -> dict:
    make = cycle_batch if cfg.loss_mode == "cycle" else train_batch
    return make(cfg, cfg.batch_size, "cpu", seed)


def sp_site_log(sites: list):
    """A context in which every forward of the spatial instance norm
    (``cuda_in.sp_apply``) records its site: (shape, dtype, act, the
    plane's count)."""
    import contextlib

    from sggan_tpu_torch.ops import cuda_in

    @contextlib.contextmanager
    def ctx():
        orig = cuda_in.sp_apply

        def logged(x, sums, gamma, beta, count, eps=1e-3, act=None,
                   alpha=0.3):
            key = (tuple(x.shape), x.dtype, act, count)
            if key not in sites:
                sites.append(key)
            return orig(x, sums, gamma, beta, count, eps, act, alpha)
        cuda_in.sp_apply = logged
        try:
            yield
        finally:
            cuda_in.sp_apply = orig
    return ctx()


def sp_k1_vs_plain(site, grid, dev, seed: int) -> tuple:
    """K1's split passes against their plain twin at one site of this
    rank, the moments summed over the plane's ranks both ways: y, mean and
    rstd, then dx and this shard's dgamma, dbeta fed the kernel's moments;
    phase 7's limits (f32 output ``f32_out_limit``).  Returns the largest
    forward and dx differences; raises outside the limits."""
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.ops import norm as tnorm
    shape, dtype, act, count = site
    x, g, b = site_inputs(shape[0], shape[1:], dtype, dev, seed=seed)
    gd = torch.Generator(device=dev).manual_seed(100 + seed)
    dy = torch.randn(x.shape, generator=gd, device=dev).to(dtype)
    sums = tnorm.moments_all_reduce(cuda_in.sp_stats(x), grid.plane)
    y, mean, rstd = cuda_in.sp_apply(x, sums, g, b, count, 1e-3, act, 0.3)
    ry, rmean, rrstd = tnorm.instance_norm_sp_ref(x, g, b, count,
                                                  grid.plane, 1e-3, act, 0.3)
    d = (y.float() - ry.float()).abs()
    if dtype == torch.float32:
        lim = f32_out_limit(x, g, ry.float(), rmean, rrstd)
    else:
        lim = TOL[dtype] + TOL[dtype] * ry.float().abs()
    n_bad = (int((d > lim).sum())
             + int(((mean - rmean).abs() > 1e-5 + 1e-5 * rmean.abs()).sum())
             + int(((rstd - rrstd).abs() > 1e-5 + 1e-4 * rrstd.abs()).sum()))
    f_err = max(d.max().item(), (mean - rmean).abs().max().item(),
                (rstd - rrstd).abs().max().item())
    sb, dg, db = cuda_in.sp_bwd_stats(x, dy, g, b, mean, rstd, act, 0.3)
    tnorm.moments_all_reduce(sb, grid.plane)
    dx = cuda_in.sp_bwd_apply(x, dy, g, b, mean, rstd, sb, count, act, 0.3)
    rdx, rdg, rdb = tnorm.instance_norm_sp_bwd_ref(
        x, dy, g, b, mean, rstd, count, grid.plane, act, 0.3)
    dd = (dx.float() - rdx.float()).abs()
    if dtype == torch.float32:
        n_bad += int((dd > 1e-5 + 1e-4 * rdx.abs()).sum())
    else:
        n_bad += int(dd.max().item() > 2e-2 * rdx.float().abs().max().item())
    e_g = max((dg - rdg).abs().max().item()
              / max(rdg.abs().max().item(), 1e-30),
              (db - rdb).abs().max().item()
              / max(rdb.abs().max().item(), 1e-30))
    if n_bad or e_g > 1e-4:
        raise AssertionError(f"K1's split passes disagree with the twin at "
                             f"{site}: {n_bad} outside, dgamma/dbeta rel "
                             f"{e_g:.3g}")
    return f_err, dd.max().item(), e_g


def sp_rank(job: str, work: str, *args: str) -> int:
    """One rank of phase 37: joins the group (gloo on the shared card;
    ``SP_BACKEND=nccl`` with a card a rank) before ``main``, runs ``job``
    and prints its numbers as the last line, after a line naming any JAX
    module it imported."""
    import torch.distributed as dist

    from sggan_tpu_torch.parallel import distributed
    distributed.initialize(backend=os.environ.get("SP_BACKEND", "gloo"))
    dev = distributed.device("cuda")
    try:
        res = {"parity": sp_parity_rank, "cli": sp_cli_runs,
               "parity_wide": sp_parity_wide}[job](work, dev, *args)
    finally:
        dist.barrier()
        distributed.shutdown()
    banned = sorted(m for m in sys.modules if m in ("jax", "sggan_tpu")
                    or m.startswith(("jax.", "sggan_tpu.")))
    print(f"imported JAX modules: {banned}")
    print(json.dumps(res), flush=True)
    return 1 if banned else 0


def sp_parity_rank(work: str, dev) -> dict:
    """Part 1 in one rank: each case of this world size, one step on this
    rank's block from the state every rank draws from one seed, with its
    data row's pool draws and its shard's masks; saves the losses, the
    gradients (Adam's first moments over 1 - beta1) and K1's split calls;
    then K1's split passes against the twin at every site the step
    visited."""
    import torch.distributed as dist

    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.parallel import mesh
    from sggan_tpu_torch.parallel.spatial_step import (shard_global,
                                                       sp_dropout_masks)
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    r, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for name, kw in SP_CASES.items():
        if sp_world(kw) != world:
            continue
        cfg = sp_cfg(kw)
        grid = mesh.grid(cfg)
        st = tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)
        step_fn = tstep.build_step_fn(cfg)
        blk = to_dev(shard_global(sp_batch(cfg, 40), grid), dev)
        pool_gen = torch.Generator().manual_seed(11)
        mask_gen = torch.Generator().manual_seed(12)
        draws = grid.own_row(lambda: tpool.pool_draws(
            pool_gen, SP_B_ROW, cfg.max_size))
        masks = to_dev(sp_dropout_masks(cfg, grid, st.gen_params, mask_gen,
                                        SP_B_ROW), dev)
        sites = []
        sp_reset()
        with sp_site_log(sites):
            st, m = step_fn(st, blk, SP_LR, draws, masks)
        counts, _ = read_k1()
        split = dict(cuda_in.sp_launches)
        grads = {f"{o}.{k}": (v / (1 - cfg.beta1)).cpu()
                 for o, opt in (("g", st.g_opt), ("d", st.d_opt))
                 for k, v in opt.mu.items()}
        torch.save({"losses": {k: v.item() for k, v in m.items()},
                    "grads": grads, "split": split, "one_card": counts,
                    "bn": sp_bn(st)},
                   os.path.join(work, f"sp_{name}_rank{r}.pt"))
        errs = [sp_k1_vs_plain(site, grid, dev, seed=370 + 10 * r + i)
                for i, site in enumerate(sites)]
        out[name] = {"split_per_step": split, "one_card": counts,
                     "sites": len(sites)}
        if errs:  # the pix2pix pair has no K1 site
            out[name].update(
                fwd_err=max(e[0] for e in errs),
                dx_err=max(e[1] for e in errs),
                dgb_rel=max(e[2] for e in errs),
                f32_fwd_err=max(e[0] for e, s in zip(errs, sites)
                                if s[1] == torch.float32))
    return out


def sp_bn(st) -> dict:
    """Both nets' BN moving stats of a state by name, on the host ({} for
    the instance-norm nets)."""
    return {f"{n}.{k}.{s}": t.detach().float().cpu()
            for n, bn in (("gen", st.gen_bn), ("disc", st.disc_bn))
            for k, v in bn.items() for s, t in v.items()}


def sp_grid_of(cfg, rank: int):
    """A stand-in ``mesh.Grid`` of ``rank`` in ``cfg``'s layout without
    groups: what a rank's draws read (its place and the sizes)."""
    from sggan_tpu_torch.parallel import mesh
    D, S, Wn = cfg.mesh_data, cfg.mesh_space, cfg.mesh_space_w
    edge = mesh.Axis(None, None, None)
    return mesh.Grid(D, S, Wn, rank, *mesh.coords(rank, S, Wn), None, None,
                     edge, edge, None)


def sp_p2p_masks(cfg, g1, sizes) -> tuple:
    """The pix2pix generator's masks of part 1 on the whole plane: each
    rank's (``sp_dropout_masks`` from the ranks' seed), a block's put
    together where it runs sharded, its data rows' stacked where it runs
    replicated."""
    from sggan_tpu_torch.parallel import mesh
    from sggan_tpu_torch.parallel.spatial_step import sp_dropout_masks
    D, S, Wn = sizes
    ranks = [sp_dropout_masks(cfg, sp_grid_of(cfg, r), g1,
                              torch.Generator().manual_seed(12), SP_B_ROW)
             for r in range(D * S * Wn)]
    out = []
    for i, shape in enumerate(g1.drop_shapes(SP_B_ROW, *cfg.image_size)):
        if tuple(ranks[0][i].shape) == tuple(shape):  # replicated
            out.append(torch.cat([ranks[mesh.rank_of(d, 0, 0, S, Wn)][i]
                                  for d in range(D)]))
        else:
            out.append(torch.from_numpy(sp_assemble(
                [m[i].numpy() for m in ranks], sizes)))
    return tuple(out)


def sp_parity_check(card: str, dev, work: str, ranks: dict) -> dict:
    """Part 1 held: for each case, one process on the card computes the
    step's losses and gradients on the whole plane and the global batch,
    from the same draw of the nets (the patch-head D), a pool of every data
    row's slots filling (so that it passes this step's fakes on, as the
    ranks' do) and the shards' masks put together; the ranks' losses at
    rel 1e-6, their gradients within 1e-4 of each tensor's largest, equal
    on every rank bitwise; K1's split calls a step per rank those of the
    step's sites, its one-card kernels none."""
    from sggan_tpu_torch.ops import dropout_masks
    from sggan_tpu_torch.train import cycle as tcycle
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    res = {}
    for name, kw in SP_CASES.items():
        cfg = sp_cfg(kw)
        one = cfg.replace(mesh_data=1, mesh_space=1, mesh_space_w=1)
        sizes = (cfg.mesh_data, cfg.mesh_space, cfg.mesh_space_w)
        world = sp_world(kw)
        cycle = cfg.loss_mode == "cycle"
        g0 = torch.Generator().manual_seed(0)
        if cycle:
            gen, disc = tcycle.new_cycle_nets(one, g0, head="patch")
            shapes = {"fakes": (2, *one.image_size, 3),
                      "masks": (2, *one.mask_hw, one.segment_class)}
        else:
            gen = tstep.new_generator(one, g0)
            disc = tstep.new_discriminator(one, g0, head="patch")
            shapes = {"fake": (*one.image_size, 3),
                      "mask": (*one.mask_hw, one.segment_class)}
        gen, disc = gen.to(dev), disc.to(dev)
        bn = ({}, {}) if cycle else (gen.init_bn_state(dev),
                                     disc.init_bn_state(dev))
        st = tstep.TrainState(gen, bn[0], disc, bn[1], tstep.adam_init(gen),
                              tstep.adam_init(disc),
                              tpool.pool_init(cfg.max_size * sizes[0],
                                              shapes, torch.float32, dev),
                              0, None)
        batch = to_dev(sp_batch(cfg, 40), dev)
        b = cfg.batch_size
        draws = tpool.pool_draws(torch.Generator().manual_seed(0), b,
                                 cfg.max_size * sizes[0])
        masks = None
        g1 = gen["a2b"] if cycle else gen
        if cfg.use_pix2pix and cfg.dropout_mode != "keras_quirk":
            masks = to_dev(sp_p2p_masks(cfg, g1, sizes), dev)
        elif g1.drop_rate and cfg.dropout_mode != "keras_quirk":
            mask_gen = torch.Generator().manual_seed(12)
            shards = [dropout_masks(mask_gen, g1.drop_shapes(
                SP_B_ROW, cfg.image_height // cfg.mesh_space,
                cfg.image_width // cfg.mesh_space_w), g1.drop_rate)
                for _ in range(world)]
            masks = to_dev(tuple(torch.from_numpy(sp_assemble(
                [s[i].numpy() for s in shards], sizes)) for i in range(3)),
                dev)
        mod = tcycle if cycle else tstep
        one_out = mod.losses_and_grads(one, st, batch, draws, masks)
        m, g_grads, d_grads = one_out[:3]
        saved = [torch.load(os.path.join(work, f"sp_{name}_rank{r}.pt"))
                 for r in range(world)]
        # the new BN states (one data row: the ranks' moments the plane's)
        bn_want = sp_bn(st._replace(gen_bn=one_out[4][0],
                                    disc_bn=one_out[4][1])) \
            if cfg.use_pix2pix else {}
        need(saved[0]["bn"].keys() == bn_want.keys(),
             f"sp {name}: the BN states' names")
        worst_bn = 0.0
        for k, v in bn_want.items():
            d = (saved[0]["bn"][k] - v).abs()
            need(bool((d <= SP_BN_TOL["atol"]
                       + SP_BN_TOL["rtol"] * v.abs()).all()),
                 f"sp {name}: the new BN state {k} against one process")
            worst_bn = max(worst_bn, d.max().item())
            for sv in saved[1:]:
                need(torch.equal(sv["bn"][k], saved[0]["bn"][k]),
                     f"sp {name}: the ranks' BN states {k} differ")
        worst_loss = max(abs(saved[0]["losses"][k] - m[k].item())
                         / abs(m[k].item()) for k in m)
        worst_grad = 0.0
        for o, grads in (("g", g_grads), ("d", d_grads)):
            for k, v in grads.items():
                want = v.detach().cpu()
                got = saved[0]["grads"][f"{o}.{k}"]
                if want.any():
                    worst_grad = max(worst_grad, ((got - want).abs().max()
                                                  / want.abs().max()).item())
        for s in saved[1:]:
            for k, v in s["grads"].items():
                need(torch.equal(v, saved[0]["grads"][k]),
                     f"sp {name}: the ranks' {k} differ")
        sites = sp_sites(cfg)
        want_split = dict.fromkeys(("stats", "apply", "bwd_stats",
                                    "bwd_apply"), sites)
        splits = [s["split"] for s in saved]
        print(f"  [{card}] sp {name} ({world} gloo ranks): losses max rel "
              f"diff {worst_loss:.3g} (limit {SP_LOSS_REL}), gradients max "
              f"|diff| / max |g| {worst_grad:.3g} (limit {SP_GRAD_REL}) "
              f"against one process on the whole plane; K1 split calls a "
              f"step per rank {splits[0]} ({sites} sites), one-card K1 "
              f"{saved[0]['one_card']}; ranks' gradients bitwise equal; "
              + (f"both nets' new BN states max |diff| {worst_bn:.3g} "
                 f"(limit {SP_BN_TOL}), bitwise equal on the ranks; "
                 if bn_want else "")
              + f"split vs twin at the ranks' sites: {ranks[name]}")
        need(worst_loss <= SP_LOSS_REL and worst_grad <= SP_GRAD_REL,
             f"sp {name}: the ranks disagree with one process")
        need(all(s == want_split for s in splits)
             and all(s["one_card"] == {"fwd": 0, "bwd": 0} for s in saved),
             f"sp {name}: K1's calls a step {splits}, "
             f"{[s['one_card'] for s in saved]}; want {sites} of each split "
             "pass and no one-card call")
        res[name] = {"loss_max_rel": worst_loss, "grad_max_rel": worst_grad,
                     "k1_split_per_rank_per_step": splits[0],
                     "sites_check": ranks[name]}
        if bn_want:
            res[name]["bn_max_abs"] = worst_bn
    return res


def sp_assemble(blocks: list, sizes) -> np.ndarray:
    """The global array of the ranks' blocks (rank order) over a (D, S,
    W) layout."""
    from sggan_tpu_torch.parallel.mesh import rank_of
    D, S, Wn = sizes
    return np.concatenate([np.concatenate([np.concatenate(
        [blocks[rank_of(d, s, w, S, Wn)] for w in range(Wn)], axis=2)
        for s in range(S)], axis=1) for d in range(D)], axis=0)


def sp_cli_runs(work: str, dev, resume: str = "0",
                nets: str = "resnet") -> dict:
    """Part 2's CLI runs of ``nets`` ("resnet", "p2p", comma-separated)
    one after the other in this rank's process, each ``sp_cli_rank``'s:
    {net: its numbers}.  The later run's process is the earlier's, so it
    starts no process and joins no group of its own."""
    import gc
    out = {}
    for n in nets.split(","):
        out[n] = sp_cli_rank(work, dev, resume, n)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sp_cli_rank(work: str, dev, resume: str = "0",
                nets: str = "resnet") -> dict:
    """Part 2 in one rank: ``sggan_tpu_torch.main --mesh_space 2`` trains
    (or resumes) the full-width ResNet sggan run (``nets`` "p2p": the
    pix2pix pair's p2p run), with a profiler window of 2 steps; returns
    this rank's losses, a digest of its state (the pool aside), K1's
    calls, the halo, moments and gather traffic a step, the window's
    numbers and its peak memory; in the first run also K1's split passes
    against the twin at every site of the CLI's steps
    (``sp_k1_vs_plain``)."""
    import hashlib

    from sggan_tpu_torch import main as tmain
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.ops import norm as tnorm
    from sggan_tpu_torch.parallel import spatial
    from sggan_tpu_torch.train.step import state_tensors
    from sggan_tpu_torch.train.trainer import Trainer

    r = torch.distributed.get_rank()
    run = os.path.join(work, "sp_cli" if nets == "resnet" else "sp_p2p")
    argv = ["--phase", "train",
            *(SP_CLI_ARGS if nets == "resnet" else SP_P2P_ARGS),
            "--dataset_dir", os.path.join(work, "datasets", "city"),
            "--checkpoint_dir", os.path.join(run, "checkpoint"),
            *(x for d in ("test", "sample", "log", "profile")
              for x in (f"--{d}_dir", os.path.join(run, f"{d}{r}")))]
    if resume == "1":
        argv.append("--continue_train")
    runs, peaks = [], []
    train = Trainer.train

    def kept(self):
        step = self.step_fn

        def measured(*a, **k):  # each step's own peak (host-side stats)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            got = step(*a, **k)
            peaks.append((torch.cuda.max_memory_allocated(dev), before))
            return got
        self.step_fn = measured
        runs.append((self, train(self)))
        return runs[-1][1]
    Trainer.train = kept
    sites = []
    sp_reset()
    before = (spatial.halo_bytes, spatial.halo_calls, tnorm.moments_bytes,
              tnorm.moments_calls, spatial.gather_bytes, spatial.gather_calls)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        with sp_site_log(sites):
            tmain.main(argv)
    finally:
        Trainer.train = train
    wall = time.perf_counter() - t0
    counts, _ = read_k1()
    split = dict(cuda_in.sp_launches)
    tr, last = runs[-1]
    steps = SP_CLI_TRAIN // SP_CLI_B
    after = (spatial.halo_bytes, spatial.halo_calls, tnorm.moments_bytes,
             tnorm.moments_calls, spatial.gather_bytes, spatial.gather_calls)
    per = [(a - b) / steps for a, b in zip(after, before)]
    digest = hashlib.sha256(b"".join(
        t.detach().float().cpu().numpy().tobytes()
        for k, t in sorted(state_tensors(tr.state).items())
        if not k.startswith("pool."))).hexdigest()
    out = {"rank": r, "step": tr.state.step, "gen_loss": last["gen_loss"],
           "state_digest": digest,
           "k1_one_card": counts, "k1_split": split,
           "seconds": wall, "halo_bytes_per_step": per[0],
           "halo_calls_per_step": per[1], "moments_bytes_per_step": per[2],
           "moments_calls_per_step": per[3],
           "gather_bytes_per_step": per[4], "gather_calls_per_step": per[5],
           "step_peak_gib": max(p for p, _ in peaks) / 2 ** 30,
           "step_peak_above_gib": max(p - b for p, b in peaks) / 2 ** 30,
           "run_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    win = tr._prof
    if win is not None and win.steps:
        wall_ms = 1e3 * win.seconds / win.steps
        busy = sum(k[0] for k in kernel_times(win.prof, win.steps))
        rng = range_ms(win.prof, ("sp.halo", "sp.moments", "sp.gather",
                                  "dp.all_reduce"), win.steps)
        out.update(step_ms=wall_ms, busy_ms=busy,
                   idle_share=1 - busy / wall_ms, window_steps=win.steps,
                   halo_ms=rng.get("sp.halo"),
                   moments_ms=rng.get("sp.moments"),
                   gather_ms=rng.get("sp.gather"),
                   all_reduce_ms=rng.get("dp.all_reduce"))
    if resume == "1" or not sites:  # the pix2pix pair has no K1 site
        return out
    # K1's split passes against the twin at every site the CLI's steps
    # visited (bf16, this rank's block, the plane's count), the moments
    # summed over the plane both ways; after the counts were read
    errs = [sp_k1_vs_plain(site, tr.grid, dev, seed=470 + 10 * r + i)
            for i, site in enumerate(sites)]
    out["sites_check"] = {
        "sites": [[*site[0], str(site[1])[6:], site[2], site[3]]
                  for site in sites],
        "fwd_err": max(e[0] for e in errs), "dx_err": max(e[1] for e in errs),
        "dgb_rel": max(e[2] for e in errs)}
    return out


def sp_parity_wide(work: str, dev) -> dict:
    """The 4-rank job: part 1's cases of this world size, then the 2 x 2
    grid's step at 512x1024 in the same processes."""
    parity = sp_parity_rank(work, dev)
    torch.cuda.empty_cache()
    return {"parity": parity, "wide": sp_wide_rank(work, dev)}


def sp_wide_rank(work: str, dev) -> dict:
    """One step of the ResNet sggan at 512x1024 bf16 on a 2 x 2 grid (a
    block of 256 x 512 a rank), from a synthetic batch: its losses and
    this rank's peak memory."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.parallel import mesh
    from sggan_tpu_torch.parallel.spatial_step import shard_global
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    h, w, b = SP_WIDE
    cfg = Config(image_height=h, image_width=w, batch_size=b,
                 use_resnet=True, loss_mode="sggan",
                 segment_class=N_CLASS, compute_dtype="bfloat16",
                 max_size=50, mesh_space=2, mesh_space_w=2)
    grid = mesh.grid(cfg)
    st = tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)
    blk = to_dev(shard_global(train_batch(cfg, b, "cpu", 7), grid), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    st, m = tstep.build_step_fn(cfg)(
        st, blk, SP_LR, tpool.pool_draws(torch.Generator(), b, 50))
    losses = {k: v.item() for k, v in m.items()}
    return {"rank": grid.rank, "losses": losses,
            "seconds": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "peak_above_gib": (torch.cuda.max_memory_allocated(dev)
                               - before) / 2 ** 30}


def one_process_peak(dev, h: int, w: int, b: int,
                     pix2pix: bool = False) -> float:
    """The peak GiB above what was resident before them of two
    one-process ResNet sggan steps (the patch-head D, bf16; with
    ``pix2pix`` the pix2pix pair's p2p steps with their dropout masks) on
    the whole plane at the same global batch (this long process holds
    other phases' tensors: the absolute peak would count them)."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    if pix2pix:
        cfg = Config(image_height=h, image_width=w, batch_size=b,
                     use_pix2pix=True, loss_mode="p2p",
                     compute_dtype="bfloat16")
        st = tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)
    else:
        cfg = Config(image_height=h, image_width=w, batch_size=b,
                     use_resnet=True, loss_mode="sggan",
                     segment_class=N_CLASS, compute_dtype="bfloat16",
                     max_size=50)
        g0 = torch.Generator().manual_seed(0)
        gen = tstep.new_generator(cfg, g0).to(dev)
        disc = tstep.new_discriminator(cfg, g0, head="patch").to(dev)
        st = tstep.TrainState(gen, {}, disc, {}, tstep.adam_init(gen),
                              tstep.adam_init(disc), tpool.pool_init(
                                  50, {"fake": (h, w, 3),
                                       "mask": (*cfg.mask_hw, N_CLASS)},
                                  torch.bfloat16, dev), 0, None)
    batch = train_batch(cfg, b, dev, 7)
    step = tstep.build_step_fn(cfg)
    mask_gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    for _ in range(2):
        st, m = step(st, batch, SP_LR, tpool.pool_draws(torch.Generator(), b,
                                                        50),
                     tstep.dropout_masks(cfg, st.gen_params, mask_gen, b))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - before) / 2 ** 30
    del st, batch
    torch.cuda.empty_cache()
    return peak


def sp_k1_times(card: str, dev) -> dict:
    """K1's split passes at part 2's resblock site, a rank's block (8, 32,
    128, 256) bf16 relu, in one process (no all-reduce between them):
    forward (stats + apply) and backward (stats + apply) by CUDA events
    beside the plain twin and PyTorch's instance norm on the same block;
    the bound reads each input once and writes each output once."""
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.ops import norm as tnorm
    n, hwc, act, it = SP_CLI_B, (H // 8, W // 4, 4 * NGF), "relu", 20
    x, g, b = site_inputs(n, hwc, torch.bfloat16, dev, seed=377)
    dy = torch.randn(x.shape, device=dev).to(torch.bfloat16)
    count = hwc[0] * 2 * hwc[1]
    sums = cuda_in.sp_stats(x)
    y, mean, rstd = cuda_in.sp_apply(x, sums, g, b, count, 1e-3, act, 0.3)

    def fwd():
        return cuda_in.sp_apply(x, cuda_in.sp_stats(x), g, b, count, 1e-3,
                                act, 0.3)

    def bwd():
        s, _, _ = cuda_in.sp_bwd_stats(x, dy, g, b, mean, rstd, act, 0.3)
        return cuda_in.sp_bwd_apply(x, dy, g, b, mean, rstd, s, count, act,
                                    0.3)
    before = dict(cuda_in.sp_launches)
    out = {"site": [n, *hwc], "count": count,
           "fwd_ms": cuda_ms(fwd, it), "bwd_ms": cuda_ms(bwd, it),
           "fwd_plain_ms": cuda_ms(lambda: tnorm.instance_norm_sp_ref(
               x, g, b, count, None, 1e-3, act, 0.3), it),
           "bwd_plain_ms": cuda_ms(lambda: tnorm.instance_norm_sp_bwd_ref(
               x, dy, g, b, mean, rstd, count, None, act, 0.3), it),
           "fwd_library_ms": cuda_ms(lambda: library_in(x, g, b, act), it),
           "fwd_bound_ms": bound_ms(n, hwc, 2, 2, 8),
           "bwd_bound_ms": bound_ms(n, hwc, 2, 3, 14)}
    xr, gr, br = (t.detach().requires_grad_(True) for t in (x, g, b))
    yl = library_in(xr, gr, br, act)
    out["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        yl, (xr, gr, br), dy.permute(0, 3, 1, 2), retain_graph=True), it)
    # the timing launches are not the main path's: put the counts back
    cuda_in.sp_launches.update(before)
    print(f"  [{card}] K1 split at a rank's resblock site {out['site']} "
          f"bf16 relu (count {count}): forward {out['fwd_ms']:.4f} ms "
          f"(plain {out['fwd_plain_ms']:.4f}, F.instance_norm + relu "
          f"{out['fwd_library_ms']:.4f}, bound {out['fwd_bound_ms']:.4f}); "
          f"backward {out['bwd_ms']:.4f} ms (plain {out['bwd_plain_ms']:.4f}"
          f", autograd {out['bwd_library_ms']:.4f}, bound "
          f"{out['bwd_bound_ms']:.4f})")
    return out


def sp_cli_job(work: str) -> tuple:
    """Part 2's CLI runs in one pair of gloo ranks sharing the card: the
    ResNet sggan run, then the pix2pix p2p run in the same processes;
    returns the ranks' (exit code, stdout, stderr) and their last lines
    parsed."""
    outs = dp_wait(dp_start("cli", work, "0", "resnet,p2p", child=SP_CHILD),
                   "train 1 epoch over 2 gloo ranks (python -m "
                   "sggan_tpu_torch.main --mesh_space 2), then the same "
                   "with --use_pix2pix --loss_mode p2p in the same two "
                   "processes", 900)
    for o in outs:
        need("imported JAX modules: []" in o[1], "an sp rank imported JAX")
    return outs, [json.loads(o[1].strip().splitlines()[-1]) for o in outs]


def sp_train(card: str, dev, work: str, job: tuple) -> dict:
    """Phase 37, part 2 (main path): the full-width ResNet sggan CLI with
    ``--mesh_space 2`` over two gloo ranks sharing the card, alone on it,
    on the split resident on each rank (the CLI's default): equal finite
    losses, each rank's resident line, K1's split calls a step per rank
    those of its sites and only the coordinator's eval on the one-card
    kernel, only
    rank 0 printing and writing, the checkpoint's pool in the global
    layout; each rank's step, busy, idle, halo and moments traffic and
    peak beside one process's peak at the same global batch."""
    run = os.path.join(work, "sp_cli")
    steps = SP_CLI_TRAIN // SP_CLI_B
    outs, both = job
    res = [x["resnet"] for x in both]
    losses = [x["gen_loss"] for x in res]
    need(math.isfinite(losses[0]) and losses[0] == losses[1],
         f"the ranks' epoch losses {losses}")
    need(all(x["step"] == steps for x in res), "the ranks' steps")
    need(" [*] spatially sharded over 2 ranks (gloo)" in outs[0][1]
         and "Epoch: [ 0]" in outs[0][1] and "Epoch:" not in outs[1][1],
         "only the coordinator prints the run's lines")
    for r, o in enumerate(outs):
        need(f" [*] training split resident on device on rank {r} ("
             in o[1], f"rank {r} did not hold the split on its card")
    need("data row d takes rows [16d, 16(d + 1)) of each batch of 16 (the "
         "JAX mesh's blocks), from the split resident on each rank's card; "
         "--scan_steps 8: chunks of 8 eager steps" in outs[0][1]
         and "from the host iterator (the split is not resident: "
         "--device_dataset_mb 0)" in outs[0][1],
         "the coordinator did not print the sggan run's resident path and "
         "the pix2pix run's host path")
    saved = torch.load(os.path.join(run, "checkpoint", "city", "train",
                                    "cp-0000.pt"), weights_only=True)
    need(saved["step"] == steps
         and tuple(saved["pool_buffer"]["fake"].shape) == (50, H, W, 3)
         and tuple(saved["pool_buffer"]["mask"].shape)
         == (50, H // 8, W // 8, N_CLASS),
         "the checkpoint's step or pool layout")
    need(all(os.path.isfile(os.path.join(run, "test0", f"s{i:04d}.png"))
             for i in range(E2E_TEST)), "rank 0 wrote no eval PNGs")
    need(not any(os.path.exists(os.path.join(run, f"{d}1"))
                 for d in ("test", "sample", "log")),
         "rank 1 wrote eval PNGs, samples or tfevents")
    sites = 23 + 2 * 3
    want = dict.fromkeys(("stats", "apply", "bwd_stats", "bwd_apply"),
                         steps * sites)
    eval_fwd = 23 * FWD_GRAPH_CALLS
    need(all(x["k1_split"] == want for x in res)
         and res[1]["k1_one_card"] == {"fwd": 0, "bwd": 0}
         and res[0]["k1_one_card"] == {"fwd": eval_fwd, "bwd": 0},
         "K1's calls per rank "
         f"{[(x['k1_split'], x['k1_one_card']) for x in res]}"
         f": {sites} of each split pass a step, the one-card kernel only in "
         "the coordinator's eval")
    for x in res:
        c = x["sites_check"]
        print(f"  [{card}] rank {x['rank']}: K1's split passes against the "
              f"plain twin at the {len(c['sites'])} sites of the CLI's steps "
              f"(bf16, n/h/w/c, act, the plane's count: {c['sites']}): y/"
              f"mean/rstd max abs diff {c['fwd_err']:.3g}, dx "
              f"{c['dx_err']:.3g}, local dgamma/dbeta rel {c['dgb_rel']:.3g} "
              "(phase 23's bf16 limits)")
    need(all(len(x["sites_check"]["sites"]) >= 4 for x in res),
         "the CLI's steps logged too few K1 sites")
    one_peak = one_process_peak(dev, H, W, 2 * SP_CLI_B)
    for x in res:
        need("step_ms" in x and x["moments_ms"] and x["halo_ms"],
             f"rank {x['rank']}: no profiler window with the collectives")
        print(f"  [{card}] rank {x['rank']}, two ranks sharing one card, "
              f"not a scaling number: step {x['step_ms']:.3f} ms "
              f"(b={SP_CLI_B} doubled to {2 * SP_CLI_B}, a block of "
              f"{H // 2} x {W} a rank), device "
              f"busy {x['busy_ms']:.3f} ms, idle "
              f"{100 * x['idle_share']:.1f}% (profiler, "
              f"{x['window_steps']} steps); halos "
              f"{x['halo_bytes_per_step']:.0f} bytes sent in {x['halo_calls_per_step']:g} exchanges a "
              f"step, sp.halo {x['halo_ms']:.3f} ms; moments "
              f"{x['moments_bytes_per_step']:.0f} bytes in "
              f"{x['moments_calls_per_step']:g} all-reduces a step, "
              f"sp.moments {x['moments_ms']:.3f} ms; gradients "
              f"dp.all_reduce {x['all_reduce_ms']} ms; K1 split "
              f"{x['k1_split']}; a step's peak allocated above what was "
              f"resident before it {x['step_peak_above_gib']:.3f} GiB (one "
              f"process, same batch, whole plane: {one_peak:.3f} GiB); "
              f"absolute {x['step_peak_gib']:.3f}, the whole run's (the "
              f"preprocess, eval and save included) "
              f"{x['run_peak_gib']:.3f} GiB")
    return {"ranks": res, "one_process_peak_gib": one_peak,
            "launches_sp": {d: res[1]["k1_split"][p] // steps
                            for d, p in (("fwd", "apply"),
                                         ("bwd", "bwd_apply"))}}


def sp_p2p_train(card: str, dev, work: str, job: tuple) -> dict:
    """Phase 37, part 2's pix2pix half (main path): ``python -m
    sggan_tpu_torch.main --mesh_space 2 --use_pix2pix --loss_mode p2p`` at
    full width over two gloo ranks sharing the card, alone on it: equal
    finite losses, each rank's whole state bitwise equal (both nets' BN
    states in it), no K1 call (batch norm), only rank 0 printing and
    writing, the checkpoint with both nets' BN states and the p2p step's
    one-slot pool in the global layout; each rank's step, busy, idle,
    gather, halo and moments traffic and peak beside one process's peak
    at the same global batch."""
    from sggan_tpu_torch.models.discriminator_pix2pix import (
        DiscriminatorPix2pix)
    from sggan_tpu_torch.models.generator_pix2pix import GeneratorPix2pix
    run = os.path.join(work, "sp_p2p")
    steps = SP_CLI_TRAIN // SP_CLI_B
    outs, both = job
    res = [x["p2p"] for x in both]
    losses = [x["gen_loss"] for x in res]
    need(math.isfinite(losses[0]) and losses[0] == losses[1],
         f"the pix2pix ranks' epoch losses {losses}")
    need(all(x["step"] == steps for x in res), "the pix2pix ranks' steps")
    need(res[0]["state_digest"] == res[1]["state_digest"],
         "the pix2pix ranks' states (parameters, BN states, Adam, EMA) "
         "differ")
    need(" [*] spatially sharded over 2 ranks (gloo)" in outs[0][1]
         and "Epoch: [ 0]" in outs[0][1] and "Epoch:" not in outs[1][1],
         "only the coordinator prints the run's lines")
    ck = os.path.join(run, "checkpoint", "city")
    saved = {part: torch.load(os.path.join(ck, part, "cp-0000.pt"),
                              weights_only=True)
             for part in ("gen", "disc", "train")}
    gen_bn = set(GeneratorPix2pix(image_size=H)._bn_ch)
    disc_bn = set(DiscriminatorPix2pix()._bn_ch)
    need(saved["train"]["step"] == steps
         and tuple(saved["train"]["pool_buffer"]["fake"].shape)
         == (1, H, W, 3)
         and set(saved["gen"]["bn"]) == gen_bn
         and set(saved["disc"]["bn"]) == disc_bn,
         "the pix2pix checkpoint's step, pool layout or BN states")
    need(all(os.path.isfile(os.path.join(run, "test0", f"s{i:04d}.png"))
             for i in range(E2E_TEST)), "rank 0 wrote no eval PNGs")
    need(not any(os.path.exists(os.path.join(run, f"{d}1"))
                 for d in ("test", "sample", "log")),
         "rank 1 wrote eval PNGs, samples or tfevents")
    zero = dict.fromkeys(("stats", "apply", "bwd_stats", "bwd_apply"), 0)
    need(all(x["k1_split"] == zero
             and x["k1_one_card"] == {"fwd": 0, "bwd": 0} for x in res),
         f"K1 ran in the pix2pix run: {[x['k1_split'] for x in res]}")
    one_peak = one_process_peak(dev, H, W, 2 * SP_CLI_B, pix2pix=True)
    for x in res:
        need("step_ms" in x and x["moments_ms"] and x["halo_ms"]
             and x["gather_ms"],
             f"rank {x['rank']}: no profiler window with the collectives")
        print(f"  [{card}] pix2pix rank {x['rank']}, two gloo ranks sharing "
              f"one card, not a scaling number: step {x['step_ms']:.3f} ms "
              f"(b={SP_CLI_B} doubled to {2 * SP_CLI_B}, a block of "
              f"{H // 2} x {W} a rank), device busy {x['busy_ms']:.3f} ms, "
              f"idle {100 * x['idle_share']:.1f}% (profiler, "
              f"{x['window_steps']} steps); gathers "
              f"{x['gather_bytes_per_step']:.0f} bytes in "
              f"{x['gather_calls_per_step']:g} collectives a step (the "
              f"backward's reductions included), sp.gather "
              f"{x['gather_ms']:.3f} ms; halos "
              f"{x['halo_bytes_per_step']:.0f} bytes in "
              f"{x['halo_calls_per_step']:g} exchanges, sp.halo "
              f"{x['halo_ms']:.3f} ms; BN moments "
              f"{x['moments_bytes_per_step']:.0f} bytes in "
              f"{x['moments_calls_per_step']:g} all-reduces, sp.moments "
              f"{x['moments_ms']:.3f} ms; gradients dp.all_reduce "
              f"{x['all_reduce_ms']} ms; a step's peak allocated above what "
              f"was resident before it {x['step_peak_above_gib']:.3f} GiB "
              f"(one process, same batch, whole plane: {one_peak:.3f} GiB); "
              f"absolute {x['step_peak_gib']:.3f}, the whole run's "
              f"{x['run_peak_gib']:.3f} GiB; state digest "
              f"{x['state_digest'][:16]} on both ranks")
    return {"ranks": res, "one_process_peak_gib": one_peak}


def sp_follow_start(work: str) -> dict:
    """The rest of phase 37, started together beside phase 26 (none of it
    timed): part 1's ranks (2 and 4, two jobs), the 2-rank
    ``--continue_train`` of part 2's checkpoint, the 2 x 2 grid's step at
    512x1024 (each rank's peak is its own process's)."""
    run = os.path.join(work, "sp_p2p")
    test = subprocess.Popen(
        [sys.executable, "-m", "sggan_tpu_torch.main", "--phase", "test",
         *SP_P2P_ARGS, "--dataset_dir", os.path.join(work, "datasets",
                                                     "city"),
         "--checkpoint_dir", os.path.join(run, "checkpoint"), "--test_dir",
         os.path.join(run, "test_one")], cwd=run, env=repo_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"resume": dp_start("cli", work, "1", "resnet,p2p",
                               child=SP_CHILD),
            "p2p_test": [test],
            "parity2": dp_start("parity", work, child=SP_CHILD),
            "parity4": dp_start("parity_wide", work, child=SP_CHILD,
                                world=4)}


def sp_follow_check(card: str, dev, work: str, procs: dict) -> dict:
    """Waits for ``sp_follow_start``'s processes and holds them."""
    steps = SP_CLI_TRAIN // SP_CLI_B
    outs = dp_wait(procs["resume"], "--continue_train 1 epoch over 2 gloo "
                   "ranks (--mesh_space 2), then the pix2pix run's", 900)
    both = [json.loads(o[1].strip().splitlines()[-1]) for o in outs]
    again = [x["resnet"] for x in both]
    p2p_again = [x["p2p"] for x in both]
    need(outs[0][1].count(" [*] Load SUCCESS") == 2
         and all(x["step"] == 2 * steps for x in again),
         "the spatial --continue_train did not resume at the saved step")
    need(all(x["step"] == 2 * steps for x in p2p_again)
         and p2p_again[0]["state_digest"] == p2p_again[1]["state_digest"]
         and math.isfinite(p2p_again[0]["gen_loss"]),
         "the pix2pix --continue_train did not resume at the saved step "
         "with the ranks' states equal")
    test = dp_wait(procs["p2p_test"], "--phase test of the pix2pix "
                   "spatial checkpoint in one process", 600)
    test_dir = os.path.join(work, "sp_p2p", "test_one")
    need(" [*] Load SUCCESS" in test[0][1]
         and all(os.path.isfile(os.path.join(test_dir, f"s{i:04d}.png"))
                 for i in range(E2E_TEST)),
         "the one-process --phase test of the pix2pix spatial checkpoint")
    ranks = {}
    for label, procs_ in (("2", procs["parity2"]), ("4", procs["parity4"])):
        got = dp_wait(procs_, f"part 1, the parity ranks ({label})"
                      + (f", then one step at {SP_WIDE[0]}x{SP_WIDE[1]} "
                         "on a 2 x 2 grid" if label == "4" else ""), 600)
        for o in got:
            need("imported JAX modules: []" in o[1],
                 "an sp rank imported JAX")
        last = [json.loads(o[1].strip().splitlines()[-1]) for o in got]
        if label == "4":
            wres = [x["wide"] for x in last]
            last = [x["parity"] for x in last]
        for name, v in last[0].items():
            ranks[name] = v
    need(all(math.isfinite(v) for x in wres for v in x["losses"].values()),
         "the 2 x 2 grid's losses")
    one = one_process_peak(dev, SP_WIDE[0], SP_WIDE[1], SP_WIDE[2])
    print(f"  [{card}] {SP_WIDE[0]}x{SP_WIDE[1]} b={SP_WIDE[2]} on a 2 x 2 "
          f"grid (4 gloo ranks sharing the card): per-rank step peak above "
          f"the resident {[round(x['peak_above_gib'], 3) for x in wres]} "
          f"GiB (absolute {[round(x['peak_gib'], 3) for x in wres]}) "
          f"against one process's {one:.3f} GiB; losses "
          f"{wres[0]['losses']}")
    return {"resume": again, "p2p_resume": p2p_again,
            "parity": sp_parity_check(card, dev, work, ranks),
            "wide": {"ranks": wres, "one_process_peak_gib": one}}


# phase 39, part 2: the ResNet sggan CLI of phases 36 and 37 with
# --scan_steps 4 (its 4 steps one chunk) over two ranks, a card each
NCCL_K = 4
NCCL_LOSS_REL = 1e-6
NCCL_CHILD_GRAPH = ("import sys, chip_smoke; "
                    "sys.exit(chip_smoke.nccl_graph_rank(*sys.argv[1:]))")


def nccl_graph_rank(kind: str, work: str, backend: str) -> int:
    """One rank of phase 39's part 2, on the card ``LOCAL_RANK``: joins
    the group over ``backend``, trains the ResNet sggan CLI under
    ``--mesh_data 2`` (``kind`` "dp") or ``--mesh_space 2`` ("sp") with
    ``--scan_steps 4`` and cuDNN deterministic, and prints as its last
    line its epoch loss and a digest of its state (the pool aside)."""
    import hashlib

    import torch.distributed as dist

    from sggan_tpu_torch import main as tmain
    from sggan_tpu_torch.parallel import distributed
    from sggan_tpu_torch.train.step import state_tensors
    from sggan_tpu_torch.train.trainer import Trainer

    distributed.initialize(backend=backend)
    r = dist.get_rank()
    run = os.path.join(work, f"nccl_graph_{kind}_{backend}")
    args = [*DP_CLI_ARGS, "--mesh_data", str(DP_N)] if kind == "dp" \
        else SP_CLI_ARGS
    argv = ["--phase", "train", *args, "--scan_steps", str(NCCL_K),
            "--dataset_dir", os.path.join(work, "datasets", "city"),
            "--checkpoint_dir", os.path.join(run, "checkpoint"),
            *(x for d in ("test", "sample", "log")
              for x in (f"--{d}_dir", os.path.join(run, f"{d}{r}")))]
    runs, train = [], Trainer.train

    def kept(self):
        runs.append((self, train(self)))
        return runs[-1][1]
    Trainer.train = kept
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        tmain.main(argv)
        wall = time.perf_counter() - t0
        tr, last = runs[-1]
        digest = hashlib.sha256(b"".join(
            t.detach().float().cpu().numpy().tobytes()
            for k, t in sorted(state_tensors(tr.state).items())
            if not k.startswith("pool."))).hexdigest()
    finally:
        Trainer.train = train
        dist.barrier()
        distributed.shutdown()
    print(json.dumps({"rank": r, "step": tr.state.step,
                      "gen_loss": last["gen_loss"], "digest": digest,
                      "seconds": wall}), flush=True)
    return 0


def nccl_graph_cli(card: str, work: str) -> dict:
    """Phase 39, part 2, where the machine has two cards: the ResNet sggan
    CLI at full width with ``--mesh_data 2 --scan_steps 4`` and with
    ``--mesh_space 2 --scan_steps 4`` on phase 16's PNGs, over two NCCL
    ranks, a card each (the step captured with its collectives), then the
    same over two gloo ranks on the same cards (eager steps): each NCCL
    rank prints its captured line and the coordinator the path line; the
    NCCL ranks' states bitwise equal; the NCCL run's epoch loss within
    rel 1e-6 of the gloo run's."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"  nccl graph: not run, {n} card")
        return {"nccl_graph": f"not run, {n} card"}
    out = {}
    for kind in ("dp", "sp"):
        got = {}
        for backend in ("nccl", "gloo"):
            outs = dp_wait(dp_start(kind, work, backend,
                                    child=NCCL_CHILD_GRAPH, nccl=True),
                           f"the ResNet sggan CLI with --mesh_"
                           f"{'data' if kind == 'dp' else 'space'} 2 "
                           f"--scan_steps {NCCL_K} over 2 {backend} ranks, "
                           "a card each", 900)
            got[backend] = [json.loads(o[1].strip().splitlines()[-1])
                            for o in outs]
            captured = [[ln for ln in o[1].splitlines()
                         if "train step captured as a CUDA graph" in ln]
                        for o in outs]
            for r, lines in enumerate(captured):
                print(f"  [{card}] {kind} {backend} rank {r}: "
                      f"{lines or 'no capture'}")
            if backend == "nccl":
                need(all(any(f" on rank {r} " in ln for ln in lines)
                         for r, lines in enumerate(captured)),
                     f"{kind}: an NCCL rank did not capture its step")
                need(f"--scan_steps {NCCL_K}: one CUDA graph a step, its "
                     "NCCL collectives captured" in outs[0][1],
                     f"{kind}: the coordinator's NCCL path line")
                need(len({x["digest"] for x in got[backend]}) == 1,
                     f"{kind}: the NCCL ranks' states differ")
            else:
                need(not any(captured) and "gloo's collectives cannot be "
                     "captured" in outs[0][1],
                     f"{kind}: the gloo run captured, or its path line")
        a, b = got["nccl"][0]["gen_loss"], got["gloo"][0]["gen_loss"]
        rel = abs(a - b) / abs(b)
        secs = {k: [x["seconds"] for x in v] for k, v in got.items()}
        print(f"  [{card}] {kind}: epoch generator loss {a!r} over NCCL "
              f"(the graph), {b!r} over gloo (eager), rel {rel:.3g} (limit "
              f"{NCCL_LOSS_REL:g}); the ranks' seconds {secs}")
        need(math.isfinite(a) and rel <= NCCL_LOSS_REL,
             f"{kind}: the NCCL run's loss is off the gloo run's")
        out[kind] = {**got, "rel": rel}
    return {"nccl_graph": out}


def sp_alone() -> int:
    """Phase 37 by itself (``python -c "import chip_smoke;
    chip_smoke.sp_alone()"``): the build, a PNG set, part 2, part 1."""
    from sggan_tpu_torch.ops import _build
    card, dev = card_line(), torch.device("cuda")
    print(card)
    _build.build("instance_norm")
    work = os.path.join(REPO, "_smoke")
    shutil.rmtree(work, ignore_errors=True)
    build_dataset(os.path.join(work, "datasets", "city"), SP_CLI_TRAIN)
    t0 = time.perf_counter()
    phase("37 spatial sharding: gloo ranks on the card")
    job = sp_cli_job(work)
    res = sp_train(card, dev, work, job)
    res["k1_times"] = sp_k1_times(card, dev)
    res["p2p"] = sp_p2p_train(card, dev, work, job)
    res.update(sp_follow_check(card, dev, work, sp_follow_start(work)))
    res.update(nccl_graph_cli(card, work))
    shutil.rmtree(work)
    print(f"  phase 37 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"sp": res}))
    return 0


# ----------------------------------------------------------------------
# The JAX package's Orbax checkpoints (phase 38)
# ----------------------------------------------------------------------

# the committed fixtures: the JAX package's CLI's checkpoints, each with
# its flags, its state's per-leaf SHA-256 and its test-phase forward
# (tests/make_orbax_fixtures.py)
ORBAX_DIR = os.path.join(REPO, "tests", "golden", "orbax")
ORBAX_DATASET = os.path.join(ORBAX_DIR, "dataset", "city")
# K1's calls a step of each fixture's step at 32x64 (phase 36's part 1:
# the semantic discriminator has fewer instance norms there than at
# 256x512; the pix2pix pair has none) and of its generator's forward
# (the eval's graph: 23 for a ResNet)
ORBAX_K1 = {"sggan_resnet_ema": (31, 23), "pix2pix_p2p": (0, 0),
            "cycle_resnet": (154, 23)}
ORBAX_K = 2            # the resume's steps: one chunk through the graph
ORBAX_MB = 200         # the decoder's output to time, at least
ORBAX_TOL = SLICE_ATOL  # phase 4's f32 limit


class _Tee(io.TextIOBase):
    """stdout kept as well as shown."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_main(argv: list, dev) -> str:
    """``sggan_tpu_torch.main`` in this process on ``dev``; its output."""
    import contextlib

    from sggan_tpu_torch import main as tmain
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        tmain.main(argv, device=str(dev))
    return tee.buf.getvalue()


def tree_digest(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            h.update(os.path.relpath(os.path.join(d, f), path).encode())
            with open(os.path.join(d, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def orbax_frames() -> list:
    """Every zarr chunk of every committed fixture: the zstd frames that
    the JAX package's Orbax save wrote."""
    from sggan_tpu_torch.utils import ocdbt
    frames = []
    for item in sorted(glob.glob(os.path.join(ORBAX_DIR, "*", "checkpoint",
                                              "*", "*", "cp-*"))):
        db = ocdbt.Database(item)
        frames += [db.get(k) for k in db.keys()
                   if not k.endswith(".zarray")]
    return frames


def orbax_decoder_rate(card: str) -> dict:
    """The decoder's MB/s of output on this host: the fixtures' frames one
    after another, that buffer repeated to ``ORBAX_MB`` MB of output,
    decoded in one call (after one call on a copy of the frames)."""
    from sggan_tpu_torch.utils import zstd
    frames = orbax_frames()
    blob = b"".join(frames)
    once = zstd.decompress(blob, "the fixtures' frames").size
    reps = math.ceil(ORBAX_MB * 1e6 / once)
    big = blob * reps
    t0 = time.perf_counter()
    n = zstd.decompress(big, "the repeated frames").size
    dt = time.perf_counter() - t0
    need(n == once * reps, "the repeated frames decoded to another size")
    rate = n / 1e6 / dt
    cpu = host_cpu()
    print(f"  zstd decoder (host C++): {len(frames)} frames of the fixtures "
          f"({len(blob)} bytes -> {once} bytes) x {reps}: {n / 1e6:.1f} MB "
          f"in {dt:.3f} s, {rate:.1f} MB/s of output, one thread of {cpu}; "
          f"the card beside it: {card}")
    return {"frames": len(frames), "compressed_bytes": len(blob) * reps,
            "output_bytes": n, "s": dt, "mb_per_s": rate, "host_cpu": cpu}


def orbax_case(case: str, dev, work: str) -> dict:
    """One fixture through the port's CLI on the card: ``--phase test``
    (the forward against the JAX package's, the PNG), the service on it,
    then ``--continue_train`` of 2 steps through the step's graph with
    the loaded state held bit for bit."""
    from PIL import Image

    from sggan_tpu_torch import serve as srv
    from sggan_tpu_torch.config import parse_args
    from sggan_tpu_torch.data.loader import load_test_triplet
    from sggan_tpu_torch.data.preprocess import fake_u8
    from sggan_tpu_torch.train import evaluate
    from sggan_tpu_torch.train.trainer import Trainer
    from sggan_tpu_torch.utils import bridge
    from sggan_tpu_torch.utils import checkpoint as ckpt
    from sggan_tpu_torch.utils.orbax import leaf_digests

    with open(os.path.join(ORBAX_DIR, case, "fixture.json")) as f:
        fx = json.load(f)
    epoch = fx["epoch"]
    run = os.path.join(work, case)
    ck = os.path.join(run, "checkpoint")
    shutil.copytree(os.path.join(ORBAX_DIR, case, "checkpoint"), ck)
    parts = {p: os.path.join(ck, "city", p, f"cp-{epoch:04d}")
             for p in ("gen", "disc", "train")}
    before = {p: tree_digest(d) for p, d in parts.items()}
    argv = ["--dataset_dir", ORBAX_DATASET, *fx["flags"], "--checkpoint_dir",
            ck, *(x for d in ("sample", "test", "log")
                  for x in (f"--{d}_dir", os.path.join(run, d)))]
    want = np.load(os.path.join(ORBAX_DIR, case, "test_fake.npy"))
    name = fx["test_files"][0]
    out = {}

    # --phase test: the PNG it writes, and its forward in f32 against the
    # JAX package's at phase 4's limit
    t0 = time.perf_counter()
    log = run_main(["--phase", "test", *argv], dev)
    need(f" [*] Load SUCCESS (JAX Orbax cp-{epoch:04d})" in log,
         f"{case}: --phase test did not load the JAX checkpoint")
    png_out = np.asarray(Image.open(os.path.join(run, "test", name)))
    cfg = parse_args(["--phase", "test", *argv])
    tr = Trainer(cfg, device=dev)
    tr.state = ckpt.load(tr.state, cfg.checkpoint_dir, cfg.dataset_dir,
                         pool=False)
    x, _ = evaluate._test_inputs(tr, [load_test_triplet(
        os.path.join(ORBAX_DATASET, "testA", name))])
    y = evaluate.generate(cfg, evaluate.eval_generator(tr), x, tr.device,
                          gen_bn=tr.state.gen_bn)
    err = float(np.abs(np.asarray(y) - want).max())
    u8 = fake_u8(torch.from_numpy(want)).numpy()[0]
    png_err = int(np.abs(png_out.astype(int) - u8).max())
    print(f"  {case}: --phase test on the card, f32 (TF32 off): max abs "
          f"{err:.3g} against the JAX package's forward (limit "
          f"{ORBAX_TOL}); its PNG within {png_err} level(s) of the JAX "
          f"forward's; {time.perf_counter() - t0:.1f} s")
    need(err <= ORBAX_TOL, f"{case}: the test forward is off the JAX one")
    need(png_err <= 1, f"{case}: the test PNG is off the JAX forward's")
    out.update(test_max_abs=err, test_png_levels=png_err)
    del tr

    # the service on it
    t0 = time.perf_counter()
    httpd = srv.serve(cfg, port=0, block=False, device=str(dev))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        with open(os.path.join(ORBAX_DATASET, "testA", name), "rb") as f:
            status, data = post(port, f.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    served = np.asarray(Image.open(io.BytesIO(data)))
    # the service's own uint8 rule (serve.py: truncation of (y + 1) / 2 * 255)
    srv_want = ((want[0] + 1.0) / 2.0 * 255).astype(np.uint8)
    srv_err = int(np.abs(served.astype(int) - srv_want).max())
    print(f"  {case}: the service: /healthz {health}; POST {name}: {status}, "
          f"within {srv_err} level(s) of the JAX forward's; "
          f"{time.perf_counter() - t0:.1f} s")
    need(health.get("checkpoint_loaded") is True,
         f"{case}: the service loaded no checkpoint")
    need(status == 200 and served.shape == want.shape[1:]
         and srv_err <= 1, f"{case}: the service's PNG is off")
    out.update(service_levels=srv_err)

    # --continue_train: the loaded state bit for bit, K1's calls exact,
    # the next checkpoint numbered after the JAX one, the JAX one kept
    t0 = time.perf_counter()
    loaded = {}
    load = ckpt.load

    def kept(*a, **kw):
        st = load(*a, **kw)
        if st is not None:
            loaded["leaves"] = leaf_digests(bridge.train_state_to_jax(st))
        return st
    ckpt.load = kept
    reset_k1()  # the main path starts here
    try:
        log = run_main(["--phase", "train", "--continue_train", "--epoch",
                        "1", "--scan_steps", str(ORBAX_K), *argv], dev)
    finally:
        ckpt.load = load
    counts, routes = read_k1()
    k_step, k_gen = ORBAX_K1[case]
    from sggan_tpu_torch.train.fused import WARMUP_STEPS
    want_k1 = {"fwd": (WARMUP_STEPS + 1) * k_step + FWD_GRAPH_CALLS * k_gen,
               "bwd": (WARMUP_STEPS + 1) * k_step}
    same = sum(loaded.get("leaves", {}).get(k) == v
               for k, v in fx["leaves"].items())
    print(f"  {case}: --continue_train {ORBAX_K} steps: {same} of "
          f"{len(fx['leaves'])} leaves of the loaded state bit for bit; K1 "
          f"calls {counts} by route {routes} (want {want_k1}: the step's "
          f"{k_step} each way at its {WARMUP_STEPS} warm-up steps and its "
          f"capture, the eval's forward graph {FWD_GRAPH_CALLS} x {k_gen}); "
          f"{time.perf_counter() - t0:.1f} s")
    need(f" [*] Load SUCCESS (JAX Orbax cp-{epoch:04d})" in log,
         f"{case}: --continue_train did not load the JAX checkpoint")
    need(loaded.get("leaves") == fx["leaves"],
         f"{case}: the loaded state is not the fixture's bit for bit")
    need_captured(log, k_step, ORBAX_K)
    need(counts == want_k1, f"{case}: K1's calls are not the cell's")
    m = re.search(r"Training finished: step (\d+)", log)
    need(m and int(m.group(1)) == fx["step"] + ORBAX_K,
         f"{case}: the resume did not go on from step {fx['step']}")
    for p, d in parts.items():
        need(os.path.isfile(os.path.join(ck, "city", p,
                                         f"cp-{epoch + 1:04d}.pt")),
             f"{case}: no {p}/cp-{epoch + 1:04d}.pt after the resume")
        need(tree_digest(d) == before[p],
             f"{case}: the resume changed the JAX {p} checkpoint")
    out.update(leaves=len(fx["leaves"]), k1=counts, k1_routes=routes)
    return out


def orbax_phase(card: str, dev) -> dict:
    """Phase 38, at the end of ``graphs_hist_phases``'s fresh process: the
    JAX package's Orbax checkpoints through the port's CLI on the card
    (``orbax_case``), each committed fixture in turn, then the decoder's
    rate (``orbax_decoder_rate``)."""
    from sggan_tpu_torch.utils import zstd
    phase("38 the JAX package's Orbax checkpoints (main path): resume, "
          "test and serve each committed fixture on the card; the zstd "
          "decoder's MB/s")
    t_phase = time.perf_counter()
    zstd.build()
    cases = sorted(d for d in os.listdir(ORBAX_DIR)
                   if os.path.isfile(os.path.join(ORBAX_DIR, d,
                                                  "fixture.json")))
    need(cases == sorted(ORBAX_K1), f"fixtures {cases}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="orbax_", dir=REPO)
    try:
        res = {c: orbax_case(c, dev, work) for c in cases}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(work, ignore_errors=True)
    rate = orbax_decoder_rate(card)
    dt = time.perf_counter() - t_phase
    print(f"  phase 38: {dt:.1f} s")
    return {"cases": res, "decoder": rate, "s": dt}


def orbax_alone() -> int:
    """Phase 38 by itself (``python -c "import chip_smoke;
    chip_smoke.orbax_alone()"``): K1's build, then the phase."""
    from sggan_tpu_torch.ops import _build
    card, dev = card_line(), torch.device("cuda")
    print(card)
    _build.build("instance_norm")
    print(json.dumps({"orbax": orbax_phase(card, dev)}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from PIL import Image

    from sggan_tpu_torch import perf_conv_in
    from sggan_tpu_torch import serve as srv
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.models.generator_resnet import GeneratorResnet
    from sggan_tpu_torch.ops import _build, cuda_conv_in, cuda_in
    from sggan_tpu_torch.ops import norm as tnorm
    from sggan_tpu_torch.ops.norm import instance_norm_ref
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep

    dev = torch.device("cuda")

    phase("1 card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    phase("2 build")
    t0 = time.perf_counter()
    names = ("instance_norm", "conv3_in")
    from sggan_tpu_torch.utils import zstd
    # one nvcc each and g++ for the zstd decoder (phase 38), together
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(_build.build_host, "sgzstd",
                           [_build.CSRC / zstd.SOURCE])
        built = list(pool.map(_build.build, names))
    zlib, _, zfresh = host.result()
    print(f"built {', '.join(lib.name for lib, _, _ in built)} and "
          f"{zlib.name} in {time.perf_counter() - t0:.2f} s")
    print(f"  zstd_decode (g++, host code): "
          f"{'compiled' if zfresh else 'already built'}")
    for name, (lib, log, fresh) in zip(names, built):
        print(f"  {name}: {'compiled' if fresh else 'already built'}; "
              "ptxas:")
        report = ptxas_report(log)
        for kernel, regs, spills, smem in report:
            print(f"    {kernel:34s} {regs:3d} registers, {spills}, "
                  f"{smem} static shared bytes")
            if kernel.startswith("k2_conv_wgmma") and spills != \
                    "spills 0/0 bytes":
                raise AssertionError(f"{kernel} spills registers")
        if name == "conv3_in" and not any(
                k.startswith("k2_conv_wgmma") for k, *_ in report):
            raise AssertionError("ptxas reported no k2_conv_wgmma kernel: "
                                 "its spills are unchecked")
        # ptxas's own word on the wgmma pipelines: it serializes one it
        # cannot prove safe, and says so in a line of its own
        for line in log.splitlines():
            if "wgmma.mma_async" in line:
                print(f"    ptxas: {line.strip()}")
    print("  K1 cluster route: dynamic shared bytes per CTA up to "
          f"{cuda_in._SMEM_MAX} (the plan's limit), printed per site in "
          "phase 7")

    phase("3 kernel vs plain")
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n in (1, 16):
        for dtype in (torch.float32, torch.bfloat16):
            for i, (hwc, act) in enumerate(SITES):
                x, g, b = site_inputs(n, hwc, dtype, dev, seed=i)
                got = cuda_in.instance_norm_cuda(x, g, b, 1e-3, act, 0.3)
                again = cuda_in.instance_norm_cuda(x, g, b, 1e-3, act, 0.3)
                ref = instance_norm_ref(x, g, b, 1e-3, act, 0.3)
                if got.dtype != dtype or got.shape != x.shape:
                    raise AssertionError(f"kernel output {got.dtype} "
                                         f"{tuple(got.shape)}")
                if not torch.equal(got, again):
                    raise AssertionError("two K1 forward calls differ "
                                         "bitwise")
                d = (got.float() - ref.float()).abs()
                tol = TOL[dtype]
                n_bad = int((d > tol + tol * ref.float().abs()).sum())
                err = d.max().item()
                errs[dtype] = max(errs[dtype], err)
                print(f"  ({n},{','.join(map(str, hwc))}) act={act} "
                      f"{str(dtype)[6:]} {plan_line(n, hwc, dtype, 'fwd')}: "
                      f"max abs diff {err:.3g} (tol {tol} abs + rel), "
                      f"{n_bad} outside; bitwise repeatable")
                if n_bad:
                    raise AssertionError("kernel disagrees with plain IN")
                del x, got, again, ref, d
    torch.cuda.empty_cache()

    phase("4 whole generator at 256x512, ngf 64")
    gen = GeneratorResnet(ngf=NGF, generator=torch.Generator().manual_seed(0))
    gx = torch.Generator().manual_seed(1)
    x_cpu = torch.round(torch.rand(1, H, W, 3, generator=gx) * 255.0)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = gen(x_cpu, {}, torch.float32)[0]
        cpu_fwd_s = time.perf_counter() - t0
        print(f"  cpu f32 forward {cpu_fwd_s:.2f} s")
        gen = gen.to(dev)
        before = cuda_in.launches
        out32 = gen(x_cpu.to(dev), {}, torch.float32)[0].cpu()
        if cuda_in.launches - before != 23:
            raise AssertionError("card forward did not run 23 kernel IN")
        out16 = gen(x_cpu.to(dev), {}, torch.bfloat16)[0].cpu()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    d32 = (out32 - ref).abs().max().item()
    d16 = (out16 - ref).abs().max().item()
    print(f"  card f32 vs cpu f32: max abs diff {d32:.3g} "
          f"(atol {SLICE_ATOL})")
    print(f"  card bf16 vs cpu f32: max abs diff {d16:.3g}; "
          f"bf16 range [{out16.min().item():.4f}, {out16.max().item():.4f}]")
    if not (out32.shape == ref.shape == (1, H, W, 3)
            and torch.isfinite(out32).all() and d32 <= SLICE_ATOL):
        raise AssertionError("f32 card forward disagrees with the CPU")
    if not (torch.isfinite(out16).all() and out16.abs().max() <= 1.0):
        raise AssertionError("bf16 card forward not finite or outside "
                             "[-1, 1]")
    del gen, ref, out32, out16
    torch.cuda.empty_cache()

    phase("5 HTTP service on the card")
    cfg = Config(use_resnet=True, image_height=H, image_width=W, ngf=NGF,
                 compute_dtype="bfloat16")
    cuda_in.launches = 0  # the main path's count starts here
    httpd = srv.serve(cfg, port=0, block=False, device="cuda")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    latencies = []
    try:
        port = httpd.server_address[1]
        # the warm-up request captures the forward's graph
        if cuda_in.launches != 23 * FWD_GRAPH_CALLS:
            raise AssertionError(f"warm-up forward launched the kernel "
                                 f"{cuda_in.launches} times, not 23 x "
                                 f"{FWD_GRAPH_CALLS}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        print(f"  healthz {health}")
        if not (health["ok"] and health["backend"] == "cuda"
                and health["image_size"] == [H, W]):
            raise AssertionError("bad /healthz")
        rng = np.random.default_rng(0)
        sizes = [(H, W), (1024, 2048), (H, W), (H, W)]
        for i, (ih, iw) in enumerate(sizes):
            body = png(rng.integers(0, 256, (ih, iw, 3), np.uint8))
            before = cuda_in.launches
            t0 = time.perf_counter()
            status, data = post(port, body)
            latencies.append((time.perf_counter() - t0) * 1e3)
            out = np.asarray(Image.open(io.BytesIO(data)))
            print(f"  POST {ih}x{iw}: {status}, {out.shape} {out.dtype}, "
                  f"{latencies[-1]:.1f} ms, "
                  f"+{cuda_in.launches - before} kernel launches (a replay)")
            if status != 200 or out.shape != (H, W, 3) \
                    or out.dtype != np.uint8 or out.std() == 0:
                raise AssertionError("bad translation")
            if cuda_in.launches - before != 0:
                raise AssertionError("request did not replay the graph")
        try:
            post(port, b"this is not an image")
            raise AssertionError("garbage body was not refused")
        except urllib.error.HTTPError as e:
            print(f"  POST garbage: {e.code}")
            if e.code != 400:
                raise
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    main_launches = cuda_in.launches
    if main_launches != 23 * FWD_GRAPH_CALLS:
        raise AssertionError(f"main path launched the kernel "
                             f"{main_launches} times")
    print(f"  main path: {main_launches} kernel launches (the warm-up "
          f"request's capture, 23 x {FWD_GRAPH_CALLS}; {len(sizes)} "
          "requests replay it)")

    phase("6 timings")
    gen = GeneratorResnet(ngf=NGF, generator=torch.Generator().manual_seed(0))
    gen = gen.to(dev)
    fwd_ms = {}
    with torch.inference_mode():
        for n, iters in ((1, 20), (16, 5)):
            x = torch.round(torch.rand(n, H, W, 3, device=dev) * 255.0)
            fwd_ms[n] = cuda_ms(lambda: gen(x, {}, torch.bfloat16), iters)
            print(f"  [{card}] generator forward bf16 b={n}: "
                  f"{fwd_ms[n]:.3f} ms ({fwd_ms[n] / n:.3f} ms/image)")
    k_ms, p_ms = {}, {}
    for n in (1, 16):
        for i, (hwc, act) in enumerate(SITES):
            x, g, b = site_inputs(n, hwc, torch.bfloat16, dev, seed=i)
            iters = 50 if n == 1 else 10
            k_ms[n, i] = cuda_ms(
                lambda: cuda_in.instance_norm_cuda(x, g, b, 1e-3, act), iters)
            p_ms[n, i] = cuda_ms(
                lambda: instance_norm_ref(x, g, b, 1e-3, act), iters)
            gbs = 3 * x.numel() * x.element_size() / k_ms[n, i] / 1e6
            print(f"  [{card}] IN ({n},{','.join(map(str, hwc))}) "
                  f"act={act} bf16: kernel {k_ms[n, i]:.4f} ms "
                  f"({gbs:.0f} GB/s at 2R+1W), plain {p_ms[n, i]:.4f} ms")
            del x
    per_fwd = {n: (sum(c * k_ms[n, i] for i, c in enumerate(SITE_COUNT)),
                   sum(c * p_ms[n, i] for i, c in enumerate(SITE_COUNT)))
               for n in (1, 16)}
    for n, (k, p) in per_fwd.items():
        print(f"  [{card}] 23 IN sites of one b={n} bf16 forward: kernel "
              f"{k:.3f} ms, plain {p:.3f} ms")
    for i, ms in enumerate(latencies):
        print(f"  [{card}] request {i} ({sizes[i][0]}x{sizes[i][1]} PNG) "
              f"latency {ms:.1f} ms")
    # the request's parts, host clock, median of 5: the service's whole
    # translation (decode, resize, generate, PNG encode) and its generate
    # call alone (input convention, H2D, forward, D2H)
    svc = srv._Service(cfg, device="cuda")
    body = png(np.random.default_rng(1).integers(0, 256, (H, W, 3),
                                                  np.uint8))
    x01 = np.asarray(Image.open(io.BytesIO(body)), np.float32)[None] / 255.0
    parts = {}
    for name, fn in (("translate_png", lambda: svc.translate_png(body)),
                     ("generate", lambda: svc._fn(x01))):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        parts[name] = sorted(ts)[2]
    print(f"  [{card}] request parts, 256x512: translate_png "
          f"{parts['translate_png']:.1f} ms, of which generate "
          f"{parts['generate']:.1f} ms; HTTP adds "
          f"{sorted(latencies)[1] - parts['translate_png']:.1f} ms")
    del svc

    for n in (1, 16):
        profile_forward(gen, n, fwd_ms[n], card)
    del gen
    torch.cuda.empty_cache()

    phase("7 K1 forward and backward vs plain at the step's sites")
    bwd_errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (n, hwc, act) in enumerate(step_k1_sites()):
            f_err, b_err = k1_vs_plain(n, hwc, act, dtype, dev, seed=i)
            errs[dtype] = max(errs[dtype], f_err)
            bwd_errs[dtype] = max(bwd_errs[dtype], b_err)
    torch.cuda.empty_cache()

    phase("8 train step f32, card vs CPU")
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    # at the CPU tests' size (32x64, ngf = ndf = 4, 8 classes, b=2) every
    # gradient within 1e-3 of its tensor's largest, as
    # tests/test_torch_cuda.py holds it
    small = Config(image_height=32, image_width=64, ngf=4, ndf=4,
                   segment_class=8, batch_size=2, max_size=2,
                   compute_dtype="float32", loss_mode="sggan",
                   use_resnet=True)
    loss_err, rows, _, dead_live = step_card_vs_cpu(small, 2)
    if loss_err > 1e-4 or dead_live or max(r[0] for r in rows) > 1e-3:
        raise AssertionError("card step disagrees with the CPU step at "
                             "32x64")
    # the CPU step costs about four forwards (forward, backward, two
    # discriminator passes); full width when that stays near a minute
    full = 4 * cpu_fwd_s < 60
    cfg8 = Config(image_height=H if full else 128,
                  image_width=W if full else 256, ngf=NGF if full else 32,
                  ndf=64 if full else 32, segment_class=N_CLASS,
                  batch_size=1, max_size=50, compute_dtype="float32",
                  loss_mode="sggan", use_resnet=True)
    print(f"  {'full width' if full else 'reduced'} (CPU forward "
          f"{cpu_fwd_s:.1f} s):")
    loss_err, rows, card_g, dead_live = step_card_vs_cpu(cfg8, 1)
    # the noise floor: the same kernels with PyTorch's own convolutions in
    # place of cuDNN's, which sum in another order
    torch.backends.cudnn.enabled = False
    try:
        _, native_g = step_grads(cfg8, 1, "cuda")
    finally:
        torch.backends.cudnn.enabled = True
    print_rows("card with cuDNN off vs card (noise floor)",
               grad_rows(card_g, native_g))
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    if (loss_err > 1e-4 or dead_live
            or max(r[0] for r in rows) > STEP_MAX_REL
            or max(r[1] for r in rows) > STEP_NORM_REL):
        raise AssertionError("card step disagrees with the CPU step")
    del card_g, native_g
    torch.cuda.empty_cache()

    phase("9 train step at 256x512, bf16, b=16 (main path)")
    cfg = Config(image_height=H, image_width=W, ngf=NGF, ndf=64,
                 segment_class=N_CLASS, batch_size=B_TRAIN, max_size=50,
                 compute_dtype="bfloat16", loss_mode="sggan",
                 use_resnet=True)
    state = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cuda")
    batch = train_batch(cfg, B_TRAIN, dev, seed=5)
    step_fn = tstep.build_step_fn(cfg)
    draw_gen = torch.Generator().manual_seed(6)
    reset_k1()  # the main path starts here
    step_losses = []
    for _ in range(N_STEPS):
        state, m = step_fn(state, batch, 1e-3, tpool.pool_draws(
            draw_gen, B_TRAIN, cfg.max_size))
        step_losses.append(torch.stack([m["gen_loss"], m["disc_loss"]]))
    counts, by_route = read_k1()
    train_fwd, train_bwd = counts["fwd"], counts["bwd"]
    step_losses = torch.stack(step_losses).cpu()
    print(f"  {N_STEPS} steps: K1 launches forward {train_fwd}, backward "
          f"{train_bwd} ({LAUNCHES_PER_STEP} each per step expected); pool "
          f"{state.pool.count} of {cfg.max_size}")
    print(f"  gen_loss {[round(v, 4) for v in step_losses[:, 0].tolist()]}")
    print(f"  disc_loss {[round(v, 4) for v in step_losses[:, 1].tolist()]}")
    if train_fwd != LAUNCHES_PER_STEP * N_STEPS \
            or train_bwd != LAUNCHES_PER_STEP * N_STEPS:
        raise AssertionError("the step did not run 37 forward and 37 "
                             "backward kernel launches per step")
    if not torch.isfinite(step_losses).all() or state.step != N_STEPS:
        raise AssertionError("train step losses not finite")
    routes = {d: {r: k // N_STEPS for r, k in v.items()}
              for d, v in by_route.items()}
    want = {d: planned(step_sites(), d) for d in ("fwd", "bwd")}
    print(f"  K1 calls per step by route: {routes} (planned {want})")
    for d in ("fwd", "bwd"):
        if routes[d] != want[d] or "scalar" in routes[d]:
            raise AssertionError(f"the step's K1 {d} calls did not take the "
                                 "planned 16-byte routes")

    phase("10 train step timings")
    step_ms = {}
    for b in (B_TRAIN, 24):
        if b != B_TRAIN:
            del state, batch
            torch.cuda.empty_cache()
            state = tstep.init_state(cfg.replace(batch_size=b),
                                     torch.Generator().manual_seed(0),
                                     "cuda")
            batch = train_batch(cfg, b, dev, seed=5)
        holder = [state]

        def one_step():
            holder[0] = step_fn(holder[0], batch, 1e-3, tpool.pool_draws(
                draw_gen, b, cfg.max_size))[0]
        torch.cuda.reset_peak_memory_stats()
        try:
            step_ms[b] = cuda_ms(one_step, 8, warmup=2)
        except torch.cuda.OutOfMemoryError:
            if b == B_TRAIN:  # the main path's batch must fit
                raise
            print(f"  [{card}] b={b}: out of memory")
            continue
        state = holder[0]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  [{card}] sggan step bf16 256x512 b={b}: "
              f"{step_ms[b]:.2f} ms, {1e3 * b / step_ms[b]:.1f} img/s, "
              f"peak memory {peak:.2f} GiB")
        if b == B_TRAIN:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    one_step()
                torch.cuda.synchronize()
            state = holder[0]
            print_breakdown(prof, 2, step_ms[b], f"[{card}] profiler, b={b} "
                            "bf16 train step", STEP_CATEGORIES)
    del state, batch, holder
    torch.cuda.empty_cache()
    k1, k1_sites = time_sites(card, dev)

    # f32 twins and library paths in full f32 from here on: cuDNN would
    # take TF32 (three decimal digits) for f32 convolutions by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("11 K2 forward vs plain (the twin's f32 conv with TF32 off)")
    k2_errs = k2_forward_vs_plain(dev)

    phase("12 K2 backward vs plain")
    k2_bwd_errs = k2_backward_vs_plain(dev)

    phase("13 the resblock at full width through K2")
    k2_block_ms = k2_resblock(card, dev)

    phase("14 the K2 table (main path)")
    # the main path's counts start here
    cuda_conv_in.launches = 0
    cuda_conv_in.route_launches.update(
        dict.fromkeys(cuda_conv_in.route_launches, 0))
    cuda_in.launches = cuda_in.bwd_launches = 0
    print(card)
    table = perf_conv_in.main([str(K2_ITERS)])
    k2_launches = cuda_conv_in.launches
    print(f"  main path: K2 launches {k2_launches} "
          f"({cuda_conv_in.route_launches}), K1 forward {cuda_in.launches} "
          f"(the unfused path), K1 backward {cuda_in.bwd_launches} (both)")
    # per shape: the check, then warm-up 3 + iterations, forward and
    # forward+backward, which the unfused path runs K1 forward as often,
    # and both backwards K1's; then 1 + iterations more K2 forwards under
    # the profiler for the conv pass's device time
    per_shape = 1 + 2 * (3 + K2_ITERS)
    if (k2_launches != len(K2_FULL) * (per_shape + 1 + K2_ITERS)
            or cuda_conv_in.route_launches["k2_conv_wgmma"] != k2_launches
            or cuda_in.launches != len(K2_FULL) * per_shape
            or cuda_in.bwd_launches != len(K2_FULL) * 2 * (3 + K2_ITERS)):
        raise AssertionError("the table did not go through the K2 and K1 "
                             "kernels as often as it calls them")
    rows = {tuple(r["shape"]): r for r in table["rows"]}
    if table["compute_dtype"] != "bfloat16" or set(rows) != set(K2_FULL):
        raise AssertionError("the table is not the two full bf16 shapes")
    for shape, r in rows.items():
        bms, by = k2_bound(shape, torch.bfloat16)
        r["bound_ms"], r["bound_by"] = bms, by
        r["bwd_bound_ms"], r["bwd_bound_by"] = k2_bound(
            shape, torch.bfloat16, backward=True)
        # the scalar route at the same shape: f32, plain FMAs
        x, wk, g, b = k2_inputs(shape, torch.float32, dev, seed=0)
        r["fwd_k2_f32_ms"] = cuda_ms(lambda: cuda_conv_in.conv3_in_cuda(
            x, wk, g, b, 1e-3, "relu", 0.3), 3, warmup=1)
        del x
        torch.cuda.empty_cache()
        print(f"  [{card}] K2 {shape} bf16: forward {r['fwd_k2_ms']:.3f} ms "
              f"(unfused {r['fwd_unfused_ms']:.3f}, pad + cuDNN conv "
              f"{r['fwd_conv_reflect_ms']:.3f}, cuDNN conv alone "
              f"{r['fwd_conv_only_ms']:.3f}, bound {bms:.3f} by {by}); "
              f"forward+backward {r['fwdbwd_k2_ms']:.3f} ms (unfused "
              f"{r['fwdbwd_unfused_ms']:.3f}; the backward's bound "
              f"{r['bwd_bound_ms']:.3f} by {r['bwd_bound_by']}); max |K2 - "
              f"unfused| {r['max_abs_diff']:.3g}; f32 scalar route forward "
              f"{r['fwd_k2_f32_ms']:.3f} ms (bound "
              f"{k2_bound(shape, torch.float32)[0]:.3f})")
        print(f"  [{card}] K2 {shape} bf16 conv pass k2_conv_wgmma: "
              f"{r['conv_pass_ms']:.4f} ms device "
              f"({r['conv_pass_tflops']:.1f} TF/s); cuDNN conv alone "
              f"{r['fwd_conv_only_ms']:.4f} ms events "
              f"({r['fwd_conv_only_tfs']:.1f} TF/s), "
              f"{r['conv_only_device_ms']:.4f} ms device")
    res = rows[K2_FULL[0]]
    k2_profile(card, dev, res["fwd_k2_ms"])
    x, wk, g, b = k2_inputs(K2_FULL[0], torch.bfloat16, dev, seed=0)
    with torch.no_grad():
        k2_plain_ms = cuda_ms(lambda: cuda_conv_in.conv3_in_ref(
            x, wk, g, b, 1e-3, "relu", 0.3), 2, warmup=1)
    print(f"  [{card}] K2 plain twin {K2_FULL[0]} bf16: {k2_plain_ms:.3f} ms")
    del x

    def k2_times(r):
        return {"ms": r["fwd_k2_ms"], "library_ms": r["fwd_unfused_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "f32_ms": r["fwd_k2_f32_ms"],
                "fwdbwd_ms": r["fwdbwd_k2_ms"],
                "fwdbwd_library_ms": r["fwdbwd_unfused_ms"],
                "bwd_bound_ms": r["bwd_bound_ms"],
                "bwd_bound_by": r["bwd_bound_by"],
                "conv_pass_ms": r["conv_pass_ms"],
                "conv_pass_tflops": r["conv_pass_tflops"],
                "conv_only_library_ms": r["fwd_conv_only_ms"],
                "conv_only_library_device_ms": r["conv_only_device_ms"]}

    k2 = {"name": "conv3_in_fwd", "route": "cuda",
          "source": "sggan_tpu_torch/csrc/conv3_in.cu",
          "replaces": "sggan_tpu/ops/pallas_conv_in.py:267",
          "launches": k2_launches,
          "max_abs_err": max(k2_errs.values()),
          "max_abs_err_f32": k2_errs[torch.float32],
          "max_abs_err_dx": max(k2_bwd_errs.values()),
          **k2_times(res), "plain_ms": k2_plain_ms,
          "ms_is": "one call at (16,64,128,256->256), bf16, relu, CUDA "
                   "events; library_ms is the unfused path (pad gather + "
                   "cuDNN conv + K1); conv_pass_ms the k2_conv_wgmma pass "
                   "alone (profiler device time) beside cuDNN's conv alone "
                   "(conv_only_library_ms, events; _device_ms, profiler); "
                   "'wide' holds the same at (16,256,512,64->64)",
          "wide": k2_times(rows[K2_FULL[1]]),
          "resblock_fwd_ms": k2_block_ms["bfloat16", "k2_fwd"],
          "resblock_fwd_library_ms": k2_block_ms["bfloat16", "lib_fwd"]}

    phase("15 the data pipeline on the card at the trainer's source shape")
    pre_rates = preprocess_phase(card, dev)

    phase("16 the trainer end to end (main path): python -m "
          "sggan_tpu_torch.main")
    work = os.path.join(REPO, "_smoke")
    if os.path.isdir(work):
        shutil.rmtree(work)
    e2e = trainer_phase(card, dev, work)

    phase("17 U-Net and pix2pix forward at 128x128, ngf 64, f32, card vs "
          "CPU")
    unet_fwd_errs = unet_forward_phase(card, dev)

    phase("18 K1 forward and backward vs plain at every site of the U-Net's "
          "paths")
    unet_k1 = unet_k1_phase(card, dev, errs, bwd_errs)

    phase("19 the p2p U-Net step on the card (main path)")
    unet_cells = unet_step_phase(card, dev)

    phase("20 the default CLI end to end (main path): python -m "
          "sggan_tpu_torch.main with no net or loss flag, then "
          "--use_pix2pix")
    dflt = default_cli_phase(card, dev, work,
                             os.path.join(work, "datasets", "city"))

    phase("21 /translate with the U-Net at 128x128 and its forward times")
    unet_srv = unet_serve_phase(card, dev)

    phase("22 the cycle step f32, card vs CPU (ResNet, and U-Net with its "
          "four mask sets)")
    cyc_parity = cycle_card_vs_cpu_phase(card, dev)

    phase("23 K1 forward and backward vs plain at every new site of the "
          "cycle paths")
    cyc_k1, cyc_k1_sites = cycle_k1_phase(card, dev, errs, bwd_errs)

    phase("24 the cycle step at 256x512, bf16, b=8, and its batch sweep "
          "(main path)")
    cyc = cycle_step_phase(card, dev)

    phase("25 the cycle CLI end to end (main path): python -m "
          "sggan_tpu_torch.main --loss_mode cycle")
    cyc_cli = cycle_cli_phase(card, dev, work,
                              os.path.join(work, "datasets", "city"))

    phase("36 data parallelism, part 2 (main path): python -m "
          "sggan_tpu_torch.main --mesh_data 2 at full width over two gloo "
          "ranks sharing the card")
    dp_res = dp_train(card, dev, work, e2e)

    phase("37 spatial sharding, part 2 (main path): python -m "
          "sggan_tpu_torch.main --mesh_space 2 at full width over two gloo "
          "ranks sharing the card; K1's split passes timed")
    t37 = time.perf_counter()
    sp_job = sp_cli_job(work)
    sp_res = sp_train(card, dev, work, sp_job)
    sp_res["k1_times"] = sp_k1_times(card, dev)
    sp_res["p2p"] = sp_p2p_train(card, dev, work, sp_job)
    t37 = time.perf_counter() - t37

    procs, tf_job = [], None
    try:
        def follow_start():
            # the untimed rest of phase 36 (part 1's parity ranks at 32x64,
            # part 2's resume, test and the NCCL attempt), of phase 37
            # (part 1, the resumes, the 512x1024 step) and phase 35's
            # recon eval, beside the rest of phase 26 (after its exports:
            # both at once crowd the host's 8 cores)
            started.update(dp=dp_follow_start(work), sp=sp_follow_start(work),
                           recon=recon_start(work, os.path.join(
                               work, "datasets", "city")))
            procs.extend([started["recon"], *(
                x for v in (*started["dp"].values(),
                            *started["sp"].values()) for x in v)])
        started = {}
        phase("26 the exported artifact on the card (main path): python -m "
              "sggan_tpu_torch.serve --export, then --artifact")
        art = artifact_phase(card, dev, work,
                             os.path.join(work, "datasets", "city"),
                             after_exports=follow_start)
        phase("36 data parallelism, part 1 against one process averaging "
              "both shards, every loss mode at 32x64; part 2's resume and "
              "--phase test; NCCL at world 2")
        dp_res.update(dp_follow_check(card, dev, work, started["dp"]))
        phase("37 spatial sharding, part 1 against one process on the "
              "whole plane, the four step cases at 32x64 on 2 and 4 gloo "
              "ranks; part 2's resume; one step at 512x1024 on a 2 x 2 "
              "grid; NCCL")
        t = time.perf_counter()
        sp_res.update(sp_follow_check(card, dev, work, started["sp"]))
        t37 += time.perf_counter() - t
        print(f"  phase 37: {t37:.1f} s in its own sections (part 1, the "
              "resume and the 512x1024 step ran beside phase 26)")
        recon_out = recon_wait(work, started["recon"])

        phase("27 the inference cell: the artifact at b=1 and b=16 beside "
              "the eager forward")
        cell = inference_cell_phase(card, dev, work, art)

        # on the host beside phases 29 and 33, whose fresh process leaves
        # the other cores idle: phase 28's bundles and import (the card
        # briefly; it ends before phase 32 needs the card's memory to
        # itself), import_tf --selftest and the native CRF at 512x1024x34
        tf_job = tf_import_start(work)
        selftest = selftest_start(work)
        crf_big = crf_timer_start(CRF_BIG)
        procs += [tf_job, selftest, crf_big]
        phase("29 CUDA graphs (main path): --scan_steps K in every loss "
              "mode, eager beside the graph; the forward graphs")
        fresh = run_fresh(card, "graphs_hist_phases", 1060)
        graphs, hist, orbax_res = fresh["graphs"], fresh["hist"], \
            fresh["orbax"]
        nccl_res = fresh["nccl_graph"]
        phase("39 the multi-rank step as a CUDA graph, part 2 (main path): "
              "python -m sggan_tpu_torch.main --mesh_data 2 and --mesh_space "
              f"2 --scan_steps {NCCL_K} over two NCCL ranks, a card each")
        nccl_res.update(nccl_graph_cli(card, work))
        for d, e in (("fwd", errs), ("bwd", bwd_errs)):
            for dt in (torch.float32, torch.bfloat16):
                e[dt] = max(e[dt], hist["k1_max_abs_err"][d][str(dt)[6:]])
        t = time.perf_counter()
        tf_out = (*tf_job.communicate(timeout=600), tf_job.returncode,
                  time.perf_counter() - t)

        # phases 30-32 print their own headers
        forms = run_fresh(card, "forms_phases", 700)
        phase("28 the reference-TF2 import at full width: python -m "
              "sggan_tpu_torch.utils.import_tf, then the service")
        tf_imp = tf_import_phase(card, dev, work, tf_out, selftest)

        phase("34 the default CLI with --compat_fake_history --eval_crf "
              f"--scan_steps {HIST_CLI_K} (main path); the native CRF; "
              "the MFU of the graph steps")
        hist["cli"] = hist_cli_phase(card, dev, work,
                                     os.path.join(work, "datasets", "city"),
                                     crf_big, graphs)
    finally:
        for p in procs:
            if p.poll() is None:
                if p is tf_job:  # and its import_tf child
                    os.killpg(p.pid, signal.SIGKILL)
                else:
                    p.kill()
                p.communicate()
    dp_par = dp_res["parity"]

    phase("35 the memory probe (python -m sggan_tpu_torch.utils.hbm) and "
          "python -m sggan_tpu_torch.cycle_recon_eval")
    tools = probe_recon_phase(card, work, recon_out)
    shutil.rmtree(work)

    def entry(name, d, replaces, launches, errs_d):
        return {"name": name, "route": "cuda",
                "source": "sggan_tpu_torch/csrc/instance_norm.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs_d.values()),
                "max_abs_err_f32": errs_d[torch.float32],
                "ms": k1[d, "ms"], "plain_ms": k1[d, "plain_ms"],
                "bound_ms": k1[d, "bound_ms"], "bound_by": "bytes",
                "floor_ms": k1[d, "floor_ms"],
                "library_ms": k1[d, "library_ms"],
                "device_ms": k1[d, "device_ms"],
                "routes": routes[d],
                "sites": [{"site": [r["n"], *r["hwc"]], "calls": r["calls"],
                           "route": r[f"{d}_route"],
                           "cluster": r[f"{d}_cluster"],
                           "ms": r[f"{d}_ms"],
                           "device_ms": r[f"{d}_device_ms"],
                           "bound_ms": r[f"{d}_bound_ms"],
                           **{k[len(d) + 1:]: v for k, v in r.items()
                              if k.startswith(d + "_") and k.endswith("_ms")
                              and k.split("_")[1] in (
                                  "cluster", "stream", "scalar")}}
                          for r in k1_sites],
                "ms_is": "sum over the 37 instance-norm calls of one b=16 "
                         "bf16 train step, per site with CUDA events "
                         "(wrapper included); device_ms the same from "
                         "torch.profiler; routes: calls per step"}

    fwd = entry("instance_norm_fwd", "fwd", "sggan_tpu/ops/pallas_in.py:107",
                train_fwd, errs)
    fwd["launches_serving"] = main_launches
    # the exported artifacts (phase 26): one b=1 forward each in a fresh
    # process, and the service on the ResNet's
    fwd["launches_artifact"] = {k: v["k1"]
                                for k, v in art["res"]["fresh_k1"].items()}
    fwd["launches_artifact_service"] = art["res"]["http_launches"]
    fwd["launches_artifact_is"] = (
        "K1 calls of one b=1 forward of each exported artifact in a fresh "
        "process (phase 26); _service: the warm-up and four requests of "
        "the service on the ResNet artifact")
    bwd = entry("instance_norm_bwd", "bwd", "sggan_tpu/ops/norm.py:97",
                train_bwd, bwd_errs)
    bwd["replaces_pallas_vjp"] = "sggan_tpu/ops/pallas_in.py:141"
    for d, ent in (("fwd", fwd), ("bwd", bwd)):
        ent["launches_trainer"] = e2e["trainer_launches"][d]
        ent["routes_trainer"] = e2e["trainer_routes"][d]
        ent["launches_trainer_is"] = (
            "calls in one in-process epoch of the trainer (phase 16): "
            f"{E2E_TRAIN // E2E_B} steps at b={2 * E2E_B}"
            + (" and the eval's generator forward" if d == "fwd" else ""))
        # the default nets (phases 18-20)
        ent["launches_default_cli"] = dflt["trainer_launches"][d]
        ent["routes_default_cli"] = dflt["trainer_routes"][d]
        ent["launches_default_cli_is"] = (
            "calls in one in-process epoch of the default config (phase "
            f"20): {DEFAULT_TRAIN} U-Net p2p steps at b={UNET_B}, 128x128"
            + (" and the eval's generator forward" if d == "fwd" else ""))
        ent["unet_step_per_step"] = {
            k: {"calls": c["k1_per_step"][d],
                "routes": c["k1_routes_per_step"][d]}
            for k, c in unet_cells.items()}
        ent["unet"] = {
            f"{h}x{w}": {"ms": tot[d, "ms"], "device_ms": tot[d, "device_ms"],
                         "plain_ms": tot[d, "plain_ms"],
                         "bound_ms": tot[d, "bound_ms"],
                         "library_ms": tot[d, "library_ms"],
                         "sites": [{"site": [r["n"], *r["hwc"]],
                                    "calls": r["calls"],
                                    "route": r[f"{d}_route"],
                                    **{k[len(d) + 1:]: v for k, v in r.items()
                                       if k.startswith(d + "_")
                                       and k.endswith("_ms")}}
                                   for r in rows]}
            for (h, w), (tot, rows) in unet_k1.items()}
        ent["unet_is"] = ("the U-Net's 15 calls of one b=2 bf16 forward or "
                          "backward at each size, by site (phase 18)")
        # the cycle mode (phases 23-25)
        ent["cycle_step_per_step"] = {
            "calls": cyc["cell"]["k1_per_step"][d],
            "routes": cyc["cell"]["k1_routes_per_step"][d]}
        ent["launches_cycle_cli"] = cyc_cli["trainer_launches"][d]
        ent["routes_cycle_cli"] = cyc_cli["trainer_routes"][d]
        ent["launches_cycle_cli_is"] = (
            "calls in one in-process epoch of the cycle CLI (phase 25): "
            f"{CYCLE_CLI_TRAIN // CYCLE_CLI_B} steps at b="
            f"{2 * CYCLE_CLI_B}"
            + (" and the eval's a2b forward" if d == "fwd" else ""))
        ent["cycle"] = {
            "ms": cyc_k1[d, "ms"], "device_ms": cyc_k1[d, "device_ms"],
            "plain_ms": cyc_k1[d, "plain_ms"],
            "bound_ms": cyc_k1[d, "bound_ms"],
            "library_ms": cyc_k1[d, "library_ms"],
            "sites": [{"site": [r["n"], *r["hwc"]], "calls": r["calls"],
                       "route": r[f"{d}_route"],
                       **{k[len(d) + 1:]: v for k, v in r.items()
                          if k.startswith(d + "_") and k.endswith("_ms")}}
                      for r in cyc_k1_sites]}
        ent["cycle_is"] = (f"the {CYCLE_K1_PER_STEP} calls of one b="
                           f"{CYCLE_B} bf16 cycle step, by site (phase 23)")
        # the CUDA graphs (phase 29)
        ent["launches_graph_capture"] = {
            k: v["k8"]["k1_at_capture"][d]
            for k, v in graphs["steps"].items()}
        ent["graph_kernels_per_replay"] = {
            k: v["k1_kernels_per_replay"][d]
            for k, v in graphs["steps"].items()}
        ent["launches_graph_capture_is"] = (
            "K1 calls by route recorded at the capture of each step cell's "
            "CUDA graph, one step's (phase 29); graph_kernels_per_replay: "
            "the calls its kernels in a profiler window of the replays "
            "make, per replay")
        # --compat_fake_history (phases 33-34)
        ent["hist_step_per_step"] = {
            k: {"calls": c["k1_per_step"][d],
                "routes": c["k1_routes_per_step"][d]}
            for k, c in hist["step"].items()}
        ent["launches_hist_graph_capture"] = hist["graph"]["k8"][
            "k1_at_capture"][d]
        ent["hist_step_per_step_is"] = (
            "calls of one bf16 --compat_fake_history step of the default "
            "config (the discriminator over the history of 9 + b and over "
            "[seg; history]) at 128x128 b=2 and 256x512 b=8 (phase 33); "
            "launches_hist_graph_capture: by route, recorded at the "
            "capture of that step's graph at 128x128")
        # --remat (phase 32)
        ent["launches_remat"] = {k: v["k1_remat"][d] for k, v in
                                 forms["remat"]["steps"].items()}
        ent["launches_remat_is"] = (
            "calls of one step's forward and backward under --remat in "
            "each step cell of phase 32 (without it: "
            + ", ".join(f"{k} {v['k1_plain'][d]}" for k, v in
                        forms["remat"]["steps"].items()) + ")")
        # --mesh_data 2 (phase 36): per rank, per step
        i = 0 if d == "fwd" else 1
        ent["launches_dp"] = {
            "sggan_resnet_256x512_cli": dp_res["launches_dp"][d],
            **{k: v["k1_per_rank_per_step"][i] for k, v in dp_par.items()}}
        ent["launches_dp_is"] = (
            "K1 calls per rank per step of the data-parallel step over two "
            "gloo ranks sharing the card (phase 36): the full-width ResNet "
            f"sggan CLI (b={DP_CLI_B} doubled to {2 * DP_CLI_B}, "
            f"{DP_CLI_B} a rank; the non-coordinator rank's calls over "
            "the epoch's steps) and part 1's modes at 32x64")
        ent["launches_dp_graph"] = nccl_res["steps"]["sggan_resnet_b16"][
            f"k{GRAPH_CHUNKS[0]}"]["k1_at_capture"][d]
        ent["launches_dp_graph_is"] = (
            "K1 calls by route recorded at the capture of the data-parallel "
            "ResNet sggan step over a group of one NCCL rank (phase 39, "
            f"256x512 b={B_TRAIN}), launched by every replay")
    print(card)
    print(json.dumps({"e2e": {
        "config": "perf_epoch_e2e fused-aug: 96 PNG triplets 512x1024, "
                  "b=12 doubled to 24, 256x512 bf16 sggan ResNet, "
                  "host_downscale 2, 3 epochs",
        **{k: v for k, v in e2e.items() if not k.startswith("trainer_")},
        "preprocess_img_per_s": {
            f"ds{ds}_photometric_{'on' if pho else 'off'}": r
            for (ds, pho), r in pre_rates.items()}}}))
    print(card)
    print(json.dumps({"unet": {
        "config": "the CLI default: U-Net generator ngf 64, semantic "
                  "discriminator ndf 64, p2p loss, dropout on, bf16, 34 "
                  "classes; step cells from synthetic batches (phase 19), "
                  "the CLI on phase 16's PNG set at 128x128 (phase 20)",
        "f32_card_vs_cpu_max_abs": unet_fwd_errs, "step": unet_cells,
        "default_cli": {k: v for k, v in dflt.items()
                        if not k.startswith("trainer_")},
        **unet_srv}}))
    print(card)
    print(json.dumps({"cycle": {
        "config": "bench.py:221-256's cycle cell: ResNet generators ngf "
                  "64, semantic discriminators ndf 64, 256x512, 34 "
                  "classes, pool 50, bf16, identity 5, gradient loss 5; "
                  "synthetic batches (phase 24), the CLI on phase 16's "
                  "PNG set with a 48-triplet trainB, --train_size 48, "
                  "b=4 doubled to 8 (phase 25)",
        "f32_card_vs_cpu": cyc_parity, "step": cyc["cell"],
        "sweep": cyc["sweep"], "falls_at_b_ge_12": cyc["falls_at_b_ge_12"],
        "cli": {k: v for k, v in cyc_cli.items()
                if not k.startswith("trainer_")}}}))
    print(card)
    print(json.dumps({"inference": {
        "config": "bench.py:147-175's cell: utils.export.export_generator "
                  "of phase 16's ResNet checkpoint (ngf 64, 256x512) and "
                  "phase 20's U-Net (ngf 64, 128x128), bf16, at b=1 and "
                  f"16; CUDA events over {ART_ITERS} calls after "
                  f"{ART_WARMUP}; profiler over 3",
        **cell, "artifacts": art["res"], "tf_import": tf_imp}}))
    print(card)
    print(json.dumps({"graphs": {
        "config": "phase 29: the trainer's loop over a resident split made "
                  "on the card (sources twice the image size), eager "
                  "(--scan_steps 1) beside K steps a chunk through one "
                  "CUDA graph of the step; the ResNet sggan step 256x512 "
                  "b=8 doubled to 16, the default p2p U-Net and the "
                  "pix2pix pair 128x128 b=1 doubled to 2, the ResNet "
                  "cycle step 256x512 b=4 doubled to 8, bf16; "
                  f"the gate over {GRAPH_STEPS} steps with cuDNN "
                  "deterministic, the times with its default; the forward "
                  "graphs of evaluate.generate",
        **graphs}}))
    print(card)
    print(json.dumps({"forms": {
        "config": "phases 30-32: the reflect pad and conv at c1 (16,256,512,"
                  "3->64, k7) and a resblock conv (16,64,128,256->256, k3), "
                  "f32 and bf16; the 7x7 64->3 head at b=8 and 16, "
                  "256x512, bf16; --remat in the ResNet sggan step 256x512 "
                  "b=16, the p2p U-Net 128x128 b=2 and the ResNet cycle "
                  "step 256x512 b=8, bf16; the largest batch of the ResNet "
                  "sggan step at 2048x1024 and the cycle step at 512x1024",
        **forms}}))
    print(card)
    print(json.dumps({"hist_tools": {
        "config": "phase 33: --compat_fake_history with the default nets "
                  "(U-Net ngf 64, semantic D ndf 64, p2p, dropout, 34 "
                  "classes, bf16), 128x128 b=1 doubled to 2 (a history of "
                  "11) and 256x512 b=4 doubled to 8 (17), the step's graph "
                  "at 128x128; phase 34: the default CLI with "
                  "--compat_fake_history --eval_crf --scan_steps 4 on "
                  "phase 16's PNG set, --train_size 48; the native CRF on "
                  "one host thread; the MFU of phase 29's graph steps; "
                  "phase 35: utils.hbm's sggan ResNet step at 2048x1024, "
                  "cycle_recon_eval on phase 25's checkpoint",
        **hist, **tools}}))
    print(card)
    print(json.dumps({"dp": {
        "config": "phase 36: two gloo ranks sharing one card (LOCAL_RANK "
                  "0), not a scaling number; part 1 every loss mode at "
                  "32x64, ngf and ndf 4, f32, a shard of 2, 3 steps, "
                  "against one process averaging both shards; part 2 "
                  "python -m sggan_tpu_torch.main --mesh_data 2, ResNet "
                  f"sggan 256x512 bf16, b={DP_CLI_B} doubled to "
                  f"{2 * DP_CLI_B}, --train_size {DP_CLI_TRAIN}, 1 epoch "
                  "on the split resident on each rank (--scan_steps 8, "
                  "eager chunks) and on the host iterator "
                  "(--device_dataset_mb 0), then --phase test and "
                  "--continue_train; the p2p ResNet f32 at "
                  f"{H // 2}x{W // 2}, b={DP_P2P_B} doubled, on both paths",
        **dp_res}}))
    print(card)
    print(json.dumps({"sp": {
        "config": "phase 37: gloo ranks sharing one card (LOCAL_RANK 0), "
                  "not a scaling number; part 1 the ResNet sggan step at "
                  "data 2 x space 2 and space 2 x wspace 2, the U-Net "
                  "sggan step at space 2 with its shards' masks, the ResNet "
                  "cycle step at space 2, the pix2pix p2p step at space 2 "
                  "and space 2 x wspace 2 with its masks, 32x64, ngf and "
                  "ndf 4, f32, 2 samples a data row, one step each against "
                  "one process on the whole plane; part 2 python -m "
                  "sggan_tpu_torch.main --mesh_space 2, ResNet sggan "
                  f"256x512 bf16 ngf and ndf 64, b={SP_CLI_B} doubled to "
                  f"{2 * SP_CLI_B}, --train_size "
                  f"{SP_CLI_TRAIN}, 1 epoch and a resume, and the same "
                  "with --use_pix2pix --loss_mode p2p (p2p), then its "
                  "one-process --phase test; one step at "
                  f"{SP_WIDE[0]}x{SP_WIDE[1]} b={SP_WIDE[2]} on a 2 x 2 grid",
        **sp_res}}))
    print(card)
    print(json.dumps({"nccl_graph": {
        "config": "phase 39: part 1 the data-parallel step over a group of "
                  "one NCCL rank on the card, phase 29's ResNet sggan cell "
                  f"(256x512 b={B_TRAIN}) and pix2pix cell (128x128 b=2), "
                  f"{GRAPH_STEPS} eager steps against the step's graph; part "
                  "2 (two cards) the ResNet sggan CLI with --mesh_data 2 and "
                  f"--mesh_space 2, --scan_steps {NCCL_K}, NCCL against "
                  "gloo",
        **nccl_res}}))
    print(card)
    print(json.dumps({"orbax": {
        "config": "phase 38: the committed fixtures of tests/golden/orbax "
                  "(the JAX package's CLI's checkpoints: the ResNet sggan "
                  "with --gen_ema, the pix2pix pair, the ResNet cycle "
                  "mode; ngf and ndf 1, 32x64, f32) through the port's "
                  "--phase test, the service and --continue_train of "
                  f"{ORBAX_K} steps through the step's graph; the zstd "
                  f"decoder over their frames repeated to {ORBAX_MB} MB",
        **orbax_res}}))
    from sggan_tpu_torch.perf_in import EVENT_TIMED
    print(f"  profiler: {len(EVENT_TIMED)} device_ms calls found no kernel "
          f"in any trace and were timed by CUDA events: {EVENT_TIMED}")
    kt = sp_res["k1_times"]
    sp_par = sp_res["parity"]
    sp_entries = []
    for d, p, err, replaces in (
            ("fwd", "apply", "fwd_err", "sggan_tpu/ops/pallas_in.py:107"),
            ("bwd", "bwd_apply", "dx_err", "sggan_tpu/ops/norm.py:97")):
        sp_entries.append({
            "name": f"instance_norm_sp_{d}", "route": "cuda",
            "source": "sggan_tpu_torch/csrc/instance_norm.cu",
            "replaces": replaces,
            "replaces_spatial": "sggan_tpu/parallel/spatial.py:167",
            "launches": sp_res["ranks"][1]["k1_split"][p],
            "launches_per_step": sp_res["launches_sp"][d],
            # bf16 at the CLI's own sites (part 2); f32 at part 1's
            "max_abs_err": max(x["sites_check"][err]
                               for x in sp_res["ranks"]),
            "max_abs_err_f32_part1": max(v["sites_check"][err]
                                         for v in sp_par.values()
                                         if err in v["sites_check"]),
            "ms": kt[f"{d}_ms"], "plain_ms": kt[f"{d}_plain_ms"],
            "bound_ms": kt[f"{d}_bound_ms"], "bound_by": "bytes",
            "library_ms": kt[f"{d}_library_ms"],
            "launches_sp_cases": {k: v["k1_split_per_rank_per_step"][p]
                                  for k, v in sp_par.items()},
            "ms_is": "the two passes (stats, then apply) at a rank's "
                     f"resblock block {kt['site']} bf16 relu, CUDA events, "
                     "without the all-reduce between them; launches: the "
                     "non-coordinator rank's calls of the pass-2 entry in "
                     "phase 37's CLI epoch (the pass-1 entry's are equal)"})
    for ent in (fwd, bwd, k2, *sp_entries):
        ent["device_ms_calls_timed_by_events"] = len(EVENT_TIMED)
    print(card)
    print(json.dumps({"kernels": [fwd, bwd, k2, *sp_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
