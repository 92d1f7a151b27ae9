#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the kernels,
holds each against its plain PyTorch version, drives every inference path
(the default and served routes, O mode, host post-processing, frozen
artifacts, the CLIs) and the training path (the train step against the
CPU, full-width steps, the solver, the data, train and export CLIs, a
synthetic fine-tune scored on a holdout before and after), builds the
native host library, runs the data-parallel paths (training over NCCL,
sharded detection, a data-parallel frozen artifact) over every visible
card, holds the captured detect programs and the captured train step (CUDA
graphs, replayed) against the eager ones, holds the card's records against
the CPU's, runs the serving and streaming load scripts and the server
under load, and checks what comes out.

On the card every ``run_batch`` of the predictors and of the frozen
artifacts replays a captured program after the first call of its shape
(``ctpn_tpu_torch/inference/graphs.py``), and every training step of the
solver and of the DDP ranks replays a captured step after its warm-up
(``ctpn_tpu_torch/training/graphs.py``); the kernels' launch counts are
recorded at capture and added per replay, so every launch gate below
counts through replays. Every bf16 detect program also launches the conv
epilogue once per conv of the trunk and ``rpn_conv``: 14 per program run on
the default route and in O mode, 12 on the served route (the stem kernel
runs block 1), 14 per image on the host path; and every CTPN program
launches the connector's successor graph and chain walk once each per run
(none on the host path, whose connector is NumPy's). The launch gates
below count them beside the kernels they name; training and float32
launch no epilogue, training no connector kernel.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --east
    python3 chip_smoke.py --craft
    python3 chip_smoke.py --resize-concat
    python3 chip_smoke.py --db

``--east`` runs phases 1, 2 and 25 alone (EAST) and prints their line and
the card line; ``--craft`` runs phases 1, 2 and 26 alone (CRAFT; the
program's part only once its weights are committed); ``--resize-concat``
runs phases 1, 2 and 27 alone (the decoders' skip inputs); ``--db`` runs
phases 1, 2 and 28 alone (DBNet; the program's part only once its weights
are committed).
``--kernels-only`` stops after phase 3 and prints the ``kernels`` line
(without launch counts) and the card line, but no final result line: to
compare two checkouts' kernels on one card, run each checkout's own copy
in one call.

Phases (any failure exits non-zero and prints no result line):

1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles every kernel from ``ctpn_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, in parallel), prints the build time and each
   kernel's registers, shared memory, spills and ptxas performance notes.
3. kernels: each kernel against its plain version on the card, at its
   path's shapes and on edge cases (NMS: K one past a block, caps reached
   on a block's last box and mid-chain, a batch of unequal survivor
   counts, near-threshold pairs; bitmask: N around the multiples of its
   words and tiles, an invalid box in a diagonal word, boxes that touch
   without overlapping; resolve: N around a word, every cluster size, all
   invalid, all identical, long in-word chains; stem: both served buckets, partial and
   sub-tile images, weights changed between calls; conv epilogue: odd
   sizes, 3 channel groups, no bias, -0.0, NaN and infinities, then the
   default route's 14 sites at batch 48 and 608x912 on the photos with
   the shipped weights, each against the separate passes as the trunk ran
   them, ``F.conv2d`` with its bias, ``F.relu``, ``F.max_pool2d``; chain
   walk: made-up forests with shared tails, no edges, a chain past the
   cap, P off the CTA and past shared memory, successors out of range,
   then the program's own successor graphs at (48, 1000) from the
   benchmark cell's renders; successor graph: strip scenes, ties in the
   nearest column on both sides, column gaps at and past ``max_gap``,
   overlap and similarity at their thresholds, no valid node, one node,
   the 16-px anchor grid at P off the CTA, past 48 KB of shared memory,
   with its inputs read from global memory (12000) and with its keys in
   global memory (16385), other settings, then the program's own
   proposals at (48, 1000) from the benchmark cell's renders, and
   ``torch.profiler`` over ``detect_lines`` on them). The
   conv epilogue must equal its plain version and those passes bit for
   bit; its ms per site is printed beside its byte bound, the plain
   version's and the PyTorch passes' on the bias-less output
   (``library_ms``). The chain walk must equal its plain version bit for
   bit, on the card and on the CPU, and is timed beside the dense closure
   it replaced (``library_ms``). The successor graph must equal its plain
   version (the dense form it replaced) bit for bit, on the card and, up
   to P 2500 and on the program's proposals, on the CPU; it is timed
   beside its bound, and ``detect_lines`` must run no op with an input of
   N x P x P elements (its kernels counted and timed). The fused NMS keep
   mask's prefix, the bitmask words and the resolve's keep flags must be
   identical (tolerance 0: integer outputs), and the resolve must also
   give the fused kernel's uncapped keep mask on the same boxes; the
   stem's max relative error ``|a-b|/(|b|+1)`` must be below 1e-2 (bf16
   resolution, the JAX package's tolerance). Times the wrapper (the
   ``torch.library`` op), the launcher alone (``launch_ms``: the op
   dispatch is the difference), the plain version, and for the stem the
   stock cuDNN block (``stock_ms``).
4. main path: ``CTPNPredictor(device="cuda")`` with the shipped weights
   (``data/artifacts/ctpn_synth_f16.npz``), default config, runs
   ``detect_image`` on the five committed demo photos with launch counts
   zeroed just before; the fused NMS must launch exactly twice per image.
   The same detection with the plain NMS must pair one-to-one within
   0.5 px, and the records must recover the committed reference results
   (``docs/demo_results/H/res_*.txt``). Then ``run_batch`` at batch 8 on
   the 608x912 bucket, timed.
5. serving path (``TPU.NMS_FUSED = False``, ``TPU.FUSED_STEM = True``): the
   fused-stem model's ``cls_prob`` on the photos against the same model with
   the stem's plain version and against the stock-stem model (atol 2e-2 in
   the served bf16 trunk; 5e-3 for kernel against plain version with an f32
   trunk, where only the stem rounds to bf16); one batch of 8 through
   ``run_batch`` on the bitmask route with the stock stem must give the
   default route's records exactly (0.0 px, same counts), and the records
   the fused stem moves are counted; ``DetectionServer``
   in-process answers 8 concurrent POSTs (the photos plus 3 repeats) with
   counts zeroed just before: every response 200 with finite records,
   fewer batches than requests, exactly 2 bitmask, 2 resolve and 1 stem
   launches per batch and no fused-NMS launch, >= 75 % of the committed
   reference lines found. Then ``stream_detect`` over the photos with the
   same accounting; ``nms_keep_sorted`` on the bitmask route at (8,12000)
   and (8,1000) with device-to-host syncs made an error; and ``run_batch``
   at batch 8 timed with its resolve launches and the host syncs made
   while the batch is issued, the fetch outside (the plain resolve's sweep
   count must not move; only the sync debug mode's own warning counts as
   a sync).
6. serve CLI: ``python3 -m ctpn_tpu_torch.cli.serve ... --set
   TPU.NMS_FUSED False TPU.FUSED_STEM True`` as a subprocess answers one
   POST with 200 and ``count > 0``.
7. O mode: ``CTPNPredictor(mode="O")`` runs a batch of 8 with exactly 2
   fused-NMS launches and no other kernel (timed), then ``detect_image``
   on the photos: >= 75 % of ``docs/demo_results/O/res_*.txt``.
8. host post-processing: ``detect_image_host`` in H and O on the photos,
   no kernel launch, >= 75 % of ``H_host`` and ``O_host``; host ms per
   image.
9. frozen artifacts: ``export_frozen`` on the card, the default route at
   1x608x912, 1x912x608, 8x608x912, 8x912x608 and the served route at
   8x608x912; a subprocess that cannot import ``ctpn_tpu_torch.models``
   loads both and runs the batch of 8: 2 fused-NMS launches (default) and
   2 bitmask, 2 resolve, 1 stem launches (served) from inside the
   programs, counts equal to the live pipeline's, records paired within
   0.5 px (the largest float difference is printed); then the default
   artifact's ``detect_image`` on the photos: >= 75 % of ``H``.
10. CLIs as subprocesses: ``ctpn-torch-demo`` on the photos, scored by
    ``ctpn-torch-eval`` (recall >= 0.75 against ``H``); ``ctpn-torch-export
    --frozen`` (batch-1 programs) then ``ctpn-torch-demo --frozen``, scored
    the same; ``ctpn-torch-serve`` on phase 9's default artifact answers
    one POST per bucket.
11. training parity: one Adam step at full VGG16 width on 2x256x384, f32
    compute with TF32 off, on the card and on the CPU from the same
    parameters (``init_params``), batch and anchor-target draws:
    anchor-target labels identical, ``bbox_targets`` within 1e-5, total
    loss and raw gradient norm within 1e-4 relative, the update within
    1e-3 * lr wherever the CPU gradient exceeds 1e-6 (2 * lr below it,
    where rounding decides the sign Adam steps by).
12. full-size steps: 608x912, bf16, Adam, batch 1 and 2, ``TPU.REMAT``
    off and on, through ``TrainGraphs``: the first call (the eager warm-up
    step and the capture), then the state rewound in place and the same
    step replayed, twice: the two replayed steps equal bit for bit; peak
    ``max_memory_allocated`` over the first call; REMAT must give plain's
    loss and update (as in phase 11) on the eager and on the replayed
    step, at a lower peak. Phases 11-12 launch none of the four kernels.
13. training entry points, in a temporary ``ROOT_DIR``: the port's
    ``synth.generate_dataset`` (one image), ``ctpn-torch-prepare --link``,
    30 steps of ``SolverWrapper`` on it (the mean model loss of the last 5
    below that of the first 5), ``ctpn-torch-train`` for 10 steps with a
    snapshot at 5, then, with checkpoint 10 set aside, ``--restore`` to 10
    (first logged iteration 6; the solver's steps replay their captured
    step): steps 6-10 log the uninterrupted run's metrics and the state
    saved at 10 (parameters, moments, draw generator) is its state, bit
    for bit; ``ctpn-torch-export --ckpt``, ``ctpn-torch-demo`` on the
    export: 2 fused-NMS launches per photo plus 2 for its warm-up, no other
    kernel; the training runs launch none.
14. training quality and host ops: the native host library built by the
    host compiler and held against the numpy oracles (the cases of
    ``tests/test_torch_native.py``: keep lists and successors identical,
    overlaps within 1e-6); then, in a temporary root, from the shipped
    weights: ``train_synth.prepare_corpus`` on 48 + 16 synthetic images
    (timed), ``eval_holdout`` on the 16 holdout images (F before),
    ``train_synth`` for 120 iterations at batch 8, lr 2e-5, step at 80, in
    two segments of 60 (child processes), then its export and score, and
    ``eval_holdout`` on the export (F after). Gates: finite losses, the
    second segment's first logged iteration 61, the mean logged model loss
    <= 0.30, geometric F @ 0.5 after >= before - 0.05, 2 fused-NMS launches
    per holdout batch of ``stream_detect`` and no other kernel in each
    detection, none in training. Prints ms per step at batch 8, the
    preparation seconds and the checkpoint's MiB.
15. multi-card: ``python -m ctpn_tpu_torch.parallel.multicard`` in this
    process over every visible card (``multicard.run()``; one card: two
    replicas on it, one NCCL rank), with its gates: sixteen NCCL DDP steps
    at 608x912 in bf16, one image per rank, with a falling loss, the first
    11 eager (DDP's warm-up) and the last five replaying the captured step
    with its all-reduces, then the same sixteen steps from a new DDP model
    on the same parameters, equal bit for bit; one step at
    min(2, cards) ranks, 2x256x384, f32, against one process (phase 11's
    tolerances); ``shard_detect_fn`` on the photo batch of 8, both routes,
    equal bit for bit to one card's ``run_batch`` slice by slice, counts
    equal to one card's on the whole batch (its records' worst pairing
    printed), exact launches per card (2 fused NMS per replica on the
    default route; 2 bitmask, 2 resolve, 1 stem on the served route),
    >= 75 % of the committed lines; the default route exported with
    ``dp_devices`` and run in a process without model code, equal bit for
    bit to the live DP function; no host sync while a replica's batch is
    issued (a ``.item()`` must count as one, so the count is not blind).
    Every replica replays its own captured program on its own stream.
    Launch counts are zeroed before the phase: each kernel must launch in
    it. Prints the module's numbers: DP detect img/s at global batch 8 and
    32 beside one card's replayed and eager program, host syncs per replica
    batch, the cards' kernel overlap, DDP ms per step (eager warm-up and
    replayed) and the NCCL share of a replayed step.
16. captured programs, on the photo batch of 8, for the default route, the
    served route, O mode and the frozen default route (exported here): the
    eager program issued with host syncs made an error; the first
    ``run_batch`` (warm-up run, capture); three replayed batches issued
    with host syncs made an error (the fetch outside), with exactly 2
    fused-NMS launches per batch (default, O, frozen) or 2 bitmask, 2
    resolve and 1 stem (served); the first and replayed records against
    the eager program's: counts equal, records paired within 0.5 px, the
    largest float difference printed (expected 0.0). Prints eager and
    replayed wall ms per batch with the fetch, the device busy share of
    one batch of each (``torch.profiler``), capture seconds and the graph
    pool's MiB. Then the stage clock (``check_stage_clock``): the stamp
    kernel around queued sleeps; with tracing off, a replay's profiler
    trace holds no ``ctpn.*`` event and no stamp kernel; with it on, five
    replays equal to the plain predictor's bit for bit, one row each, the
    ``ctpn.graphs.*`` spans and the stamp kernel in the trace; prints the
    stages' device ms per batch.
17. captured training, parity: 2x256x384, f32 with TF32 off, Adam, from
    the same parameters and draws: ``TrainGraphs`` on the pinned host
    batch (the eager warm-up step, then three replayed steps) against
    eager steps of the bucket's ``TrainStep``, each set to the captured
    side's state before its step: every step's loss and gradient norm
    within 1e-4 relative and its update within phase 11's tolerance; and
    bit for bit (the step runs only reproducible kernels,
    ``train_step.reproducible``): each eager step taken twice from one
    state, each eager step against the captured one (metrics, update,
    gradients), and an eager model that took the four steps on its own
    against the captured model (drift exactly 0.0).
18. captured training at full width: 608x912, bf16, Adam, batch 1, 2 and
    8, ``TPU.REMAT`` off and on: eager against replayed ms per step,
    busy share and kernels per step (``torch.profiler``), capture seconds,
    the graph pool's MiB, peak ``max_memory_allocated`` of an eager step
    and of the first call; three replayed steps issued with host syncs made
    an error (the fetch outside) and finite losses. Phases 17-18 launch
    none of the four kernels (counts zeroed before 17).
19. card against CPU (ROADMAP D1): ``detect_image`` on the five photos in
    float32 with TF32 off, once on the card and once with
    ``device="cpu"`` (the kernels' plain versions: the program the CPU
    tests hold against the JAX package): counts equal and records paired
    one-to-one within 0.5 px. The card's bf16 records of phase 4 against
    the f32 CPU records: largest difference printed, not gated.
20. load: the port's three load scripts as child processes through
    ``run_counted``: ``scripts/torch_bench_serving.py`` (an in-process
    HTTP server, burst 32, sustained 48 mixed-bucket requests) on both
    routes, ``scripts/torch_bench_serving_sustained.py`` (the batcher
    driven directly for 8 s against the replayed rate) and
    ``scripts/torch_bench_streaming.py`` (64 synthetic scenes, then batch-1
    latency). Each: 0 errors, 0 shed, every request answered (200, ``count
    == len(boxes)``, finite records); the burst coalesced; launches in the
    child exactly the route's per program run (2 fused NMS on the default
    route; 2 bitmask, 2 resolve, 1 stem on the served route). Then, on each
    route, an in-process server: the five photos and three repeats in one
    burst with 16 noise requests, each photo's answer equal to its direct
    run (``run_padded`` alone at the same batch: counts exact, records
    within 0.5 px, the largest difference printed), >= 75 % of the
    committed lines; each bucket's photos run alone and in the last slots
    of a batch behind noise give the same raw records bit for bit (the
    stride-16 convs run per image; batched, cuDNN sums the
    last slots' images in another order and a record moved by up to 6.84
    px); and, while 16 clients send 48 requests, one 600x600
    scene in the 608x608 bucket, which nothing warmed: its program is run
    and captured under load, it is answered with its direct run's records,
    and no other request fails (its latency and capture seconds printed).
    Prints p50/p95/p99 and img/s per route and phase, the batcher's
    efficiency, streaming img/s and batch-1 latency beside the card line.
21. prints one ``{"kernels": [...]}`` line (four kernels), the card line,
    and last ``{"ok": true, "device": {...}}``; it runs after phase 24.
22. orbax artifacts (``utils/orbax_io.py``, ``ops/csrc/zstd_decode.cpp``):
    builds the zstd decoder with the host compiler (timed); the committed
    JAX-written fixture (``tests/data/orbax/artifact``, OCDBT and zstd)
    equal to the shipped ``.npz`` widened to float32 bit for bit, and the
    JAX solver step (``tests/data/orbax/solver``) through
    ``ctpn-torch-export --ckpt`` (subprocess) equal to its
    ``state.params``; ``ctpn-torch-export --npy <the .npz> --out <dir>``
    read back on the card, 38 leaves equal to the ``.npz`` route; the
    fixture's leaves overlaid with ``load_pretrained_into`` and
    ``CTPNPredictor`` on those weights over the photos with counts zeroed
    just before: records equal to phase 4's bit for bit, exactly 2
    fused-NMS launches per image and no other kernel, the committed-line
    gates; ``ctpn-torch-serve`` (batch 1) started on the directory and on
    the ``.npz`` answers a POST of 007.jpg with the same records, paired
    with phase 9's within 0.5 px (worst printed). Prints the host seconds to read the
    plain directory, the decoder's MB/s on the fixture and each server's
    seconds to its first answer, beside the card line.

23. slot independence in every bucket (``drive_slot_buckets``): the five
    buckets of ``cfg.TPU.BUCKETS`` (608x608, 608x912, 608x1024, 912x608,
    1024x608), each with the photos that land in it and two renders of
    ``data/synth.py`` sized into it, on the default route, the served
    route and in O mode, at batch 8 (the server's) and 16
    (``stream_detect``'s): each image's raw records in the first slots of
    a batch and in its last slots behind noise JPEGs, equal bit for bit
    (``scripts/torch_slot_dependence.py::slot_runs``), with records in every
    bucket. One capture per shape, by a batch of noise, so that both
    compared batches replay it; freed after it.

24. ``bench_torch.py`` as a subprocess, as a user runs it (its defaults:
    batch 48, 14 replays of the captured program on a batch already on the
    card, the noise and the real row, each row's records gated against an
    eager run), on the default route and under the served route's
    ``BENCH_CFG_SET``, with ``BENCH_CHILD_TIMEOUT_S`` 300: each line
    parseable, ``value`` not null, ``attempts`` 1, ``device`` the card of
    phase 1, ``content`` ``real``, and the launches per replayed batch of
    its report exactly the route's (2 fused NMS; 2 bitmask, 2 resolve, 1
    stem). Prints both lines and reports beside phase 16's replayed ms per
    batch of the route (batch 8, uploaded per call: another figure).
25. EAST (``--east`` runs it alone): the locality-aware walk and the quad
    bitmask kernels against their plain versions bit for bit (cell-like
    runs of 0 to 4000 cells, a cap reached, ties; the bitmask around word
    multiples, identical quads, invalid tails); then EAST's captured
    program on ``data/artifacts/east_vgg16_synth_f16.npz`` at the cell
    ``east_device_b32``'s shape (32 held-out renders, 736x1280): 20 conv
    epilogues, three ``resize_concat`` (the merge branch's skip inputs),
    one walk, one bitmask and one resolve per replayed run,
    replays equal to the first bit for bit and to the eager program, no
    overflow of the caps, every image with records, each image's records
    the same alone and in another slot, the taps and merge maps of four
    slots against each image alone (printed); the conv epilogue at all 20
    sites on that batch, the walk on its own cells and the bitmask on its
    own merged quads, each against its plain version bit for bit; and the
    walk's, the bitmask's and the resolve's ms at the cell's shape beside
    their bounds (the live cells' and quads' bytes at 3.35 TB/s against
    the IoU tests at 112 float ops each at the float32 peak).

26. CRAFT (``--craft`` runs it alone): the labelling and box kernels
    against their plain versions bit for bit (made-up maps of character
    blobs and links at the cell's shape with cut extents, small and wide
    maps, empty maps and extents, a cap reached); then CRAFT's captured
    program on ``data/artifacts/craft_vgg16bn_synth_f16.npz`` at the cell
    ``craft_device_b32``'s shape (32 held-out renders, 736x1280): 23 conv
    epilogues (11 in the trunk, 12 in the batched decoder), four
    ``resize_concat`` (the blocks' skip inputs), one
    ``ccl_label`` and one ``craft_boxes`` per replayed run,
    replays equal to the first bit for bit and to the eager program, no
    overflow of the cap, every image with boxes, each image's maps and
    boxes the same alone and in another slot, the taps and maps of four
    slots against each image alone (printed); the conv epilogue at
    all 23 sites, and both kernels on the program's own maps against their
    plain versions bit for bit; and their ms at the cell's shape beside
    their byte bounds at 3.35 TB/s. No other route launches either kernel
    (every launch gate above counts them at 0).

27. the decoders' skip inputs (``--resize-concat`` runs it alone): the
    ``resize_concat`` kernel against its plain version (``F.interpolate``
    and ``torch.cat`` on the card) bit for bit on made-up maps with -0.0,
    NaN and infinities among the values: uneven ratios (19x29 to 38x57,
    37x57 to 75x113), a shrink, a 1x1 map, equal sizes, narrow and wide
    slices; then at every call site of both cells, on the cells' own
    renders through the trunk at their batch and shape (EAST's three merge
    stages, CRAFT's four blocks), each call checked bit for bit as the
    model makes it; each site's ms beside its byte bound (the low-resolution
    map and the skip read, the concatenated buffer written, at 3.35 TB/s)
    and beside the plain passes' ms. The launch gates of phases 25 and 26
    count it (3 per EAST run, 4 per CRAFT run); every CTPN route and every
    training phase counts it at 0, and so does EAST's and CRAFT's forward
    with gradients on (here).

28. DBNet (``--db`` runs it alone): the deformable conv's kernel against
    its plain version on made-up cases (offsets that leave the map, whole
    pixels, stride 2, zero masks; columns equal but where the sigmoid's
    ``exp`` moves a bfloat16 rounding, the products within a bfloat16
    step), the 8-connected one-channel labelling and the box kernel
    against their plain versions bit for bit (and CRAFT's labelling and
    boxes as phase 26 holds them); then DB's captured program on
    ``data/artifacts/dbnet_r50_dcn_synth.npz`` at the cell
    ``db_device_b32``'s shape (32 held-out renders, 736x1312): 35 conv
    epilogues, 13 deformable convs, 16 residual epilogues, one
    ``ccl_label`` and one ``db_boxes`` per replayed run and no other kernel, replays equal to the first bit
    for bit and to the eager program, no overflow of the cap, each image's
    map and boxes the same alone and in another slot (the slot gate); the
    kernel at each of the 13 sites on the batch's own feature maps against
    its plain version, with its ms beside the site's least time (its bytes
    at 3.35 TB/s or its operations at the bfloat16 peak) and the plain
    version's ms, and the size of the batch's offsets there (mean |dy| and
    |dx|, the share of samples off the whole-pixel grid and off the map,
    the mean mask: ``offset_stats``); both post-process kernels on the batch's own map
    against their plain versions bit for bit, and their ms. Every other
    route's launch gate counts the two new kernels at 0.

29. the bottlenecks' tails (``--residual`` runs it alone): the
    ``residual_epilogue`` kernel against its plain version (PyTorch's bias
    adds, sum and ReLU on the card) bit for bit on made-up maps with -0.0,
    NaN and infinities among the values, each bias on and off, at each
    stage's width, and on adds that round at a tie; then at DB's 16
    bottlenecks on the cell's renders through the trunk at its batch and
    shape, each call against the plain version and against the block's
    tail as PyTorch ran it before the op (conv3 and the projection with
    their biases, the sum, ``F.relu``), bit for bit; each launch's ms
    beside its byte bound (both maps read, the output written, at 3.35
    TB/s) and the plain passes' ms; 16 launches per replayed DB run over
    5 runs, and none with gradients on. Every CTPN, EAST and CRAFT launch
    gate above counts it at 0.

Every recall gate counts lines as ``ctpn-torch-eval`` does
(``eval.match_boxes``: one-to-one, IoU >= 0.5, integer corner boxes).
The photo phases (4, 5, 7-10, 22) also gate precision, the lines matched
over the lines emitted, at ``PRECISION_FLOOR``, and each photo's lines at
twice its committed lines plus three (``line_budget``), as
``tests/test_artifact_quality.py`` gates the JAX package (ROADMAP D2).

Imports nothing of JAX and nothing of the JAX package ``ctpn_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
PHOTOS = [REPO / "docs" / "demo_results" / "H" / n
          for n in ("006.jpg", "007.jpg", "008.jpg", "009.jpg", "010.png")]

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s,
# dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the f32 peak counts a fused multiply-add as two operations; the NMS
# kernels are built without FMAs, so no instruction of theirs counts twice
F32_ISSUE_OPS_PER_S = F32_OPS_PER_S / 2
BF16_TENSOR_OPS_PER_S = 989e12
# least float ops of one IoU pair test with per-box areas precomputed:
# 2 min + 2 max + 4 add/sub (sides), 2 max + 1 mul (inter), 2 add/sub +
# 1 max (union), 1 mul (t * union), 1 compare
IOU_PAIR_OPS = 16
# the warning of CUDA's sync debug mode at each synchronizing operation (not
# the notice printed by the first set_sync_debug_mode of a process)
SYNC_WARNING = "called a synchronizing CUDA operation"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0]


def launch_ms(module, *args):
    """Device time of the kernel's launcher (``module._launch``) called
    directly, without the ``torch.library`` op dispatch that the wrapper
    adds; None for a checkout whose wrappers have no op."""
    launch = getattr(module, "_launch", None)
    return None if launch is None else cuda_ms(lambda: launch(*args), 20)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- NMS inputs


def proposal_like_boxes(rng, batch: int, k: int) -> torch.Tensor:
    """(batch, k, 4) score-sorted boxes shaped like the proposal layer's
    NMS input at 608x912: 16-px-wide anchors of the 38x57x10 grid with
    random y/h deltas, the top ``k`` by a random score."""
    from ctpn_tpu_torch.ops.anchors import shifted_anchors
    from ctpn_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes

    anchors = torch.from_numpy(shifted_anchors(38, 57).copy())
    out = []
    for _ in range(batch):
        deltas = torch.from_numpy(
            rng.uniform(-0.3, 0.3, (len(anchors), 4)).astype(np.float32))
        boxes = clip_boxes(bbox_transform_inv(anchors, deltas), 608.0, 912.0)
        order = np.argsort(rng.uniform(0, 1, len(anchors)), kind="stable")[::-1]
        out.append(boxes[torch.from_numpy(order[:k].copy())])
    return torch.stack(out)


def near_threshold_boxes(rng, n_pairs: int, t: float) -> torch.Tensor:
    """(1, 2*n_pairs, 4) isolated pairs whose IoU is ``t`` before rounding.

    Box b is box a shifted right by d = w(1-t)/(1+t), so IoU(a, b) = t in
    exact arithmetic; rounding the coordinates to f32 leaves each pair's
    ``inter >= t * union`` within a few rounding errors of equality. A pair
    spans less than 2w by h, and the grid step exceeds both with a margin,
    so no box meets a box of another pair: the greedy pass keeps each
    second box iff its own pair's test does not suppress it."""
    w_max, h_max = 120.0, 60.0
    step_x, step_y = 2 * w_max + 8, h_max + 8
    cols = int(np.ceil(np.sqrt(n_pairs * step_y / step_x)))  # square field
    rows = []
    for p in range(n_pairs):
        x = (p % cols) * step_x + rng.uniform(0, 4)
        y = (p // cols) * step_y + rng.uniform(0, 4)
        w = rng.uniform(20, w_max)
        h = rng.uniform(10, h_max)
        d = w * (1 - t) / (1 + t)
        a = [x, y, x + w - 1, y + h - 1]
        rows += [a, [a[0] + d, a[1], a[2] + d, a[3]]]
    return torch.tensor(np.asarray(rows, np.float32))[None]


def pair_tests(boxes: np.ndarray, t: float) -> dict:
    """Each pair's suppression test (second box by first), three ways.

    ``f32``: every step one rounded f32 operation in the kernel's order
    (what the kernel and the plain version must compute); ``f64``: the same
    formula in f64 on the same f32 inputs; ``fma``: f32 with the two
    contractions ``nvcc`` makes by default, ``area_a + area_b`` as
    fma(side, side, area_b) and ``... - inter`` as fma(-iw, ih, ...),
    each emulated with one rounding from f64."""
    f32, f64 = np.float32, np.float64
    a, b = boxes[0::2].astype(f32), boxes[1::2].astype(f32)
    t32 = f32(t)

    def parts(a, b, one):
        iw = np.maximum((np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0])) + one, 0)
        ih = np.maximum((np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1])) + one, 0)
        sides = [(a[:, 2] - a[:, 0]) + one, (a[:, 3] - a[:, 1]) + one,
                 (b[:, 2] - b[:, 0]) + one, (b[:, 3] - b[:, 1]) + one]
        return iw, ih, sides

    iw, ih, (sax, say, sbx, sby) = parts(a, b, f32(1))
    inter, area_a, area_b = iw * ih, sax * say, sbx * sby
    plain = inter >= t32 * np.maximum((area_a + area_b) - inter, f32(1e-10))
    s = (f64(sax) * f64(say) + f64(area_b)).astype(f32)
    uni = (f64(s) - f64(iw) * f64(ih)).astype(f32)
    fma = inter >= t32 * np.maximum(uni, f32(1e-10))
    iw, ih, (sax, say, sbx, sby) = parts(a.astype(f64), b.astype(f64), 1.0)
    inter = iw * ih
    exact = inter >= f64(t32) * np.maximum(sax * say + sbx * sby - inter, 1e-10)
    return {"f32": plain, "f64": exact, "fma": fma}


def clusters(rng, n: int, centers: int) -> torch.Tensor:
    c = rng.uniform(0, 800, (centers, 2))
    base = np.concatenate([c, c + rng.uniform(20, 120, (centers, 2))], 1)
    boxes = base[rng.randint(0, centers, n)] + rng.normal(0, 4, (n, 4))
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    return torch.tensor(boxes.astype(np.float32))[None]


def touching_boxes(rng, n: int) -> torch.Tensor:
    """(1, n, 4) boxes 2 px wide on integer x positions of one band: pairs
    are identical, overlap in one pixel column (iw = 1), touch without
    overlapping (iw = 0) or lie apart (iw < 0)."""
    x = rng.randint(0, 60, n).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    return torch.tensor(np.stack([x, y, x + 1, y + 20], 1))[None]


def bitmask_route_cases(rng, dev) -> list:
    """(name, boxes, valid, thresh) of the four calls the bitmask route
    makes: the proposal NMS over 12000 boxes and the detector's over each
    image's first 1000 proposal survivors, for one image and for a served
    batch of 8."""
    from ctpn_tpu_torch.ops import nms_fused as NF

    def valid_of(b):
        return torch.ones(b.shape[:2], dtype=torch.bool, device=dev)

    main = proposal_like_boxes(rng, 1, 12000).to(dev)
    batch8 = proposal_like_boxes(rng, 8, 12000).to(dev)
    kept = NF.nms_keep_sorted_fused_ref(batch8, valid_of(batch8), 0.7, max_keep=1000)
    det8 = torch.stack([batch8[i, kept[i]][:1000] for i in range(8)]).contiguous()
    det = det8[:1].contiguous()
    return [
        ("proposal (1,12000) t=0.7", main, valid_of(main), 0.7),
        ("detector (1,1000) t=0.2", det, valid_of(det), 0.2),
        ("served proposal (8,12000) t=0.7", batch8, valid_of(batch8), 0.7),
        ("served detector (8,1000) t=0.2", det8, valid_of(det8), 0.2),
    ]


def disjoint_boxes(dev, n: int = 1100) -> torch.Tensor:
    """(1, n, 4) boxes of a 30-px grid that do not touch: all survive."""
    g = torch.arange(n, dtype=torch.float32, device=dev)
    gx, gy = (g % 40) * 30, torch.div(g, 40, rounding_mode="floor") * 30
    return torch.stack([gx, gy, gx + 20, gy + 20], 1)[None].contiguous()


def keep_prefix_mismatch(kern: torch.Tensor, plain: torch.Tensor, cap) -> int:
    """Rows that differ within each image's first ``cap`` survivors (the
    kernel must stop at exactly min(cap, survivors))."""
    bad = 0
    for kr, pr in zip(kern.cpu().numpy(), plain.cpu().numpy()):
        ki, pi = np.flatnonzero(kr), np.flatnonzero(pr)
        m = len(pi) if cap is None else min(cap, len(pi))
        if len(ki) != m:
            return max(1, abs(len(ki) - m))
        bad += int((ki[:m] != pi[:m]).sum())
    return bad


def nms_pair_tests(valid: torch.Tensor, plain_keep: torch.Tensor, cap) -> int:
    """IoU pair tests that this data needs from the block walk: each visited
    512-block tests its valid rows against the boxes kept before it and
    against each other, and the walk stops once ``cap`` are kept."""
    total = 0
    for v, kp in zip(valid.cpu().numpy(), plain_keep.cpu().numpy()):
        kept = 0
        for lo in range(0, len(v), 512):
            if cap is not None and kept >= cap:
                break
            nv = int(v[lo:lo + 512].sum())
            total += nv * kept + nv * (nv - 1) // 2
            kept += int(kp[lo:lo + 512].sum())
    return total


def check_nms_kernel(dev) -> dict:
    from ctpn_tpu_torch.ops import nms_fused as NF

    def valid_of(b):
        return torch.ones(b.shape[:2], dtype=torch.bool, device=dev)

    rng = np.random.RandomState(0)
    main = proposal_like_boxes(rng, 1, 12000).to(dev)
    ones = torch.ones(main.shape[:2], dtype=torch.bool, device=dev)
    batch8 = proposal_like_boxes(rng, 8, 12000).to(dev)
    odd = proposal_like_boxes(rng, 1, 1300).to(dev)
    odd_valid = torch.from_numpy(rng.rand(1, 1300) > 0.3).to(dev)
    dense = clusters(rng, 3000, 12).to(dev)

    # the detector's input is the proposal call's first 1000 survivors
    ones8 = valid_of(batch8)
    kept = NF.nms_keep_sorted_fused_ref(main, ones, 0.7, max_keep=1000)
    det = main[:, kept[0]][:, :1000].contiguous()
    kept8 = NF.nms_keep_sorted_fused_ref(batch8, ones8, 0.7, max_keep=1000)
    det8 = torch.stack([batch8[i, kept8[i]][:1000] for i in range(8)]).contiguous()
    # disjoint boxes all survive: a cap of 512 is reached on the last box of
    # block 0, one of 1024 on the last box of block 1
    disjoint = disjoint_boxes(dev)
    # deep chains, with the cap in the middle of block 1's survivors
    chain = clusters(rng, 1500, 40).to(dev)
    full = NF.nms_keep_sorted_fused_ref(chain, valid_of(chain), 0.5)[0]
    chain_cap = int(full[:512].sum()) + int(full[512:1024].sum()) // 2
    # batch 8 from one tight cluster (a handful of survivors) to disjoint
    # boxes (every image's cluster runs its own number of blocks)
    mixed = torch.cat([clusters(rng, 1100, c).to(dev) for c in (1, 2, 6, 20, 60, 200, 600)]
                      + [disjoint])
    mixed_valid = torch.from_numpy(rng.rand(8, 1100) > 0.1).to(dev)
    cases = [
        ("proposal (1,12000) t=0.7 cap=1000", main, ones, 0.7, 1000),
        ("detector (1,1000) t=0.2", det, valid_of(det), 0.2, None),
        ("batch 8 (8,12000) t=0.7 cap=1000", batch8, ones8, 0.7, 1000),
        ("batch 8 detector (8,1000) t=0.2", det8, valid_of(det8), 0.2, None),
        ("no cap (1,12000) t=0.7, kept list in global scratch", main, ones, 0.7, None),
        ("K=1300, 30% invalid, t=0.5", odd, odd_valid, 0.5, None),
        ("all invalid (1,700) cap=100", odd[:, :700].contiguous(),
         torch.zeros((1, 700), dtype=torch.bool, device=dev), 0.7, 100),
        ("clusters (1,3000) t=0.5", dense, valid_of(dense), 0.5, None),
        ("K=513 t=0.7", main[:, :513].contiguous(), valid_of(main[:, :513]), 0.7, None),
        ("K=1025 t=0.7 cap=1024", main[:, :1025].contiguous(),
         valid_of(main[:, :1025]), 0.7, 1024),
        ("cap 512 reached on the last box of block 0", disjoint,
         valid_of(disjoint), 0.7, 512),
        ("cap 1024 reached on the last box of block 1", disjoint,
         valid_of(disjoint), 0.7, 1024),
        (f"cap {chain_cap} reached mid-block in dense chains (1,1500) t=0.5",
         chain, valid_of(chain), 0.5, chain_cap),
        ("batch 8 of unequal survivor counts (8,1100) t=0.5 cap=300",
         mixed, mixed_valid, 0.5, 300),
    ]
    for t in (0.7, 0.2, 0.5):
        near = near_threshold_boxes(rng, 2000, t).to(dev)
        cases.append((f"near-threshold pairs (1,4000) t={t}", near,
                      valid_of(near), t, None))

    worst = 0
    for name, b, v, t, cap in cases:
        kern = NF.nms_keep_sorted_fused(b, v, t, max_keep=cap)
        torch.cuda.synchronize()
        plain = NF.nms_keep_sorted_fused_ref(b, v, t, max_keep=cap)
        bad = keep_prefix_mismatch(kern, plain, cap)
        log(f"  nms_fused {name}: kept {kern.sum(dim=1).tolist()}, "
            f"prefix mismatches {bad}")
        if bad:
            raise AssertionError(f"nms_fused disagrees with its plain version: {name}")
        worst = max(worst, bad)
        if name.startswith("near"):
            # isolated pairs: each second box follows its own pair's f32
            # test, and rounding must decide some pairs (f32 differs from
            # f64, or from the FMA-contracted version)
            tests = pair_tests(b[0].cpu().numpy(), t)
            pairs = kern[0].view(-1, 2).cpu().numpy()
            n_f64 = int((tests["f32"] != tests["f64"]).sum())
            n_fma = int((tests["f32"] != tests["fma"]).sum())
            log(f"    second box kept in {int(pairs[:, 1].sum())} of {len(pairs)} "
                f"pairs; f32 test differs from f64 in {n_f64}, from FMA in {n_fma}")
            if not pairs[:, 0].all() or (pairs[:, 1] == tests["f32"]).any():
                raise AssertionError("a near-threshold pair was not decided by "
                                     "its own f32 test")
            if pairs[:, 1].all() or not pairs[:, 1].any():
                raise AssertionError("near-threshold pairs did not straddle t")
            if n_f64 == 0 or n_fma == 0:
                raise AssertionError("rounding decided no near-threshold pair")

    shapes = []
    for name, b, v, t, cap in cases[:4]:  # the shapes the default route launches
        ms = cuda_ms(lambda: NF.nms_keep_sorted_fused(b, v, t, max_keep=cap), 20)
        direct_ms = launch_ms(NF, b, v, t, cap)
        plain_ms = cuda_ms(
            lambda: NF.nms_keep_sorted_fused_ref(b, v, t, max_keep=cap), 3)
        plain = NF.nms_keep_sorted_fused_ref(b, v, t, max_keep=cap)
        n_bytes = b.numel() * 4 + v.numel() * 2  # boxes + flags in, keep out
        n_ops = nms_pair_tests(v, plain, cap) * IOU_PAIR_OPS
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        shapes.append({
            "call": name, "ms": ms, "launch_ms": direct_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "issue_bound_ms": n_ops / F32_ISSUE_OPS_PER_S * 1e3,
            "bytes": n_bytes, "operations": n_ops,
        })
        log(f"  nms_fused {name}: kernel {ms:.4f} ms (launcher alone {direct_ms} ms), "
            f"plain {plain_ms:.3f} ms, "
            f"bound {max(bytes_ms, ops_ms) * 1e3:.3f} us "
            f"({n_ops} ops, {n_bytes} bytes)")
    head = shapes[0]
    return {
        "name": "nms_fused",
        "route": "cuda",
        "source": "ctpn_tpu_torch/ops/csrc/nms_fused.cu",
        "replaces": "ctpn_tpu/ops/nms_fused.py:67",
        "launches": None,  # filled from the main path's run
        "max_abs_err": float(worst),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,  # no single PyTorch call computes greedy NMS
        "shapes": shapes,
    }


def check_bitmask_kernel(dev) -> dict:
    from ctpn_tpu_torch.ops import nms_bitmask as NB

    def valid_of(b):
        return torch.ones(b.shape[:2], dtype=torch.bool, device=dev)

    rng = np.random.RandomState(1)
    cases = bitmask_route_cases(rng, dev)
    odd = proposal_like_boxes(rng, 1, 1300).to(dev)
    odd_valid = torch.from_numpy(rng.rand(1, 1300) > 0.3).to(dev)
    cases += [
        ("N=1300, 30% invalid, t=0.5", odd, odd_valid, 0.5),
        ("all invalid (1,700) t=0.7", odd[:, :700].contiguous(),
         torch.zeros((1, 700), dtype=torch.bool, device=dev), 0.7),
    ]
    mid = proposal_like_boxes(rng, 3, 5000).to(dev)
    cases.append(("(3,5000), 20% invalid, t=0.5", mid,
                  torch.from_numpy(rng.rand(3, 5000) > 0.2).to(dev), 0.5))
    # N one below, at and one above a multiple of a word (32), of a CTA's
    # rows (64), of a warp's columns (128) and of a tile's columns (1024)
    dense = clusters(rng, 1025, 30).to(dev)
    for n in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1023, 1024, 1025):
        b = dense[:, :n].contiguous()
        cases.append((f"clusters N={n} t=0.5", b, valid_of(b), 0.5))
    # an invalid box inside a diagonal word, among boxes that all overlap
    same = torch.tensor([[10.0, 20.0, 80.0, 60.0]], device=dev).repeat(1, 200, 1)
    holes = valid_of(same)
    holes[0, [0, 37, 64, 95, 127, 128, 199]] = False
    cases.append(("identical boxes (1,200), 7 invalid, t=0.5", same, holes, 0.5))
    touch = touching_boxes(rng, 300).to(dev)
    cases.append(("touching boxes (1,300) t=0.2", touch, valid_of(touch), 0.2))
    cases.append(("touching boxes (1,300) t=0.0, no early reject", touch,
                  valid_of(touch), 0.0))
    for t in (0.7, 0.2, 0.5):
        near = near_threshold_boxes(rng, 2000, t).to(dev)
        cases.append((f"near-threshold pairs (1,4000) t={t}", near, valid_of(near), t))

    worst = 0
    for name, b, v, t in cases:
        kern = NB.suppression_bitmask(b, v, t)
        torch.cuda.synchronize()
        plain = NB.suppression_bitmask_ref(b, v, t)
        bad = int((kern != plain).sum())
        log(f"  nms_bitmask {name}: {tuple(kern.shape)} words, "
            f"{int((kern != 0).sum())} non-zero, differing words {bad}")
        if bad:
            raise AssertionError(f"nms_bitmask disagrees with its plain version: {name}")
        worst = max(worst, bad)
        if name.startswith("near"):
            # isolated pairs: row 2p's only bit is column 2p+1, set iff the
            # pair's own f32 test suppresses
            tests = pair_tests(b[0].cpu().numpy(), t)
            rows = np.arange(0, b.shape[1], 2)
            words = kern[0].cpu().numpy().view(np.uint32)
            bits = (words[rows, (rows + 1) // 32] >> ((rows + 1) % 32)) & 1
            n_f64 = int((tests["f32"] != tests["f64"]).sum())
            n_fma = int((tests["f32"] != tests["fma"]).sum())
            log(f"    bit set in {int(bits.sum())} of {len(rows)} pairs; f32 test "
                f"differs from f64 in {n_f64}, from FMA in {n_fma}")
            if (bits.astype(bool) != tests["f32"]).any():
                raise AssertionError("a near-threshold pair's bit is not its f32 test")
            if int((kern != 0).sum()) != int(bits.sum()):
                raise AssertionError("bits set outside the isolated pairs")
            if n_f64 == 0 or n_fma == 0:
                raise AssertionError("rounding decided no near-threshold pair")

    shapes = []
    for name, b, v, t in cases[:4]:
        ms = cuda_ms(lambda: NB.suppression_bitmask(b, v, t), 20)
        direct_ms = launch_ms(NB, b, v, t)
        plain_ms = cuda_ms(lambda: NB.suppression_bitmask_ref(b, v, t), 3)
        batch, n = v.shape
        nv = v.sum(dim=1).cpu().numpy().astype(np.int64)
        n_ops = int((nv * (nv - 1) // 2).sum()) * IOU_PAIR_OPS  # j > i, both valid
        n_bytes = batch * n * (16 + 1) + batch * n * NB.num_words(n) * 4
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        shapes.append({
            "call": name, "ms": ms, "launch_ms": direct_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "issue_bound_ms": n_ops / F32_ISSUE_OPS_PER_S * 1e3,
            "bytes": n_bytes, "operations": n_ops,
        })
        log(f"  nms_bitmask {name}: kernel {ms:.4f} ms (launcher alone {direct_ms} ms), "
            f"plain {plain_ms:.3f} ms, "
            f"bound {max(bytes_ms, ops_ms) * 1e3:.3f} us "
            f"({n_ops} ops, {n_bytes} bytes)")
    # the kernel tests only pairs whose extents overlap, so its time depends
    # on the data: identical boxes, where every pair overlaps, are its worst
    same8 = same[:, :1].repeat(8, 12000, 1)
    ones8 = valid_of(same8)
    worst_ms = cuda_ms(lambda: NB.suppression_bitmask(same8, ones8, 0.5), 5)
    log(f"  nms_bitmask worst case, identical boxes (8,12000) t=0.5: kernel "
        f"{worst_ms:.4f} ms")
    head = shapes[2]  # the served path's proposal call: batch 8
    return {
        "name": "nms_bitmask",
        "route": "cuda",
        "source": "ctpn_tpu_torch/ops/csrc/nms_bitmask.cu",
        "replaces": "ctpn_tpu/ops/nms_pallas.py:55",
        "launches": None,  # filled from the serving path's run
        "max_abs_err": float(worst),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,  # no PyTorch call computes a packed suppression mask
        "worst_case": {"call": "identical boxes (8,12000) t=0.5", "ms": worst_ms},
        "shapes": shapes,
    }


def check_resolve_kernel(dev) -> dict:
    """The resolve kernel on masks from the bitmask kernel: its keep flags
    against the plain resolve and against the fused kernel's uncapped keep
    mask on the same boxes (tolerance 0)."""
    from ctpn_tpu_torch.ops import nms_bitmask as NB
    from ctpn_tpu_torch.ops import nms_fused as NF
    from ctpn_tpu_torch.ops import nms_resolve as NR

    def valid_of(b):
        return torch.ones(b.shape[:2], dtype=torch.bool, device=dev)

    rng = np.random.RandomState(3)
    cases = bitmask_route_cases(rng, dev)
    odd = proposal_like_boxes(rng, 1, 1300).to(dev)
    for n in (1, 31, 32, 33):
        b = odd[:, :n].contiguous()
        cases.append((f"N={n} t=0.7", b, valid_of(b), 0.7))
    # the cluster sizes between the route's 1 and 8 CTAs per image, and more
    # word columns (532) than eight CTAs' fold threads hold
    wide = proposal_like_boxes(rng, 2, 17000).to(dev)
    for n in (2048, 2049, 6000, 17000):
        b = wide[:, :n].contiguous()
        cases.append((f"(2,{n}), 10% invalid, t=0.7", b,
                      torch.from_numpy(rng.rand(2, n) > 0.1).to(dev), 0.7))
    cases.append(("N=1300, 30% invalid, t=0.5", odd,
                  torch.from_numpy(rng.rand(1, 1300) > 0.3).to(dev), 0.5))
    cases.append(("all invalid (1,700) t=0.7", odd[:, :700].contiguous(),
                  torch.zeros((1, 700), dtype=torch.bool, device=dev), 0.7))
    # one survivor, and every later word folded away by row 0
    same = torch.tensor([[10.0, 20.0, 80.0, 60.0]], device=dev).repeat(1, 3000, 1)
    cases.append(("identical boxes (1,3000) t=0.5", same, valid_of(same), 0.5))
    dense = clusters(rng, 3000, 12).to(dev)  # long chains inside a word
    cases.append(("clusters (1,3000) t=0.5", dense, valid_of(dense), 0.5))
    disjoint = disjoint_boxes(dev)
    mixed = torch.cat([clusters(rng, 1100, c).to(dev) for c in (1, 2, 6, 20, 60, 200, 600)]
                      + [disjoint])
    cases.append(("batch 8 of unequal survivor counts (8,1100) t=0.5", mixed,
                  torch.from_numpy(rng.rand(8, 1100) > 0.1).to(dev), 0.5))

    worst = 0
    masks = []
    for name, b, v, t in cases:
        mask = NB.suppression_bitmask(b, v, t)
        kern = NR.nms_resolve(mask, v)
        torch.cuda.synchronize()
        plain = NR.nms_fixed_point_blocked(mask, v)
        fused = NF.nms_keep_sorted_fused(b, v, t, max_keep=None)
        bad = int((kern != plain).sum())
        bad_fused = int((kern != fused).sum())
        log(f"  nms_resolve {name}: kept {kern.sum(dim=1).tolist()}, flags differing "
            f"from the plain resolve {bad}, from the fused kernel {bad_fused}")
        if kern.dtype != torch.bool or kern.shape != v.shape:
            raise AssertionError(f"nms_resolve: bad output {kern.dtype} {tuple(kern.shape)}")
        if bad or bad_fused:
            raise AssertionError(f"nms_resolve disagrees: {name}")
        worst = max(worst, bad)
        if len(masks) < 4:  # the route's shapes are timed below
            masks.append(mask)
    empty = NR.nms_resolve(torch.empty((0, 40, 2), dtype=torch.int32, device=dev),
                           torch.empty((0, 40), dtype=torch.bool, device=dev))
    none = NR.nms_resolve(torch.empty((2, 0, 0), dtype=torch.int32, device=dev),
                          torch.empty((2, 0), dtype=torch.bool, device=dev))
    if empty.shape != (0, 40) or none.shape != (2, 0):
        raise AssertionError("nms_resolve: empty inputs must give empty outputs")

    shapes = []
    for (name, b, v, t), mask in zip(cases[:4], masks):
        ms = cuda_ms(lambda: NR.nms_resolve(mask, v), 20)
        direct_ms = launch_ms(NR, mask, v)
        plain_ms = cuda_ms(lambda: NR.nms_fixed_point_blocked(mask, v), 3)
        batch, n = v.shape
        words = NB.num_words(n)
        # each row's words at or right of its diagonal word, the flags in,
        # the flags out
        read_words = sum(words - i // 32 for i in range(n))
        n_bytes = batch * (read_words * 4 + 2 * n)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        shapes.append({"call": name, "ms": ms, "launch_ms": direct_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                       "bytes": n_bytes, "operations": 0})
        log(f"  nms_resolve {name}: kernel {ms:.4f} ms (launcher alone {direct_ms} ms), "
            f"plain {plain_ms:.3f} ms, "
            f"bound {bound_ms * 1e3:.3f} us ({n_bytes} bytes)")
    head = shapes[2]  # the served path's proposal call: batch 8
    return {
        "name": "nms_resolve",
        "route": "cuda",
        "source": "ctpn_tpu_torch/ops/csrc/nms_resolve.cu",
        "replaces": "ctpn_tpu/ops/nms.py:136 (jnp, not Pallas)",
        "launches": None,  # filled from the serving path's run
        "max_abs_err": float(worst),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,  # no PyTorch call resolves a suppression bitmask
        "shapes": shapes,
    }


# ---------------------------------------------------------------- stem


def stock_block(x, w1, b1, w2, b2) -> torch.Tensor:
    """VGG block 1 as the stock trunk runs it: cuDNN convs in the input's
    dtype, separate ReLUs and pool."""
    y = F.relu(F.conv2d(x, w1.to(x.dtype), b1.to(x.dtype), padding=1))
    y = F.relu(F.conv2d(y, w2.to(x.dtype), b2.to(x.dtype), padding=1))
    return F.max_pool2d(y, 2, 2)


def photo_batch(bucket=(608, 912)) -> tuple:
    """The five demo photos plus three repeats, padded to ``bucket``:
    (uint8 images (8, h, w, 3), im_info (8, 3))."""
    from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image

    preps = [prep_image(load_image_bgr(str(p)), bucket=bucket) for p in PHOTOS]
    data = np.stack([p[0] for p in preps] + [preps[0][0]] * 3)
    infos = np.stack([p[1] for p in preps] + [preps[0][1]] * 3)
    return data, infos


def stem_input(images: np.ndarray, dev) -> torch.Tensor:
    """uint8 BGR (N, H, W, 3) -> the trunk's input: mean-subtracted, bf16,
    (N, 3, H, W) channels_last."""
    from ctpn_tpu_torch.config import cfg

    x = torch.from_numpy(images).to(dev).float()
    x = x - torch.tensor(cfg.PIXEL_MEANS, device=dev)
    return x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (b.abs() + 1.0)).max())


def check_stem_kernel(dev) -> dict:
    from ctpn_tpu_torch.ops import stem_fused as SF
    from ctpn_tpu_torch.utils.weights import load_params, params_from_jax

    state = params_from_jax(load_params(str(ARTIFACT), device=dev))
    shipped = [state[f"trunk.conv1_{i}.{k}"] for i in (1, 2) for k in ("weight", "bias")]
    rng = np.random.RandomState(2)

    def rand_weights(b1_value=None):
        def t(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)
        b1 = (np.full(64, b1_value) if b1_value is not None
              else rng.randn(64) * 0.1)
        return [t(rng.randn(64, 3, 3, 3) * 0.05), t(b1),
                t(rng.randn(64, 64, 3, 3) * 0.05), t(rng.randn(64) * 0.1)]

    def rand_input(n, h, w):
        a = rng.uniform(-120, 120, (n, h, w, 3)).astype(np.float32)
        return torch.from_numpy(a).to(dev).permute(0, 3, 1, 2).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    data, _ = photo_batch()
    tall, _ = photo_batch(bucket=(912, 608))
    small_x = rand_input(2, 40, 72)
    zero_x = torch.zeros((1, 3, 32, 48), dtype=torch.bfloat16, device=dev).contiguous(
        memory_format=torch.channels_last)
    ring_w = rand_weights(b1_value=3.0)
    ring_w[3] = torch.zeros_like(ring_w[3])
    cases = [
        ("served (8,3,608,912), demo photos, shipped weights",
         stem_input(data, dev), shipped),
        ("served (8,3,912,608), demo photos, shipped weights",
         stem_input(tall, dev), shipped),
        ("odd tiles (2,3,40,72), random", small_x, rand_weights()),
        ("partial tiles right and bottom (1,3,24,136), random",
         rand_input(1, 24, 136), rand_weights()),
        ("smaller than a tile (3,3,8,8), random", rand_input(3, 8, 8), rand_weights()),
        ("zero image, conv1 bias 3.0 (1,3,32,48)", zero_x, ring_w),
    ]
    worst = 0.0

    def hold(name, x, ws):
        nonlocal worst
        kern = SF.fused_stem_block(x, *ws)
        torch.cuda.synchronize()
        plain = SF.fused_stem_block_ref(x, *ws)
        err = rel_err(kern, plain)
        n_diff = int((kern != plain).sum())
        log(f"  stem_fused {name}: out {tuple(kern.shape)}, max rel err {err:.3e}, "
            f"{n_diff} of {kern.numel()} values differ")
        if not kern.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError("stem output is not channels_last")
        if not torch.isfinite(kern.float()).all() or err >= 1e-2:
            raise AssertionError(f"stem_fused disagrees with its plain version: {name}")
        worst = max(worst, err)
        return kern

    for name, x, ws in cases:
        hold(name, x, ws)
    # the packed weights are cached per parameter tensor: new values in the
    # same tensors, then other tensors, must each be packed anew
    ws = rand_weights()
    first = hold("packed-weight cache, first weights (2,3,40,72)", small_x, ws)
    for t, fresh in zip(ws, rand_weights()):
        t.copy_(fresh)
    second = hold("packed-weight cache, same tensors updated in place", small_x, ws)
    third = hold("packed-weight cache, other tensors", small_x, rand_weights())
    if torch.equal(first, second) or torch.equal(second, third):
        raise AssertionError("the packed-weight cache served stale weights")

    name, x, ws = cases[0]
    ms = cuda_ms(lambda: SF.fused_stem_block(x, *ws), 20)
    direct_ms = launch_ms(SF, x, *ws)
    plain_ms = cuda_ms(lambda: SF.fused_stem_block_ref(x, *ws), 3)
    stock_ms = cuda_ms(lambda: stock_block(x, *ws), 20)
    n, _, h, w = x.shape
    n_ops = 2 * n * h * w * (27 * 64 + 576 * 64)
    n_bytes = (x.numel() * 2 + n * 64 * (h // 2) * (w // 2) * 2
               + sum(t.numel() * 2 for t in (ws[0], ws[2])) + 2 * 64 * 4)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / BF16_TENSOR_OPS_PER_S * 1e3
    log(f"  stem_fused {name}: kernel {ms:.4f} ms (launcher alone {direct_ms} ms), "
        f"plain {plain_ms:.3f} ms, "
        f"stock cuDNN block {stock_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({n_ops} ops, {n_bytes} bytes)")
    return {
        "name": "stem_fused",
        "route": "cuda",
        "source": "ctpn_tpu_torch/ops/csrc/stem_fused.cu",
        "replaces": "ctpn_tpu/ops/stem_pallas.py:54",
        "launches": None,  # filled from the serving path's run
        "max_abs_err": worst,  # max relative error |a-b|/(|b|+1)
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes the fused block
        "stock_ms": stock_ms,
        "shapes": [{"call": name, "ms": ms, "launch_ms": direct_ms, "plain_ms": plain_ms,
                    "stock_ms": stock_ms, "bytes": n_bytes, "operations": n_ops}],
    }


# ---------------------------------------------------------------- conv epilogue

EPILOGUE_BATCH = 48  # the benchmark's batch


def bits_of(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def edge_values(rng, shape, dev) -> torch.Tensor:
    """bf16 values around zero with -0.0, +0.0, NaN and infinities among
    them; channels_last when 4-D."""
    a = rng.normal(0, 1, shape).astype(np.float32)
    for start, step, value in ((0, 7, -0.0), (3, 11, 0.0), (5, 97, np.nan),
                               (6, 101, np.inf), (8, 103, -np.inf)):
        a.flat[start::step] = value
    t = torch.from_numpy(a).to(dev).to(torch.bfloat16)
    return t.contiguous(memory_format=torch.channels_last) if t.ndim == 4 else t


def epilogue_sites(model) -> list:
    """(name, conv, pool) of the default route's 14 convs, in order."""
    from ctpn_tpu_torch.models.vgg import VGG_STAGES

    sites = [(f"conv{b}_{r}", getattr(model.trunk, f"conv{b}_{r}"), r == reps and b < 5)
             for b, reps, _ in VGG_STAGES for r in range(1, reps + 1)]
    return sites + [("rpn_conv", model.rpn_conv, False)]


def check_conv_epilogue_kernel(dev) -> dict:
    """The conv epilogue against its plain version on edge cases, then the
    default route's 14 sites at batch 48 and 608x912 on the demo photos
    with the shipped weights: at each, the kernel on the conv's bias-less
    output against the plain version and against the separate passes as
    the trunk ran them (``F.conv2d`` with its bias, ``F.relu``,
    ``F.max_pool2d``), bit for bit; then timed with its byte bound, the
    plain version and the PyTorch passes on the bias-less output
    (``add_``, ``F.relu``, ``F.max_pool2d``: ``library_ms``)."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.ops import conv_epilogue as EP
    from ctpn_tpu_torch.utils.weights import load_params

    rng = np.random.RandomState(7)

    def same_bits(got, want, what):
        if got.shape != want.shape or not torch.equal(bits_of(got), bits_of(want)):
            n_diff = (int((bits_of(got) != bits_of(want)).sum())
                      if got.shape == want.shape else "shape")
            raise AssertionError(f"conv_epilogue {what}: {n_diff} values differ")

    edge = [("odd-width pool (2,64,37,55)", (2, 64, 37, 55), True, True),
            ("odd sizes, no pool (2,64,37,55)", (2, 64, 37, 55), False, True),
            ("C=24: 3 channel groups (3,24,9,13)", (3, 24, 9, 13), True, True),
            ("no bias (2,512,8,10)", (2, 512, 8, 10), True, False),
            ("one pixel row of windows (1,128,2,2)", (1, 128, 2, 2), True, True)]
    with torch.inference_mode():
        for name, shape, pool, with_bias in edge:
            y = edge_values(rng, shape, dev)
            b = edge_values(rng, (shape[1],), dev) if with_bias else None
            got = EP.conv_epilogue(y, b, pool)
            torch.cuda.synchronize()
            same_bits(got, EP.conv_epilogue_ref(y, b, pool), name)
            if not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError("conv_epilogue output is not channels_last")
            log(f"  conv_epilogue {name}, -0.0/NaN/inf among the values: "
                f"{tuple(got.shape)} equal to the plain version bit for bit")

        model = CTPNPredictor(load_params(str(ARTIFACT), device=dev), device=dev).model
        data, _ = photo_batch()
        reps = EPILOGUE_BATCH // len(data)
        x = stem_input(np.concatenate([data] * reps), dev)
        shapes, totals = [], dict(ms=0.0, launch_ms=0.0, plain_ms=0.0, library_ms=0.0,
                                  bound_ms=0.0, bytes=0)
        for name, conv, pool in epilogue_sites(model):
            b = conv.bias.to(torch.bfloat16)
            y = conv(x, bias=False)
            got = EP.conv_epilogue(y, b, pool)
            torch.cuda.synchronize()
            same_bits(got, EP.conv_epilogue_ref(y, b, pool), f"{name}, plain version")
            present = F.relu(conv(x))
            if pool:
                present = F.max_pool2d(present, 2, 2)
            same_bits(got, present, f"{name}, the separate passes")
            del present

            ms = cuda_ms(lambda: EP.conv_epilogue(y, b, pool), 20)
            direct_ms = launch_ms(EP, y, b, pool)
            plain_ms = cuda_ms(lambda: EP.conv_epilogue_ref(y, b, pool), 3)
            acc, bv = y.clone(), b.view(1, -1, 1, 1)

            def library():
                out = F.relu(acc.add_(bv))
                return F.max_pool2d(out, 2, 2) if pool else out

            library_ms = cuda_ms(library, 20)
            del acc
            n_bytes = 2 * (y.numel() + b.numel() + got.numel())
            bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            row = {"call": f"{name} {tuple(y.shape)}" + (" pool" if pool else ""),
                   "ms": ms, "launch_ms": direct_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms, "bytes": n_bytes,
                   "bound_share": bound_ms / ms}
            shapes.append(row)
            for key in totals:
                totals[key] += row[key]
            log(f"  conv_epilogue {row['call']}: equal to the plain version and to "
                f"the separate passes bit for bit; kernel {ms:.4f} ms (launcher alone "
                f"{direct_ms:.4f}), bound {bound_ms:.4f} ms ({n_bytes} bytes, "
                f"{100 * bound_ms / ms:.1f} % of it), plain {plain_ms:.4f} ms, "
                f"PyTorch passes {library_ms:.4f} ms")
            x = got
    del model, x, y, got
    torch.cuda.empty_cache()
    log(f"  conv_epilogue, 14 sites at batch {EPILOGUE_BATCH}: kernel {totals['ms']:.4f} ms, "
        f"bound {totals['bound_ms']:.4f} ms ({100 * totals['bound_ms'] / totals['ms']:.1f} % "
        f"of it, {totals['bytes'] / totals['ms'] / 1e9:.3f} TB/s), PyTorch passes "
        f"{totals['library_ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms")
    return {
        "name": "conv_epilogue",
        "route": "cuda",
        "source": "ctpn_tpu_torch/ops/csrc/conv_epilogue.cu",
        "replaces": None,  # XLA fuses the epilogue into the conv on the TPU
        "launches": None,  # filled from the main path's run
        "max_abs_err": 0.0,  # bit for bit
        "ms": totals["ms"],
        "launch_ms": totals["launch_ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "shapes": shapes,
    }


# ---------------------------------------------------------------- chain walk

WALK_SEED = 3500000011  # a seed of the benchmark's h_device_b48 renders


def cell_renders(n: int = EPILOGUE_BATCH, seed: int = WALK_SEED) -> tuple:
    """The benchmark cell ``h_device_b48``'s inputs: ``n`` 900x600 variants
    of its 24 seeded scenes, resized and padded into 608x912 as the cell's
    traffic makes them (``benchmark/inputs``, ``benchmark/reference/prep.py``)."""
    bench = REPO / "benchmark"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    from inputs import make
    from reference import prep as ref_prep

    config = json.loads((bench / "configs" / "ctpn_vgg16_h.json").read_text())
    config = dict(config, buckets=[[608, 912]])
    preps = [ref_prep.prep(make.bgr(im), config)
             for im in make.variants(seed, 24, [(900, 600)] * n, 8)]
    return np.stack([p[0] for p in preps]), np.stack([p[1] for p in preps])


def connector_calls(dev) -> dict:
    """The arguments of the program's calls to ``detect_lines``, the
    successor graph and the chain walk, caught in one eager run of the
    default route with the shipped weights on the benchmark cell's (48,
    1000) renders: each name to its one call's arguments."""
    from ctpn_tpu_torch.inference import pipeline
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.postprocess import connector
    from ctpn_tpu_torch.utils.weights import load_params

    pred = CTPNPredictor(load_params(str(ARTIFACT), device=dev), device=dev)
    data, infos = cell_renders()
    x, info = torch.from_numpy(data).to(dev), torch.from_numpy(infos).to(dev)
    sites = {"detect_lines": pipeline, "successors": connector, "chain_walk": connector}
    caught = {name: [] for name in sites}
    real = {name: getattr(module, name) for name, module in sites.items()}

    def catcher(name):
        return lambda *a, **kw: caught[name].append((a, kw)) or real[name](*a, **kw)

    for name, module in sites.items():
        setattr(module, name, catcher(name))
    try:
        with torch.inference_mode():
            pred.program(x, info)
    finally:
        for name, module in sites.items():
            setattr(module, name, real[name])
    torch.cuda.synchronize()
    for name, calls in caught.items():
        if len(calls) != 1:
            raise AssertionError(f"the program called {name} {len(calls)} times, not once")
    return {name: calls[0] for name, calls in caught.items()}


def made_up_walks(rng, dev) -> list:
    """(name, succ, feats, x1, x2, steps) of the walk's edge cases: forests
    whose heads converge on shared tails, no edges, a chain longer than
    the cap, P off the CTA's 1024 threads, features too large for shared
    memory, successors out of range; values of mixed scale with -0.0, +0.0."""
    def forest(n, p, cols):
        col = rng.randint(0, cols, (n, p))
        succ = np.full((n, p), -1, np.int32)
        for b in range(n):
            for i in range(p):
                right = np.flatnonzero((col[b] > col[b, i]) & (col[b] <= col[b, i] + 3))
                if len(right) and rng.rand() < 0.9:
                    succ[b, i] = rng.choice(right)
        return succ

    def values(shape):
        a = (rng.normal(0, 1, shape) * 10.0 ** rng.randint(-2, 6, shape)).astype(np.float32)
        a.flat[::13] = -0.0
        a.flat[5::17] = 0.0
        return a

    chain = np.array([list(range(1, 200)) + [-1]], np.int32)
    wild = forest(2, 1000, 57)
    wild[:, ::31] = 1000  # out of range: no successor
    wild[:, 7::37] = -3
    cases = [("shared tails (4, 1000, K 7), 57 columns", forest(4, 1000, 57), 7, 64),
             ("no edges (2, 1000, K 7)", np.full((2, 1000), -1, np.int32), 7, 64),
             ("a chain of 200 past the cap of 64 (1, 200, K 6)", chain, 6, 64),
             ("P 1037 off the CTA (3, 1037, K 6)", forest(3, 1037, 60), 6, 64),
             ("P 2500, three passes of the CTA (2, 2500, K 8)", forest(2, 2500, 120), 8, 128),
             ("P 6000, K 8: features read from global memory (1, 6000)",
              forest(1, 6000, 300), 8, 256),
             ("successors out of range (2, 1000, K 7)", wild, 7, 64),
             ("one node (5, 1, K 1)", np.full((5, 1), -1, np.int32), 1, 2)]
    out = []
    for name, succ, k, steps in cases:
        n, p = succ.shape
        t = [torch.from_numpy(a).to(dev)
             for a in (succ, values((n, p, k)), values((n, p)), values((n, p)))]
        out.append((name, *t, steps))
    return out


def dense_closure(succ: torch.Tensor, feats: torch.Tensor, steps: int):
    """What the walk replaced: ``log2(steps)`` float32 squarings of (I + S)
    and R @ F, with R's counts, TF32 off."""
    from ctpn_tpu_torch.utils.device import full_f32_matmul

    p = succ.shape[1]
    idx = torch.arange(p, device=succ.device)
    edge = (succ[:, :, None] == idx) & (succ >= 0)[:, :, None]
    with full_f32_matmul():
        m = (edge | torch.eye(p, dtype=torch.bool, device=succ.device)).float()
        for _ in range(int(np.log2(steps))):
            m = (torch.bmm(m, m) > 0.0).float()
        sums = torch.bmm(m, feats)
    return sums, m.sum(2)


def same_walk(got, want, what: str) -> None:
    """The five outputs of two walks, bit for bit."""
    for name, g, w in zip(("sums", "cnt", "min_x1", "max_x2", "is_start"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"chain_walk {what}: {name} {tuple(g.shape)} {g.dtype}, "
                                 f"plain {tuple(w.shape)} {w.dtype}")
        gb = g.view(torch.uint8) if g.dtype == torch.bool else g.view(torch.int32)
        wb = w.to(g.device)
        wb = wb.view(torch.uint8) if w.dtype == torch.bool else wb.view(torch.int32)
        if not torch.equal(gb, wb):
            raise AssertionError(f"chain_walk {what}: {int((gb != wb).sum())} values "
                                 f"of {name} differ from the plain version")


def check_chain_walk_kernel(dev, calls: dict = None) -> dict:
    """The chain walk against its plain version, bit for bit: the made-up
    graphs (plain version on the card and on the CPU), then the program's
    own successor graphs at (48, 1000) from the benchmark cell's renders
    (the arguments of the connector's call, ``connector_calls``). Timed
    there beside its byte bound, the plain version and the dense closure
    it replaced (``library_ms``)."""
    from ctpn_tpu_torch.ops import chain_walk as CW

    calls = calls or connector_calls(dev)
    rng = np.random.RandomState(11)
    with torch.inference_mode():
        for name, *args in made_up_walks(rng, dev):
            got = CW.chain_walk(*args)
            torch.cuda.synchronize()
            same_walk(got, CW.chain_walk_ref(*args), name)
            cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
            same_walk(got, CW.chain_walk_ref(*cpu_args), name + ", plain version on the CPU")
            log(f"  chain_walk {name}: equal to the plain version bit for bit "
                f"(longest walk {int(got[1].max())} nodes)")

        args = calls["chain_walk"][0]
        succ, feats, steps = args[0], args[1], args[4]
        got = CW.chain_walk(*args)
        torch.cuda.synchronize()
        same_walk(got, CW.chain_walk_ref(*args), "the program's graphs")
        cnt, start = got[1], got[4]
        dense_sums, dense_cnt = dense_closure(succ, feats, steps)
        if not torch.equal(dense_cnt, cnt):
            raise AssertionError("chain_walk: node counts differ from the dense closure's")
        gap = float(((dense_sums - got[0]).abs() / (dense_sums.abs() + 1.0)).max())
        graph = {"shape": list(feats.shape), "steps": steps,
                 "edges": int((succ >= 0).sum()), "starts": int(start.sum()),
                 "longest_chain": int(cnt.max()),
                 "mean_chain_at_starts": float(cnt[start].mean()) if start.any() else 0.0,
                 "dense_sum_rel_gap": gap}

        ms = cuda_ms(lambda: CW.chain_walk(*args), 20)
        direct_ms = launch_ms(CW, *args)
        plain_ms = cuda_ms(lambda: CW.chain_walk_ref(*args), 3)
        library_ms = cuda_ms(lambda: dense_closure(succ, feats, steps), 3)
        n, p, k = feats.shape
        # succ, x1, x2 and the features read; the sums, cnt, min, max and
        # flags written
        n_bytes = n * p * (4 + 8 + 4 * k) + n * p * (4 * k + 12 + 1)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    del args, got, dense_sums
    torch.cuda.empty_cache()
    log(f"  chain_walk, the program's graphs {json.dumps(graph)}: equal to the plain "
        f"version bit for bit; kernel {ms:.4f} ms (launcher alone {direct_ms:.4f}), bound "
        f"{bound_ms:.5f} ms ({n_bytes} bytes, {100 * bound_ms / ms:.2f} % of it), plain "
        f"{plain_ms:.4f} ms, the dense closure {library_ms:.4f} ms")
    return {
        "name": "chain_walk",
        "route": "cuda",
        "source": "ctpn_tpu_torch/ops/csrc/chain_walk.cu",
        "replaces": "ctpn_tpu/postprocess/connector.py:chain_reachability",
        "launches": None,  # filled from the main path's run
        "max_abs_err": 0.0,  # bit for bit
        "ms": ms,
        "launch_ms": direct_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "shapes": [dict(graph, call=f"chain_walk {tuple(feats.shape)} steps {steps}")],
    }


# ---------------------------------------------------------------- successor graph

PAIR_TEST_OPS = 13  # float ops of one pair test: h, overlap, clamp, min/max h, 2 divides, 2 compares


def padded_scenes(scenes, p: int) -> tuple:
    """(boxes, scores, valid) of ``scenes`` (each boxes, scores) padded to P."""
    boxes = np.zeros((len(scenes), p, 4), np.float32)
    scores = np.full((len(scenes), p), -1.0, np.float32)
    valid = np.zeros((len(scenes), p), bool)
    for i, (b, sc) in enumerate(scenes):
        boxes[i, :len(b)], scores[i, :len(b)], valid[i, :len(b)] = b, sc, True
    return boxes, scores, valid


def grid_scene(rng, n: int, p: int, im_w: int = 912, im_h: int = 608) -> tuple:
    """Proposals on the program's 16-px anchor grid, many per column,
    heights of the anchor ladder jittered, scores in (0.7, 1], a tenth
    invalid (a copy of ``tests/test_torch_successors.py::grid_scene``)."""
    x1 = 16.0 * rng.randint(0, im_w // 16, (n, p))
    h = rng.choice([11, 16, 23, 33, 48, 68, 97], (n, p)) * rng.uniform(0.9, 1.1, (n, p))
    y1 = rng.uniform(0, im_h - 100, (n, p))
    boxes = np.stack([x1, y1, x1 + 15, y1 + h - 1], -1).astype(np.float32)
    return boxes, rng.uniform(0.7, 1.0, (n, p)).astype(np.float32), rng.rand(n, p) > 0.1


def rule_scenes() -> list:
    """(name, boxes, scores, valid) of the tests' scenes built for each rule
    (``tests/test_torch_successors.py``), each a batch of small images."""
    def strip(x1, y1, y2):
        return [x1, y1, x1 + 15, y2]

    ties = [strip(0, 10, 40), strip(32, 10, 40), strip(16, 10, 40), strip(32, 10, 40),
            strip(16, 10, 40), strip(16, 10, 40)]
    nearest = [strip(0, 10, 40), strip(16, 10, 40), strip(32, 10, 40)]
    gaps = [[strip(100, 10, 40), strip(100 + dx, 10, 40)] for dx in (50, 51, 50.9, 49.5)]
    thresholds = [[strip(0, 0.0, 9.0), strip(16, a, b)]
                  for a, b in ((3.0, 12.0), (3.01, 12.01), (0.0, 6.0), (0.0, 5.99))]
    out = [("ties in the nearest column on both sides (1, 6)",
            *padded_scenes([(np.array(ties, np.float32),
                             np.array([0.95, 0.9, 0.8, 0.9, 0.8, 0.8], np.float32))], 6)),
           ("the nearest precursor column (1, 3)",
            *padded_scenes([(np.array(nearest, np.float32),
                             np.array([0.99, 0.8, 0.9], np.float32))], 3)),
           ("column gaps 50, 51, 50.9, 49.5 (4, 2)",
            *padded_scenes([(np.array(g, np.float32), np.array([0.9, 0.8], np.float32))
                            for g in gaps], 2)),
           ("overlap and similarity at and under 0.7 (4, 2)",
            *padded_scenes([(np.array(t, np.float32), np.array([0.9, 0.8], np.float32))
                            for t in thresholds], 2))]
    one = padded_scenes([(np.array([strip(0, 10, 40)], np.float32),
                          np.array([0.9], np.float32))] * 2, 1)
    one[2][1] = False
    out.append(("one node, valid and not (2, 1)", *one))
    boxes, scores, _ = grid_scene(np.random.RandomState(3), 2, 64)
    out.append(("no valid node (2, 64)", boxes, scores, np.zeros((2, 64), bool)))
    return out


def successor_cases(rng) -> list:
    """(name, boxes, scores, valid, settings) of the successor kernel's
    cases, the settings (max_gap, min_v_overlaps, min_size_sim)."""
    default = (50, 0.7, 0.7)
    cases = [(name, b, sc, v, default) for name, b, sc, v in rule_scenes()]
    for slope in (0.0, 0.08):
        strips = [strip_scene(rng, n_lines=5, slope=slope) for _ in range(4)]
        cases.append((f"strip scenes, slope {slope} (4, 160)",
                      *padded_scenes(strips, 160), default))
    for n, p, what in ((48, 1000, "the anchor grid"), (1, 1037, "P off the CTA"),
                       (2, 2500, "past 48 KB of shared memory"),
                       (1, 12000, "inputs read from global memory"),
                       (1, 16384, "the most keys in shared memory"),
                       (1, 16385, "keys in global memory")):
        cases.append((f"{what} ({n}, {p})", *grid_scene(rng, n, p), default))
    for settings in ((16, 0.7, 0.7), (50, 0.5, 0.9), (0, 0.7, 0.7), (-3, 0.7, 0.7),
                     (1000, 0.7, 0.7)):
        cases.append((f"max_gap, overlap, similarity {settings} (2, 200)",
                      *grid_scene(rng, 2, 200), settings))
    return cases


def same_successors(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.dtype != torch.int32 or got.shape != want.shape or want.dtype != torch.int32:
        raise AssertionError(f"successors {what}: {got.dtype} {tuple(got.shape)}, plain "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"successors {what}: {int((got.cpu() != want.cpu()).sum())} "
                             "of the nodes differ from the plain version")


def window_pair_tests(boxes: torch.Tensor, valid: torch.Tensor, max_gap: int) -> int:
    """Ordered pairs of valid nodes of one image within max_gap columns,
    in another column: the pair tests a scan to the window's edges makes,
    and more than the kernel's, which stops at the nearest candidate
    column."""
    total = 0
    cols = torch.floor(boxes[..., 0]).to(torch.int64).cpu().numpy()
    for col, ok in zip(cols, valid.cpu().numpy()):
        c = np.sort(col[ok])
        near = np.searchsorted(c, c + max_gap, side="right") - np.searchsorted(c, c, "right")
        total += 2 * int(near.sum())
    return total


def profile_detect_lines(args, kw) -> dict:
    """One eager ``detect_lines`` on the program's own arguments under
    ``torch.profiler``: its device kernels counted and timed by name, and
    the largest input of any op it ran, in elements."""
    from ctpn_tpu_torch.postprocess.detector import detect_lines

    detect_lines(*args, **kw)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        detect_lines(*args, **kw)
        torch.cuda.synchronize()
    kernels, largest = {}, 0
    for e in prof.events():
        for k in getattr(e, "kernels", None) or []:
            row = kernels.setdefault(k.name[:80], [0, 0.0])
            row[0] += 1
            row[1] += k.duration / 1e3
        for shape in e.input_shapes or []:
            if shape and all(isinstance(d, int) for d in shape):
                largest = max(largest, int(np.prod(shape)))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {"kernels": sum(n for n, _ in kernels.values()),
            "device_ms": sum(ms for _, ms in kernels.values()),
            "largest_input_elems": largest,
            "by_kernel": [[name, n, ms] for name, (n, ms) in top[:12]]}


def check_successors_kernel(dev, calls: dict = None) -> dict:
    """The successor graph against its plain version, bit for bit: the
    made-up cases (plain version on the card; on the CPU too up to P
    2500), then the program's own proposals at (48, 1000) from the
    benchmark cell's renders (the arguments of the connector's call,
    ``connector_calls``; plain version on the card and on the CPU). Timed
    there beside its bound and the plain version (the dense form it
    replaced); then ``detect_lines`` on the program's arguments under
    ``torch.profiler``: no op may take an input of N x P x P elements."""
    from ctpn_tpu_torch.ops import successors as SU

    calls = calls or connector_calls(dev)
    rng = np.random.RandomState(13)
    with torch.inference_mode():
        for name, *arrays, settings in successor_cases(rng):
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            got = SU.successors(*args, *settings)
            torch.cuda.synchronize()
            same_successors(got, SU.successors_ref(*args, *settings), name)
            on_cpu = arrays[1].shape[1] <= 2500
            if on_cpu:
                cpu = [torch.from_numpy(a) for a in arrays]
                same_successors(got, SU.successors_ref(*cpu, *settings),
                                name + ", plain version on the CPU")
            log(f"  successors {name}: equal to the plain version bit for bit"
                f"{' (card and CPU)' if on_cpu else ''}, {int((got >= 0).sum())} edges")

        args = calls["successors"][0]  # the connector passes all six positionally
        boxes, scores, valid = args[:3]
        settings = tuple(args[3:])
        got = SU.successors(*args)
        torch.cuda.synchronize()
        same_successors(got, SU.successors_ref(*args), "the program's proposals")
        same_successors(got, SU.successors_ref(boxes.cpu(), scores.cpu(), valid.cpu(),
                                               *settings),
                        "the program's proposals, plain version on the CPU")
        ms = cuda_ms(lambda: SU.successors(*args), 20)
        direct_ms = launch_ms(SU, *args)
        plain_ms = cuda_ms(lambda: SU.successors_ref(*args), 3)
        n, p = scores.shape
        tests = window_pair_tests(boxes, valid, settings[0])
        # boxes, scores and flags read, the successors written
        n_bytes = n * p * (16 + 4 + 1 + 4)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = tests * PAIR_TEST_OPS / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        graph = {"shape": [n, p], "settings": list(settings),
                 "valid": int(valid.sum()), "edges": int((got >= 0).sum()),
                 "window_pair_tests": tests, "dense_pair_tests": n * p * p}
        profile = profile_detect_lines(*calls["detect_lines"])
    del args, got, boxes, scores, valid
    torch.cuda.empty_cache()
    if not profile["kernels"]:
        raise AssertionError("detect_lines: the profiler saw no device kernel")
    if profile["largest_input_elems"] >= n * p * p:
        raise AssertionError(f"detect_lines ran an op on {profile['largest_input_elems']} "
                             f"elements, N x P x P = {n * p * p}")
    log(f"  successors, the program's proposals {json.dumps(graph)}: equal to the plain "
        f"version bit for bit (card and CPU); kernel {ms:.4f} ms (launcher alone "
        f"{direct_ms:.4f}), bound {bound_ms:.5f} ms (bytes {bytes_ms:.5f}, {n_bytes} bytes; "
        f"pair tests {ops_ms:.5f}), {100 * bound_ms / ms:.2f} % of it; plain {plain_ms:.4f} ms")
    log("  detect_lines profile " + json.dumps(profile))
    return {
        "name": "successors",
        "route": "cuda",
        "source": "ctpn_tpu_torch/ops/csrc/chain_walk.cu",
        "replaces": "ctpn_tpu/postprocess/connector.py:build_successors",
        "launches": None,  # filled from the main path's run
        "max_abs_err": 0.0,  # bit for bit
        "ms": ms,
        "launch_ms": direct_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "pair tests",
        "shapes": [dict(graph, call=f"successors ({n}, {p})")],
        "detect_lines_profile": profile,
    }


# ---------------------------------------------------------------- main path


@contextlib.contextmanager
def plain_nms():
    """Route the NMS dispatch to the plain version, on the card."""
    from ctpn_tpu_torch.ops import nms_fused as NF

    kernel = NF.nms_keep_sorted_fused
    NF.nms_keep_sorted_fused = NF.nms_keep_sorted_fused_ref
    try:
        yield
    finally:
        NF.nms_keep_sorted_fused = kernel


@contextlib.contextmanager
def eager_program(pred):
    """Run ``pred.run_batch`` through the eager detect program instead of
    its captured graphs: a replay would run the kernels it captured, not a
    plain version swapped in (whose host syncs a capture refuses)."""
    graphs = pred.graphs
    pred.graphs = lambda images, im_info: pred.program(
        torch.as_tensor(images).to(pred.device), torch.as_tensor(im_info).to(pred.device))
    try:
        yield
    finally:
        pred.graphs = graphs


@contextlib.contextmanager
def plain_stem():
    """Route the model's block 1 to the stem's plain version, on the card."""
    from ctpn_tpu_torch.models import vgg
    from ctpn_tpu_torch.ops import stem_fused as SF

    vgg.fused_stem_block = SF.fused_stem_block_ref
    try:
        yield
    finally:
        vgg.fused_stem_block = SF.fused_stem_block


def rows_match(a: np.ndarray, b: np.ndarray, atol: float) -> float:
    """One-to-one greedy pairing within ``atol``; returns the worst diff."""
    if a.shape != b.shape:
        raise AssertionError(f"record counts differ: {a.shape} vs {b.shape}")
    used = np.zeros(len(b), bool)
    worst = 0.0
    for row in a:
        d = np.abs(b - row[None]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        if d[j] > atol:
            raise AssertionError(f"record has no match within {atol}: {d[j]}")
        used[j] = True
        worst = max(worst, float(d[j]))
    return worst


def recall_vs_committed(recs: np.ndarray, photo: Path, ref_dir: Path = None) -> tuple:
    """Committed reference lines (``res_<stem>.txt`` in ``ref_dir``, default
    the photo's own directory) matched one-to-one at IoU >= 0.5, counted as
    ``ctpn-torch-eval`` counts them: the records' corner boxes truncated to
    integers, as the demo writes them, then ``eval.match_boxes``."""
    from ctpn_tpu_torch.eval import match_boxes, read_res_txt

    ref = read_res_txt(str((ref_dir or photo.parent) / f"res_{photo.stem}.txt"))
    xs, ys = recs[:, 0:8:2], recs[:, 1:8:2]
    boxes = np.trunc(np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1))
    return match_boxes(boxes.reshape(-1, 4), ref, 0.5), len(ref)


# Precision floor of the photo phases (ROADMAP D2): committed lines matched
# at IoU 0.5 over the lines emitted, on the five photos. Measured 45/46 =
# 0.978 in each of phases 4, 5, 7-10 and 22 (this script on an NVIDIA H100
# 80GB HBM3 at 700 W, two runs); each unmatched line costs about 0.02, so
# the floor allows three more.
PRECISION_FLOOR = 0.90


def line_budget(n_ref: int) -> int:
    """Most lines one photo may emit: twice its committed lines plus three,
    the JAX package's per-image box budget (tests/test_artifact_quality.py).
    Measured worst: 20 lines against 22 committed (008.jpg)."""
    return 2 * n_ref + 3


def check_precision(hits: int, lines: int, what: str) -> None:
    if lines == 0 or hits < PRECISION_FLOOR * lines:
        raise AssertionError(f"{what}: precision {hits}/{lines} below {PRECISION_FLOOR}")
    log(f"  {what}: precision {hits}/{lines} = {hits / lines:.3f} "
        f"(floor {PRECISION_FLOOR})")


def check_budget(name: str, lines: int, n_ref: int, what: str) -> None:
    if lines > line_budget(n_ref):
        raise AssertionError(f"{what} {name}: {lines} lines, budget {line_budget(n_ref)} "
                             f"({n_ref} committed)")


def drive_main_path(dev, kernel_entry: dict, epilogue_entry: dict = None,
                    walk_entry: dict = None, successors_entry: dict = None) -> list:
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.ops import nms_fused as NF
    from ctpn_tpu_torch.utils.image import load_image_bgr
    from ctpn_tpu_torch.utils.weights import load_params

    pred = CTPNPredictor(load_params(str(ARTIFACT), device=dev), device=dev)
    log(f"  predictor: {cfg.TPU.COMPUTE_DTYPE}, mode {pred.mode}, "
        f"NMS_FUSED {cfg.TPU.NMS_FUSED}")
    pred.warmup((608, 912))
    images = [load_image_bgr(str(p)) for p in PHOTOS]

    zero_launch_counts()  # counts of the main path only
    results = []
    for photo, im in zip(PHOTOS, images):
        before = NF.nms_keep_sorted_fused.LAUNCHES
        recs = pred.detect_image(im)
        torch.cuda.synchronize()
        step = NF.nms_keep_sorted_fused.LAUNCHES - before
        if recs.ndim != 2 or recs.shape[1] != 9 or not np.isfinite(recs).all():
            raise AssertionError(f"{photo.name}: bad records {recs.shape}")
        if step != 2:
            raise AssertionError(f"{photo.name}: nms_fused launched {step} times, not 2")
        hit, n_ref = recall_vs_committed(recs, photo)
        log(f"  {photo.name}: {len(recs)} lines, nms_fused launches +{step}, "
            f"committed reference lines matched at IoU 0.5: {hit}/{n_ref}")
        check_budget(photo.name, len(recs), n_ref, "main path")
        results.append((recs, hit, n_ref))
    launches = NF.nms_keep_sorted_fused.LAUNCHES
    kernel_entry["launches"] = launches
    counts = launch_counts()
    if epilogue_entry is not None:
        epilogue_entry["launches"] = counts["conv_epilogue"]
    if walk_entry is not None:
        walk_entry["launches"] = counts["chain_walk"]
    if successors_entry is not None:
        successors_entry["launches"] = counts["successors"]
    total = sum(len(r) for r, _, _ in results)
    hits = sum(h for _, h, _ in results)
    n_ref = sum(n for _, _, n in results)
    if total == 0:
        raise AssertionError("no text lines on the demo photos")
    if launches == 0:
        raise AssertionError("nms_fused was never launched on the main path")
    expect_launches(counts, route_launches("default", len(PHOTOS)),
                    f"main path, {len(PHOTOS)} detect_image calls")
    if hits < 0.75 * n_ref:
        raise AssertionError(f"only {hits}/{n_ref} committed reference lines found")
    check_precision(hits, total, "main path")
    log(f"  main path: {total} lines on {len(PHOTOS)} photos, "
        f"nms_fused launches {launches}, reference recall {hits}/{n_ref}")

    with plain_nms(), eager_program(pred):
        worst = 0.0
        for photo, im, (recs, _, _) in zip(PHOTOS, images, results):
            plain = pred.detect_image(im)
            worst = max(worst, rows_match(plain, recs, 0.5))
    if NF.nms_keep_sorted_fused.LAUNCHES != launches:
        raise AssertionError("the plain-NMS run launched the kernel")
    log(f"  kernel vs plain NMS end to end: records pair one-to-one, "
        f"worst diff {worst} px")

    data, infos = photo_batch()
    sec = time_run_batch(pred, data, infos)
    log("  e2e " + json.dumps({
        "run_batch": "8x608x912 uint8", "ms_per_batch": sec * 1e3,
        "img_per_s": 8 / sec, "iters": 10}))
    return [recs for recs, _, _ in results]


def time_run_batch(pred, data: np.ndarray, infos: np.ndarray, iters: int = 10) -> float:
    """Mean host seconds of ``run_batch`` plus the fetch of its counts,
    after one warm-up run."""
    def batch():
        _, lines = pred.run_batch(data, infos)
        lines.count.cpu()

    return time_batches(batch, iters)


def time_batches(batch, iters: int = 10) -> float:
    """Mean host seconds of ``batch()``, after one warm-up run."""
    batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        batch()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def paired_within(a: np.ndarray, b: np.ndarray, atol: float) -> int:
    """Rows of ``a`` paired one-to-one with rows of ``b`` within ``atol``."""
    used = np.zeros(len(b), bool)
    n = 0
    for row in a:
        if used.all():
            break
        d = np.abs(b - row[None]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        if d[j] <= atol:
            used[j] = True
            n += 1
    return n


def post(url: str, body: bytes) -> tuple:
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def launch_counts() -> dict:
    """Each counted kernel's ``LAUNCHES``, by the registry's names."""
    from ctpn_tpu_torch.ops import _kernel

    return {name: fn.LAUNCHES for name, fn in _kernel.wrappers().items()}


def zero_launch_counts() -> None:
    from ctpn_tpu_torch.ops import _kernel, _launches

    _launches.init(*_kernel.wrappers().values())


# kernel launches per program run (one padded batch) on each route, in
# bf16: a conv epilogue per conv of the trunk and rpn_conv (13 + 1; on the
# served route the stem kernel runs block 1's two convs), and the
# connector's successor graph and chain walk once each
ROUTE_LAUNCHES = {"default": {"nms_fused": 2, "conv_epilogue": 14, "successors": 1,
                              "chain_walk": 1},
                  "served": {"nms_bitmask": 2, "nms_resolve": 2, "stem_fused": 1,
                             "conv_epilogue": 12, "successors": 1, "chain_walk": 1}}


def route_launches(route: str, runs: int) -> dict:
    """The launches of ``runs`` program runs on ``route``."""
    return {name: n * runs for name, n in ROUTE_LAUNCHES[route].items()}


def check_route_launches(counts: dict, batches: int, what: str,
                         route: str = "served") -> None:
    expect_launches(counts, route_launches(route, batches), f"{what}, {batches} batches")


def drive_serving_path(dev, bitmask_entry: dict, resolve_entry: dict,
                       stem_entry: dict, default_recs: list) -> None:
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, forward_features
    from ctpn_tpu_torch.inference.streaming import stream_detect
    from ctpn_tpu_torch.ops import nms
    from ctpn_tpu_torch.serving import DetectionServer
    from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image, resize_im
    from ctpn_tpu_torch.utils.weights import load_params

    params = load_params(str(ARTIFACT), device=dev)
    stock = CTPNPredictor(params, device=dev)  # default cfg: stock stem
    cfg.TPU.NMS_FUSED = False
    cfg.TPU.FUSED_STEM = True
    pred = CTPNPredictor(params, device=dev)
    if not pred.model.trunk.fused_stem or stock.model.trunk.fused_stem:
        raise AssertionError("the cfg flags did not select the stem routes")
    log(f"  predictor: {cfg.TPU.COMPUTE_DTYPE}, mode {pred.mode}, NMS_FUSED "
        f"{cfg.TPU.NMS_FUSED}, FUSED_STEM {cfg.TPU.FUSED_STEM}")

    # The fused-stem model against the same model with the stem's plain
    # version (the kernel's own definition) and against the stock-stem
    # model. In the served bf16 trunk a stem value that rounds to the other
    # bf16 neighbour propagates through eleven more bf16 convs: limit 2e-2,
    # the port's bf16 head tolerance (tests/test_torch_model.py). With an
    # f32 trunk only the stem rounds: kernel against plain version at 5e-3,
    # the JAX package's fused-stem tolerance (tests/test_stem.py).
    dtype = cfg.TPU.COMPUTE_DTYPE
    cfg.TPU.COMPUTE_DTYPE = "float32"
    pred32 = CTPNPredictor(params, device=dev)
    cfg.TPU.COMPUTE_DTYPE = dtype
    worst = {"plain": 0.0, "stock": 0.0, "plain_f32": 0.0}
    buckets = []
    for photo in PHOTOS:
        im, _ = resize_im(load_image_bgr(str(photo)), cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
        padded = prep_image(im)[0]
        buckets.append(padded.shape[:2])
        x = torch.from_numpy(padded[None]).to(dev)
        with torch.inference_mode():
            a = forward_features(pred.model, x).cls_prob
            a32 = forward_features(pred32.model, x).cls_prob
            with plain_stem():
                p = forward_features(pred.model, x).cls_prob
                p32 = forward_features(pred32.model, x).cls_prob
            b = forward_features(stock.model, x).cls_prob
        if not (torch.isfinite(a).all() and torch.isfinite(a32).all()):
            raise AssertionError(f"{photo.name}: non-finite cls_prob")
        for key, (u, v) in {"plain": (a, p), "stock": (a, b),
                            "plain_f32": (a32, p32)}.items():
            worst[key] = max(worst[key], float((u - v).abs().max()))
    log(f"  fused-stem cls_prob on {len(PHOTOS)} photos, max abs diff: {dtype} "
        f"trunk, kernel vs the stem's plain version {worst['plain']:.3e} and vs "
        f"the stock stem {worst['stock']:.3e} (limit 2e-2); float32 trunk, "
        f"kernel vs plain version {worst['plain_f32']:.3e} (limit 5e-3)")
    if max(worst["plain"], worst["stock"]) > 2e-2 or worst["plain_f32"] > 5e-3:
        raise AssertionError("fused-stem cls_prob out of tolerance")
    del pred32

    # One batch of 8 through run_batch on three routes. Both NMS routes are
    # integer-exact, so with the stock stem the bitmask route must emit the
    # default route's records: same counts, 0.0 px. What still differs
    # between the served and the default route is then the stem's.
    data, infos = photo_batch()

    def batch_records(predictor, nms_fused):
        cfg.TPU.NMS_FUSED = nms_fused
        try:
            _, lines = predictor.run_batch(data, infos)
            counts = lines.count.cpu().numpy()
            recs = lines.recs.cpu().numpy()
        finally:
            cfg.TPU.NMS_FUSED = False
        return [recs[i, :int(counts[i])] for i in range(len(counts))]

    default = batch_records(stock, True)
    bitmask = batch_records(stock, False)
    served = batch_records(pred, False)
    worst_px = max(rows_match(a, b, 0.0) for a, b in zip(bitmask, default))
    n_recs = sum(len(r) for r in default)
    log(f"  bitmask route against default route, stock stem, one batch of 8: "
        f"{n_recs} records, counts equal, worst diff {worst_px} px")
    same = sum(paired_within(a, b, 0.0) for a, b in zip(served, bitmask))
    near = sum(paired_within(a, b, 0.5) for a, b in zip(served, bitmask))
    log(f"  fused stem against stock stem, bitmask route, same batch: "
        f"{sum(len(r) for r in served)} against {n_recs} records, {same} identical, "
        f"{near} within 0.5 px: the stem moves {n_recs - near}")
    del stock

    for bucket in sorted(set(buckets)):  # build, cuDNN algorithm choice, capture
        pred.warmup(bucket, batch=8)
    log(f"  served predictor: {len(pred.graphs.graphs)} captured programs in one "
        f"pool of {pred.graphs.pool_mib()} MiB: "
        + ", ".join(f"{k[1]}x{k[2]}x{k[3]} {v.capture_s:.3f} s"
                    for k, v in pred.graphs.graphs.items()))
    bodies = [p.read_bytes() for p in PHOTOS]
    requests = list(range(len(PHOTOS))) + [4, 1, 2]  # 5 photos + 3 repeats
    srv = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=8,
                          window_ms=200.0)
    serve_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    serve_thread.start()
    host, port = srv.server_address
    results = [None] * len(requests)

    def client(slot):
        results[slot] = post(f"http://{host}:{port}/detect", bodies[requests[slot]])

    try:
        zero_launch_counts()  # counts of the serving path only
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = launch_counts()
        batches = srv.batcher.batches_run
    finally:
        srv.shutdown()
        srv.batcher.join(timeout=60)
        serve_thread.join(timeout=60)
    log(f"  HTTP: {len(requests)} concurrent POSTs answered in {wall:.3f} s, "
        f"{batches} batches, launches {counts}")
    hits = n_ref = n_lines = 0
    for slot, res in enumerate(results):
        if res is None:
            raise AssertionError(f"request {slot} got no response")
        status, out = res
        photo = PHOTOS[requests[slot]]
        if status != 200:
            raise AssertionError(f"{photo.name}: HTTP {status} {out}")
        recs = np.asarray(out["boxes"], np.float64).reshape(-1, 9)
        if out["count"] != len(recs) or not np.isfinite(recs).all():
            raise AssertionError(f"{photo.name}: bad records")
        if slot < len(PHOTOS):
            hit, n = recall_vs_committed(recs, photo)
            hits, n_ref, n_lines = hits + hit, n_ref + n, n_lines + len(recs)
            check_budget(photo.name, len(recs), n, "served path")
            ref = default_recs[slot]
            log(f"  {photo.name}: {len(recs)} lines over HTTP, reference lines "
                f"{hit}/{n}; {paired_within(recs, ref, 0.5)} of {len(ref)} default-"
                f"route records paired within 0.5 px")
    if batches >= len(requests):
        raise AssertionError(f"{batches} batches for {len(requests)} requests: no coalescing")
    check_route_launches(counts, batches, "served path")
    if hits < 0.75 * n_ref:
        raise AssertionError(f"only {hits}/{n_ref} committed reference lines found")
    check_precision(hits, n_lines, "served path")
    bitmask_entry["launches"] = counts["nms_bitmask"]
    resolve_entry["launches"] = counts["nms_resolve"]
    stem_entry["launches"] = counts["stem_fused"]
    log(f"  served path: reference recall {hits}/{n_ref}")

    zero_launch_counts()
    streamed = dict(stream_detect([str(p) for p in PHOTOS], pred, batch_size=8))
    torch.cuda.synchronize()
    n_batches = len(set(buckets))  # 5 photos < 8: one padded batch per bucket
    check_route_launches(launch_counts(), n_batches, "stream_detect")
    for slot, photo in enumerate(PHOTOS):
        recs = streamed[str(photo)]
        if recs.ndim != 2 or recs.shape[1] != 9 or not np.isfinite(recs).all():
            raise AssertionError(f"{photo.name}: bad streamed records")
        http = np.asarray(results[slot][1]["boxes"], np.float64).reshape(-1, 9)
        log(f"  stream_detect {photo.name}: {len(recs)} lines, "
            f"{paired_within(recs, http, 0.5)} paired with HTTP within 0.5 px")
    log(f"  stream_detect: {n_batches} batches, launches {launch_counts()}")

    # the bitmask route's NMS at the served shapes, with any device-to-host
    # sync made an error: both phases must stay on the card
    boxes = proposal_like_boxes(np.random.RandomState(4), 8, 12000).to(dev)
    ones = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
    small = boxes[:, :1000].contiguous()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keeps = [nms.nms_keep_sorted(boxes, ones, 0.7),
                 nms.nms_keep_sorted(small, ones[:, :1000], 0.2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"  nms_keep_sorted on the bitmask route at (8,12000) and (8,1000) with "
        f"syncs made an error: no sync, kept {keeps[0].sum(dim=1).tolist()} and "
        f"{keeps[1].sum(dim=1).tolist()}")

    data, infos = photo_batch()
    sweeps = nms.nms_fixed_point_blocked.SWEEPS
    zero_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, lines = pred.run_batch(data, infos)  # the issue only
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines.count.cpu()
    n_resolves = launch_counts()["nms_resolve"]
    if nms.nms_fixed_point_blocked.SWEEPS != sweeps:
        raise AssertionError("the served batch ran the plain resolve's sweeps")
    n_syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    sec = time_run_batch(pred, data, infos)
    log("  e2e " + json.dumps({
        "route": "NMS_FUSED False, FUSED_STEM True",
        "run_batch": "8x608x912 uint8", "ms_per_batch": sec * 1e3,
        "img_per_s": 8 / sec, "iters": 10,
        "resolve_launches_per_batch": n_resolves,
        "host_syncs_per_batch": n_syncs}))


def check_cli() -> None:
    """The serve CLI as a subprocess: one POST, 200 and count > 0."""
    def one_post(port):
        status, out = post(f"http://127.0.0.1:{port}/detect", PHOTOS[-1].read_bytes())
        if status != 200 or out.get("count", 0) <= 0:
            raise AssertionError(f"serve CLI answered {status}: {out}")
        log(f"  serve CLI on port {port}: HTTP {status}, {out['count']} lines "
            f"for {PHOTOS[-1].name}")

    serve_subprocess(["--artifact", str(ARTIFACT), "--no-warmup", "--set", *SERVED_ROUTE],
                     one_post)


# ---------------------------------------------------------------- the rest of inference

COMMITTED = REPO / "docs" / "demo_results"
OUT = REPO / "output" / "chip_smoke"  # git-ignored; removed at the end
FROZEN_SHAPES = [(1, 608, 912), (1, 912, 608), (8, 608, 912), (8, 912, 608)]
SERVED_SHAPES = [(8, 608, 912)]
SERVED_ROUTE = ["TPU.NMS_FUSED", "False", "TPU.FUSED_STEM", "True"]
FROZEN_PHOTO_RECS: dict = {}  # phase 9's default-route artifact on the photos


def recall_over_photos(detect, ref_dir: Path, what: str) -> tuple:
    """``detect(photo) -> records`` over the five photos against the committed
    lines in ``ref_dir``; fails below 75 % recall, below the precision floor
    or past a photo's line budget. Returns (hits, n_ref, lines)."""
    hits = n_ref = lines = 0
    for photo in PHOTOS:
        recs = detect(photo)
        if recs.ndim != 2 or recs.shape[1] != 9 or not np.isfinite(recs).all():
            raise AssertionError(f"{what} {photo.name}: bad records {recs.shape}")
        hit, n = recall_vs_committed(recs, photo, ref_dir)
        hits, n_ref, lines = hits + hit, n_ref + n, lines + len(recs)
        log(f"  {what} {photo.name}: {len(recs)} lines, committed lines matched "
            f"{hit}/{n}")
        check_budget(photo.name, len(recs), n, what)
    if hits < 0.75 * n_ref:
        raise AssertionError(f"{what}: only {hits}/{n_ref} committed lines found")
    check_precision(hits, lines, what)
    log(f"  {what}: {lines} lines, {hits}/{n_ref} of {ref_dir.relative_to(REPO)} found")
    return hits, n_ref, lines


def expect_launches(counts: dict, want: dict, what: str) -> None:
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def drive_o_mode(dev) -> None:
    """O mode at batch 8 (two fused-NMS launches and the 14 conv epilogues,
    no other kernel), then the five photos against the committed O-mode
    lines."""
    from ctpn_tpu_torch.config import reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.image import load_image_bgr
    from ctpn_tpu_torch.utils.weights import load_params

    reset_cfg()
    pred = CTPNPredictor(load_params(str(ARTIFACT), device=dev), mode="O", device=dev)
    data, infos = photo_batch()
    pred.warmup(data.shape[1:3], batch=len(data))
    zero_launch_counts()
    _, lines = pred.run_batch(data, infos)
    counts = lines.count.cpu().tolist()
    expect_launches(launch_counts(), route_launches("default", 1), "O mode, one batch of 8")
    sec = time_run_batch(pred, data, infos)
    zero_launch_counts()
    hits, n_ref, _ = recall_over_photos(
        lambda p: pred.detect_image(load_image_bgr(str(p))), COMMITTED / "O", "O mode")
    expect_launches(launch_counts(), route_launches("default", len(PHOTOS)), "O mode photos")
    log("  e2e " + json.dumps({
        "mode": "O", "run_batch": "x".join(map(str, data.shape[:3])) + " uint8",
        "line_counts": counts,
        "ms_per_batch": sec * 1e3, "img_per_s": 8 / sec, "iters": 10,
        "committed_recall": f"{hits}/{n_ref}"}))


def drive_host_path(dev) -> None:
    """``detect_image_host`` in H and O: the card runs the network only, the
    proposal decode and connector run on the host; no NMS kernel launches,
    the trunk's conv epilogues only."""
    from ctpn_tpu_torch.config import reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.image import load_image_bgr
    from ctpn_tpu_torch.utils.weights import load_params

    reset_cfg()
    params = load_params(str(ARTIFACT), device=dev)
    images = {p: load_image_bgr(str(p)) for p in PHOTOS}
    for mode in ("H", "O"):
        pred = CTPNPredictor(params, mode=mode, device=dev)
        pred.detect_image_host(images[PHOTOS[-1]])  # cuDNN algorithm choice
        laps = []

        def detect(photo):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = pred.detect_image_host(images[photo])
            laps.append(time.perf_counter() - t0)
            return recs

        zero_launch_counts()
        recall_over_photos(detect, COMMITTED / f"{mode}_host", f"host path {mode}")
        expect_launches(launch_counts(), {"conv_epilogue": 14 * len(PHOTOS)},
                        f"host path {mode}")
        log("  e2e " + json.dumps({
            "host_postprocess": mode, "ms_per_image": [t * 1e3 for t in laps],
            "mean_ms": float(np.mean(laps)) * 1e3}))


FROZEN_PROBE = r"""
import json, sys
import numpy as np
sys.modules["ctpn_tpu_torch.models"] = None  # the loader must not need model code
import torch
from ctpn_tpu_torch.inference.frozen import FrozenCTPN
from ctpn_tpu_torch.ops import _kernel, _launches

wrappers = _kernel.wrappers()
batch = np.load(sys.argv[1])
report, arrays = {}, {}
for name, path in zip(sys.argv[3::2], sys.argv[4::2]):
    art = FrozenCTPN(path)
    art.run_batch(batch["data"], batch["infos"])  # load the program, warm up
    torch.cuda.synchronize()
    _launches.init(*wrappers.values())
    out = art.run_batch(batch["data"], batch["infos"])
    out = [t.cpu().numpy() for t in out]
    report[name] = {"launches": {k: fn.LAUNCHES for k, fn in wrappers.items()},
                    "shapes": art.shapes, "meta": art.meta}
    for key, value in zip(art.meta["abi"], out):
        arrays[f"{name}/{key}"] = value
    if name == "default":
        for photo in batch["photos"]:
            arrays[f"photo/{photo}"] = art.detect_path(str(photo))
report["models_imported"] = any(m.startswith("ctpn_tpu_torch.models.")
                                for m in sys.modules)
np.savez(sys.argv[2], **arrays)
print(json.dumps(report))
"""


def run_frozen_probe(batch_file: Path, artifacts: dict) -> tuple:
    """Load and run the artifacts in a subprocess that cannot import
    ``ctpn_tpu_torch.models``; returns (report, arrays)."""
    out_file = OUT / "probe_out.npz"
    cmd = [sys.executable, "-c", FROZEN_PROBE, str(batch_file), str(out_file)]
    for name, path in artifacts.items():
        cmd += [name, str(path)]
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=str(REPO)))
    if proc.returncode != 0:
        raise AssertionError(f"frozen probe failed:\n{proc.stdout}\n{proc.stderr}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    if report["models_imported"]:
        raise AssertionError("the frozen loader imported ctpn_tpu_torch.models")
    with np.load(out_file) as z:
        return report, {k: z[k] for k in z.files}


def compare_outputs(got: list, want: list, what: str) -> tuple:
    """Flat outputs (rois, roi_valid, roi_count, recs, line_valid,
    line_count) against others on the same batch: counts equal, records
    paired within 0.5 px; returns (worst pair px, largest float difference
    of rois and records)."""
    rois, _, roi_count, recs, _, line_count = got
    if not (np.array_equal(roi_count, want[2]) and np.array_equal(line_count, want[5])):
        raise AssertionError(f"{what}: counts differ: rois {roi_count.tolist()} vs "
                             f"{want[2].tolist()}, lines {line_count.tolist()} vs "
                             f"{want[5].tolist()}")
    worst_px = max(rows_match(recs[i, :c], want[3][i, :c], 0.5)
                   for i, c in enumerate(line_count))
    diff = max(float(np.abs(rois - want[0]).max()), float(np.abs(recs - want[3]).max()))
    return worst_px, diff


def compare_frozen(arrays: dict, name: str, live: tuple, what: str) -> float:
    """Frozen outputs against the live pipeline's on the same batch
    (:func:`compare_outputs`); returns the largest float difference."""
    from ctpn_tpu_torch.inference.frozen import ABI

    got = [arrays[f"{name}/{key}"] for key in ABI]
    worst_px, diff = compare_outputs(got, live, what)
    log(f"  {what}: roi counts {got[2].tolist()}, line counts "
        f"{got[5].tolist()} equal to the live pipeline's; records paired, worst "
        f"{worst_px} px; largest float difference (rois, records) {diff}")
    return diff


def live_outputs(pred, data, infos) -> list:
    return flat_outputs(pred.run_batch(data, infos))


def flat_outputs(out) -> list:
    """(Proposals, TextLines) on the card -> the flat ABI list on the host."""
    props, lines = out
    return [t.cpu().numpy() for t in (*props, *lines)]


def drive_frozen(dev) -> Path:
    """Export both routes on the card, then load and run them in a
    subprocess without model code: kernels launch from inside the programs,
    outputs equal the live pipeline's. Returns the default route's
    artifact."""
    from ctpn_tpu_torch.config import cfg, cfg_from_list, reset_cfg
    from ctpn_tpu_torch.inference.frozen import export_frozen
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    OUT.mkdir(parents=True, exist_ok=True)
    data, infos = photo_batch()
    batch_file = OUT / "batch.npz"
    np.savez(batch_file, data=data, infos=infos,
             photos=np.array([str(p) for p in PHOTOS]))
    params = load_params(str(ARTIFACT), device=dev)
    routes = {}
    for name, sets, shapes in (("default", [], FROZEN_SHAPES),
                               ("served", SERVED_ROUTE, SERVED_SHAPES)):
        reset_cfg()
        cfg_from_list(sets)
        pred = CTPNPredictor(params, device=dev)
        live = live_outputs(pred, data, infos)
        path = OUT / f"frozen_{name}.npz"
        t0 = time.perf_counter()
        export_frozen(params, str(path), shapes=shapes, device=dev)
        log(f"  export_frozen {name} route (NMS_FUSED {cfg.TPU.NMS_FUSED}, FUSED_STEM "
            f"{cfg.TPU.FUSED_STEM}), shapes {shapes}: {time.perf_counter() - t0:.1f} s, "
            f"{path.stat().st_size / 2**20:.1f} MiB")
        routes[name] = (path, live)
        del pred
    reset_cfg()
    t0 = time.perf_counter()
    report, arrays = run_frozen_probe(batch_file, {k: v[0] for k, v in routes.items()})
    log(f"  subprocess without ctpn_tpu_torch.models: loaded and ran both artifacts "
        f"in {time.perf_counter() - t0:.1f} s")
    expect_launches(report["default"]["launches"], route_launches("default", 1),
                    "frozen default route, batch 8")
    expect_launches(report["served"]["launches"], route_launches("served", 1),
                    "frozen served route, batch 8")
    log(f"  launches from inside the programs, one batch of 8: default "
        f"{report['default']['launches']}, served {report['served']['launches']}")
    diffs = {name: compare_frozen(arrays, name, routes[name][1], f"frozen {name} route")
             for name in routes}
    recall_over_photos(lambda p: arrays[f"photo/{p}"], COMMITTED / "H",
                       "frozen detect_image")
    FROZEN_PHOTO_RECS.update({p.name: arrays[f"photo/{p}"] for p in PHOTOS})
    log("  e2e " + json.dumps({"frozen_max_float_diff": diffs,
                               "meta_device": report["default"]["meta"].get("device_name")}))
    return routes["default"][0]


def run_cli(args: list, timeout: int = 600) -> str:
    proc = subprocess.run([sys.executable, "-m", *args], cwd=str(REPO),
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def eval_dir(out_dir: Path, ref_dir: Path, what: str) -> dict:
    """``ctpn-torch-eval`` on a result directory: recall >= 0.75, precision
    at least the floor, every photo within its line budget."""
    from ctpn_tpu_torch.eval import read_res_txt

    score = json.loads(run_cli(["ctpn_tpu_torch.eval", str(out_dir), str(ref_dir)]))
    log(f"  ctpn-torch-eval {what} against {ref_dir.relative_to(REPO)}: " + json.dumps(score))
    if score["recall"] < 0.75:
        raise AssertionError(f"{what}: recall {score['recall']} < 0.75")
    check_precision(score["matched"], score["candidate_boxes"], what)
    for photo in PHOTOS:
        res = f"res_{photo.stem}.txt"
        check_budget(photo.name, len(read_res_txt(str(out_dir / res))),
                     len(read_res_txt(str(ref_dir / res))), what)
    return score


def check_clis(served_artifact: Path) -> None:
    """demo, eval, export --frozen and demo --frozen as subprocesses, then
    the serve CLI on ``served_artifact`` (phase 9's default route, which
    has the batch-8 programs of both buckets)."""
    images = str(COMMITTED / "H")
    t0 = time.perf_counter()
    run_cli(["ctpn_tpu_torch.cli.demo", "--artifact", str(ARTIFACT),
             "--images", images, "--output", str(OUT / "demo")])
    written = sorted(p.name for p in (OUT / "demo").iterdir())
    if len([n for n in written if n.startswith("res_")]) != len(PHOTOS) or \
            len(written) != 2 * len(PHOTOS):
        raise AssertionError(f"ctpn-torch-demo wrote {written}")
    log(f"  ctpn-torch-demo: {len(written)} files in {time.perf_counter() - t0:.1f} s")
    eval_dir(OUT / "demo", COMMITTED / "H", "ctpn-torch-demo")

    frozen = OUT / "cli_frozen.npz"
    t0 = time.perf_counter()
    run_cli(["ctpn_tpu_torch.cli.export_model", "--artifact", str(ARTIFACT),
             "--out", str(frozen), "--frozen", "--frozen-shapes",
             ",".join("x".join(map(str, s)) for s in FROZEN_SHAPES if s[0] == 1)])
    log(f"  ctpn-torch-export --frozen (batch-1 programs): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_cli(["ctpn_tpu_torch.cli.demo", "--frozen", str(frozen),
             "--images", images, "--output", str(OUT / "demo_frozen")])
    log(f"  ctpn-torch-demo --frozen: {time.perf_counter() - t0:.1f} s")
    eval_dir(OUT / "demo_frozen", COMMITTED / "H", "ctpn-torch-demo --frozen")

    def post_each_bucket(port):
        for photo in (PHOTOS[1], PHOTOS[0]):  # 608x912 (007), 912x608 (006)
            status, out = post(f"http://127.0.0.1:{port}/detect", photo.read_bytes())
            if status != 200 or out.get("count", 0) <= 0:
                raise AssertionError(f"serve on the frozen artifact: {status} {out}")
            log(f"  ctpn-torch-serve (frozen) {photo.name}: HTTP {status}, "
                f"{out['count']} lines, image {out['image_shape']}")

    t0 = time.perf_counter()
    serve_subprocess(["--artifact", str(served_artifact), "--max-batch", "8"],
                     post_each_bucket)
    log(f"  ctpn-torch-serve on the frozen artifact: {time.perf_counter() - t0:.1f} s")


def serve_subprocess(args: list, client) -> None:
    """Start the serve CLI on port 0 with ``args``, call ``client(port)``
    once it listens, then stop it."""
    cmd = [sys.executable, "-m", "ctpn_tpu_torch.cli.serve", "--port", "0", *args]
    proc = subprocess.Popen(cmd, cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    lines: "queue.Queue" = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    seen = []
    try:
        port = None
        deadline = time.monotonic() + 300
        while port is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=5)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            seen.append(line)
            if "listening on" in line:
                port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        if port is None:
            raise AssertionError("the serve CLI printed no listening line:\n" + "".join(seen))
        client(port)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=10)


# ---------------------------------------------------------------- training

TRAIN_PARITY_BUCKET = (256, 384)
TRAIN_BUCKET = (608, 912)
TRAIN_OUT = REPO / "output" / "chip_smoke_train"  # git-ignored; removed at the end


def train_arrays(seed: int, n: int, bucket: tuple) -> list:
    """``n`` scenes of the port's synthetic renderer filling ``bucket``, with
    their ground truth cut into 16-px strips as ``ctpn-torch-prepare`` cuts
    it: the seven arrays of a training ``Batch``."""
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.data.prepare import split_polygon_to_strips
    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(seed)
    h, w = bucket
    max_gt, max_dc = cfg.TPU.MAX_GT, cfg.TPU.MAX_DONTCARE
    images = np.zeros((n, h, w, 3), np.uint8)
    gt = np.zeros((n, max_gt, 4), np.float32)
    valid = np.zeros((n, max_gt), bool)
    for i in range(n):
        strips = []
        while not strips:  # a scene may come out without text: draw again
            rgb, polys = render_image(rng, width=w, height=h)
            strips = [s for p in polys
                      for s in split_polygon_to_strips([int(v) for v in p], h, w)]
        images[i] = rgb[..., ::-1]  # BGR, as load_image_bgr gives
        strips = strips[:max_gt]
        gt[i, :len(strips)] = strips
        valid[i, :len(strips)] = True
    return [images, np.tile(np.array([h, w, 1.0], np.float32), (n, 1)), gt, valid,
            np.zeros((n, max_gt), bool), np.zeros((n, max_dc, 4), np.float32),
            np.zeros((n, max_dc), bool)]


def fresh_train_model(dev, state_dict: dict):
    """The training network (``get_network("VGGnet_train")``) on ``dev``
    with ``state_dict`` loaded, in train mode."""
    from ctpn_tpu_torch.models.factory import get_network

    model = get_network("VGGnet_train", device=dev)
    model.load_state_dict(state_dict)
    return model.train()


def step_record(model, before: list, metrics: dict) -> dict:
    """What a compared step leaves: its metrics, the update and the raw
    gradients, flattened on the CPU."""
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                delta=torch.cat([(p.detach() - b).flatten().cpu()
                                 for p, b in zip(model.parameters(), before)]),
                grad=torch.cat([p.grad.flatten().cpu() for p in model.parameters()]))


def compare_updates(ref: dict, other: dict, lr: float, what: str) -> tuple:
    """Adam's first step moves each parameter by about lr * sign(g): the
    updates must agree within 1e-3 * lr wherever the reference gradient
    exceeds 1e-6, and within 2 * lr (any sign) where rounding noise decides
    it. Returns (worst difference, worst among the noisy, noisy count)."""
    noisy = ref["grad"].abs() <= 1e-6
    diff = (ref["delta"] - other["delta"]).abs()
    worst = float(diff[~noisy].max())
    worst_noisy = float(diff[noisy].max()) if noisy.any() else 0.0
    if worst > 1e-3 * lr or worst_noisy > 2 * lr:
        raise AssertionError(f"{what}: updates differ by {worst} (|g| > 1e-6), "
                             f"{worst_noisy} (|g| <= 1e-6), lr {lr}")
    return worst, worst_noisy, int(noisy.sum())


def check_train_parity(dev) -> dict:
    """One full-width Adam step on the card and on the CPU from the same
    parameters (``init_params``), batch and draws, float32 compute with
    TF32 off: anchor-target labels identical, targets within 1e-5, total
    loss and raw gradient norm within 1e-4 relative; the update within
    1e-3 * lr on every element whose CPU gradient exceeds 1e-6 (below that,
    rounding noise decides the sign Adam steps by; those are held to
    2 * lr and counted)."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.models.factory import init_params
    from ctpn_tpu_torch.ops.anchor_target import anchor_target_layer, num_anchors
    from ctpn_tpu_torch.parallel.multicard import no_tf32
    from ctpn_tpu_torch.training.train_step import (
        Batch,
        build_train_step,
        create_train_state,
        target_kwargs,
    )
    from ctpn_tpu_torch.utils.weights import params_from_jax

    reset_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.SOLVER, cfg.TRAIN.LEARNING_RATE = "Adam", 1e-4
    lr = cfg.TRAIN.LEARNING_RATE
    h, w = TRAIN_PARITY_BUCKET
    fh, fw = h // 16, w // 16
    arrays = train_arrays(11, 2, (h, w))
    state_dict = params_from_jax(init_params(cfg.RNG_SEED))
    draws = torch.rand((2, 2, num_anchors(fh, fw)),
                       generator=torch.Generator().manual_seed(5))
    out = []
    with no_tf32():
        for d in (torch.device("cpu"), dev):
            batch = Batch.from_numpy(arrays).to(d)
            with torch.no_grad():
                targets = anchor_target_layer(
                    batch.gt_boxes, batch.gt_valid, batch.gt_ishard, batch.dontcare,
                    batch.dontcare_valid, batch.im_info, draws[0].to(d), draws[1].to(d),
                    fh, fw, **target_kwargs())
            model = fresh_train_model(d, state_dict)
            before = [p.detach().clone() for p in model.parameters()]
            t0 = time.perf_counter()
            metrics = build_train_step(model, fh, fw)(create_train_state(model), batch, draws)
            out.append(dict(step_record(model, before, metrics),
                            sec=time.perf_counter() - t0, labels=targets.labels.cpu(),
                            bbox_targets=targets.bbox_targets.cpu()))
            del model, before
    cpu, card = out
    if not torch.equal(cpu["labels"], card["labels"]):
        raise AssertionError(f"anchor-target labels differ on "
                             f"{int((cpu['labels'] != card['labels']).sum())} anchors")
    tgt_err = float((cpu["bbox_targets"] - card["bbox_targets"]).abs().max())
    if tgt_err > 1e-5:
        raise AssertionError(f"bbox_targets differ by {tgt_err}")
    rel = {k: abs(card["metrics"][k] - cpu["metrics"][k]) / abs(cpu["metrics"][k])
           for k in ("total_loss", "model_loss", "grad_norm")}
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card against CPU, relative differences {rel}")
    worst, worst_noisy, n_noisy = compare_updates(cpu, card, lr, "card against CPU")
    report = {
        "bucket": f"2x{h}x{w}", "dtype": "float32, TF32 off",
        "labels_equal": True, "fg": int((card["labels"] == 1).sum()),
        "bg": int((card["labels"] == 0).sum()), "bbox_targets_max_abs_diff": tgt_err,
        "rel_diff": rel, "update_max_abs_diff": worst,
        "elements_grad_le_1e-6": n_noisy, "their_update_max_abs_diff": worst_noisy,
        "total_loss": card["metrics"]["total_loss"], "grad_norm": card["metrics"]["grad_norm"],
        "cpu_step_s": cpu["sec"]}
    log("  train parity " + json.dumps(report))
    return report


def profile_steps(run, n: int = 2) -> dict:
    """``n`` calls of ``run()`` (one training step each, returning its
    metrics) under ``torch.profiler``: the card's busy share (summed kernel
    time over the window's wall time), kernels per step and the top kernels
    by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            m = run()
        float(m["total_loss"])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    top = sorted(events, key=dev_ms, reverse=True)[:6]
    return {"device_ms_per_step": sum(dev_ms(e) for e in events) / n,
            "device_busy_share": sum(dev_ms(e) for e in events) / window_ms,
            "kernels_per_step": sum(e.count for e in events) / n,
            "top_kernels": [{"name": e.key[:70], "device_ms_per_step": dev_ms(e) / n,
                             "calls_per_step": e.count / n} for e in top]}


def time_steps(run, iters: int) -> float:
    """Mean host ms of ``run()`` (one step, returning its metrics) over
    ``iters`` calls ended by a fetch and a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        m = run()
    float(m["total_loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def rewind(state, saved: list) -> None:
    """Put back a state's tensors (``state_tensors``) and host counters as
    ``saved`` (from :func:`keep`) holds them: in place, so that a captured
    step still reads them."""
    from ctpn_tpu_torch.training.train_step import state_tensors

    tensors, step, count = saved
    with torch.no_grad():
        for t, v in zip(state_tensors(state), tensors):
            t.copy_(v)
    state.step = step
    if count is not None:
        state.opt_state["count"] = count


def keep(state) -> list:
    """A copy of a state's tensors and host counters, for :func:`rewind`."""
    from ctpn_tpu_torch.training.train_step import state_tensors

    return [[t.detach().clone() for t in state_tensors(state)], state.step,
            state.opt_state.get("count")]


def full_size_steps(dev) -> list:
    """Full width, 608x912, bf16 compute: the Adam step at batch 1 and 2,
    ``TPU.REMAT`` off and on, from the same parameters and draws, through
    ``TrainGraphs``: the first call (the eager warm-up step, then the
    capture), then the state rewound in place and the same step replayed,
    twice: the two replayed steps must be equal bit for bit (metrics,
    update, gradients; whether the eager step equals them is printed).
    Per setting: the peak of ``max_memory_allocated`` over the first call.
    REMAT must give plain's loss (1e-6 relative), its gradient norm (1e-3)
    and its update (as :func:`compare_updates` holds the card to the CPU),
    on the eager step and on the replayed one, at a lower peak. Times are
    phase 18's."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.models.factory import init_params
    from ctpn_tpu_torch.ops.anchor_target import num_anchors
    from ctpn_tpu_torch.training.graphs import TrainGraphs
    from ctpn_tpu_torch.training.train_step import Batch, create_train_state
    from ctpn_tpu_torch.utils.weights import params_from_jax

    reset_cfg()
    cfg.TRAIN.SOLVER = "Adam"
    h, w = TRAIN_BUCKET
    arrays = train_arrays(12, 2, (h, w))
    state_dict = params_from_jax(init_params(cfg.RNG_SEED))
    rows = []
    for n in (1, 2):
        batch = Batch.from_numpy([a[:n] for a in arrays], pin=True)
        draws = torch.rand((2, n, num_anchors(h // 16, w // 16)),
                           generator=torch.Generator().manual_seed(6))
        recs = {}
        for remat in (False, True):
            cfg.TPU.REMAT = remat
            model = fresh_train_model(dev, state_dict)
            state = create_train_state(model)
            graphs = TrainGraphs(state, dev)
            saved = keep(state)
            before = [p.detach().clone() for p in model.parameters()]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            eager = step_record(model, before, graphs(batch, draws))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            rewind(state, saved)
            replayed = step_record(model, before, graphs(batch, draws))
            rewind(state, saved)
            again = step_record(model, before, graphs(batch, draws))
            if not same_step(replayed, again):
                raise AssertionError(
                    f"batch {n}, REMAT {remat}: two replayed steps from one state differ "
                    f"(update by {float((replayed['delta'] - again['delta']).abs().max())})")
            (entry,) = graphs.graphs.values()
            recs[remat] = (eager, replayed)
            rows.append({"batch": n, "remat": remat, "peak_mib": peak / 2**20,
                         "capture_s": entry.capture_s, "pool_mib": graphs.pool_mib(),
                         "total_loss": replayed["metrics"]["total_loss"],
                         "replayed_equals_eager": same_step(eager, replayed)})
            log("  full-size step " + json.dumps(rows[-1]))
            del model, state, graphs, entry, before, saved
            torch.cuda.empty_cache()
        plain, remat_row = rows[-2], rows[-1]
        for i, which in enumerate(("eager", "replayed")):
            m0, m1 = recs[False][i]["metrics"], recs[True][i]["metrics"]
            rel = {k: abs(m1[k] - m0[k]) / abs(m0[k]) for k in ("total_loss", "grad_norm")}
            if rel["total_loss"] > 1e-6 or rel["grad_norm"] > 1e-3:
                raise AssertionError(f"batch {n}, {which} step: REMAT against plain, "
                                     f"relative differences {rel}")
            worst, worst_noisy, n_noisy = compare_updates(
                recs[False][i], recs[True][i], cfg.TRAIN.LEARNING_RATE,
                f"batch {n}, {which} step: REMAT")
            remat_row[which] = dict(rel_diff_vs_plain=rel, update_max_abs_diff_vs_plain=worst,
                                    noisy_update_max_abs_diff_vs_plain=worst_noisy,
                                    elements_grad_le_1e6=n_noisy)
        if not remat_row["peak_mib"] < plain["peak_mib"]:
            raise AssertionError(f"batch {n}: REMAT peak {remat_row['peak_mib']} MiB "
                                 f"is not below plain's {plain['peak_mib']} MiB")
        log(f"  batch {n}: REMAT against plain, eager {remat_row['eager']}, replayed "
            f"{remat_row['replayed']}; peak {plain['peak_mib']:.1f} -> "
            f"{remat_row['peak_mib']:.1f} MiB")
    reset_cfg()
    return rows


COUNTED_MAIN = r"""
import importlib, importlib.util, json, os, subprocess, sys
from ctpn_tpu_torch.ops import _kernel
_run = subprocess.run
def _counted_run(cmd, *args, **kwargs):
    # a child that runs a module of the package (train_synth's segments)
    # counts and prints its own launches, as this process does
    if isinstance(cmd, list) and cmd[1:2] == ["-m"] and cmd[2].startswith("ctpn_tpu_torch."):
        cmd = [cmd[0], "-c", os.environ["CHIP_SMOKE_COUNTED_MAIN"], *cmd[2:]]
    return _run(cmd, *args, **kwargs)
subprocess.run = _counted_run
if sys.argv[1].endswith(".py"):  # a script of the repo, by path
    spec = importlib.util.spec_from_file_location("__counted__", sys.argv[1])
    target = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(target)
else:
    target = importlib.import_module(sys.argv[1])
target.main(sys.argv[2:])
print("LAUNCHES " + json.dumps({name: fn.LAUNCHES for name, fn in _kernel.wrappers().items()}),
      flush=True)
"""


def run_counted(module: str, args: list, timeout: int = 600) -> tuple:
    """``module``'s ``main(args)`` in a new process (the entry point a
    console script calls; ``module`` may also be the path of a script with
    a ``main(argv)``); returns (stdout, the kernels' launch counts in
    that process). A child process that runs a module of the package with
    ``subprocess.run([python, "-m", ...])`` prints its own counts on a
    ``LAUNCHES`` line before the parent's (``launch_lines``)."""
    proc = subprocess.run([sys.executable, "-c", COUNTED_MAIN, module, *args],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ, PYTHONPATH=str(REPO),
                                                    CHIP_SMOKE_COUNTED_MAIN=COUNTED_MAIN))
    if proc.returncode != 0:
        raise AssertionError(f"{module} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout, launch_lines(proc.stdout)[-1]


def launch_lines(out: str) -> list:
    """The counts of every ``LAUNCHES`` line in ``out``, in order."""
    return [json.loads(ln[len("LAUNCHES "):]) for ln in out.splitlines()
            if ln.startswith("LAUNCHES ")]


def iter_lines(out: str) -> list:
    """The solver's ``iter: N / M, ...`` lines as (N, total loss)."""
    rows = []
    for ln in out.splitlines():
        if ln.startswith("iter: "):
            rows.append((int(ln.split()[1]), float(ln.split("total loss: ")[1].split(",")[0])))
    return rows


def compare_resumed(root: Path, first_dir: Path, resumed_dir: Path, n_iters: int) -> dict:
    """A run resumed from the snapshot at ``n_iters // 2`` against the run
    that went on: the metrics the two logged for each step after the
    snapshot (``metrics.jsonl`` of each run's log directory: losses,
    gradient and update norms, learning rate) and the state each saved at
    ``n_iters`` (parameters, Adam's moments and count, the draw
    generator), equal bit for bit."""
    from ctpn_tpu_torch.training.checkpoint import STATE_FILE
    from ctpn_tpu_torch.training.train_step import METRICS

    rows = [json.loads(ln) for f in sorted(root.glob("logs/**/metrics.jsonl"))
            for ln in f.read_text().splitlines()]
    half = n_iters // 2
    first, again = rows[:n_iters], rows[n_iters:]
    if [r["step"] for r in first] != list(range(1, n_iters + 1)) or \
            [r["step"] for r in again] != list(range(half + 1, n_iters + 1)):
        raise AssertionError(f"logged steps {[r['step'] for r in rows]}")
    keys = METRICS + ("learning_rate",)
    for a, b in zip(first[half:], again):
        if any(a[k] != b[k] for k in keys):
            raise AssertionError(f"step {a['step']}: the resumed run logged "
                                 f"{ {k: b[k] for k in keys} }, the uninterrupted run "
                                 f"{ {k: a[k] for k in keys} }")
    want = torch.load(first_dir / STATE_FILE, map_location="cpu", weights_only=True)
    got = torch.load(resumed_dir / STATE_FILE, map_location="cpu", weights_only=True)
    moments = [k for k, v in want["opt_state"].items() if isinstance(v, list)]
    diffs = {"params": max(float((want["params"][k] - got["params"][k]).abs().max())
                           for k in want["params"]),
             **{k: max(float((a - b).abs().max())
                       for a, b in zip(want["opt_state"][k], got["opt_state"][k]))
                for k in moments}}
    same = (want["step"] == got["step"]
            and all(torch.equal(want["params"][k], got["params"][k]) for k in want["params"])
            and all(torch.equal(a, b) for k in moments
                    for a, b in zip(want["opt_state"][k], got["opt_state"][k]))
            and want["opt_state"].get("count") == got["opt_state"].get("count")
            and torch.equal(want["gen"], got["gen"]))
    if not same:
        raise AssertionError(f"the resumed run's state at step {n_iters} is not the "
                             f"uninterrupted run's: largest differences {diffs}")
    return {"steps_compared": [r["step"] for r in again],
            "total_loss": [r["total_loss"] for r in again], "max_abs_diff": diffs}


def drive_training_entry_points(dev, n_iters: int = 10) -> dict:
    """Data to a trained, exported checkpoint through the entry points, in
    a temporary ``ROOT_DIR`` (devkit, roidb cache and output stay out of
    the repo): the port's ``synth.generate_dataset``; ``ctpn-torch-prepare
    --link`` (one image); an overfit run of ``SolverWrapper`` on it (Adam,
    lr 1e-4 by ``--set``, 30 steps: the mean model loss of the last 5 steps
    below that of the first 5); ``ctpn-torch-train`` for ``n_iters`` steps
    with a snapshot half way, then, with the last checkpoint set aside,
    ``--restore`` to ``n_iters``, whose first logged iteration is
    ``n_iters // 2 + 1`` and which must log the uninterrupted run's metrics
    for those steps and save its state bit for bit (:func:`compare_resumed`;
    the image unflipped, so both runs see the same batches);
    ``ctpn-torch-export --ckpt``;
    ``ctpn-torch-demo`` on the export over the five photos (finite records,
    exactly 2 fused-NMS launches per photo plus 2 for its warm-up batch, no
    other kernel). The training runs launch no kernel."""
    from ctpn_tpu_torch.config import cfg, cfg_from_list, reset_cfg
    from ctpn_tpu_torch.data.roidb import get_training_roidb
    from ctpn_tpu_torch.data.synth import generate_dataset
    from ctpn_tpu_torch.data.voc import PascalVOC
    from ctpn_tpu_torch.eval import read_res_txt
    from ctpn_tpu_torch.training.solver import SolverWrapper

    root = TRAIN_OUT
    shutil.rmtree(root, ignore_errors=True)
    (root / "data").mkdir(parents=True)
    report = {}
    t0 = time.perf_counter()
    images, labels = generate_dataset(str(root / "raw"), n_images=1, seed=3)
    devkit = root / "data" / "VOCdevkit2007"
    run_cli(["ctpn_tpu_torch.cli.prepare_data", "--images", images, "--labels", labels,
             "--out", str(root / "TEXTVOC"), "--link", str(devkit)])
    report["synth_and_prepare_s"] = time.perf_counter() - t0

    reset_cfg()
    cfg_from_list(["ROOT_DIR", str(root), "TRAIN.SOLVER", "Adam",
                   "TRAIN.LEARNING_RATE", "0.0001", "TRAIN.USE_FLIPPED", "False",
                   "TRAIN.DISPLAY", "1", "TRAIN.SNAPSHOT_ITERS", "1000"])
    roidb = get_training_roidb(PascalVOC("trainval", "2007", devkit_path=str(devkit)))
    zero_launch_counts()
    t0 = time.perf_counter()
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):  # 30 log lines
        SolverWrapper(roidb[:1], str(root / "overfit"), device=dev,
                      data_parallel=False).train_model(30)
    report["overfit_30_steps_s"] = time.perf_counter() - t0
    expect_launches(launch_counts(), {}, "SolverWrapper overfit")
    losses = [json.loads(ln)["model_loss"]
              for ln in (root / "overfit" / "metrics.jsonl").read_text().splitlines()]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    report.update(overfit_first5=first, overfit_last5=last)
    if len(losses) != 30 or not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"overfit on one image: model loss {losses}")
    log(f"  overfit on one image: model loss, mean of steps 1-5 {first:.4f}, "
        f"of 26-30 {last:.4f}")
    reset_cfg()

    train = ["ctpn_tpu_torch.cli.train_net", "--cfg", str(REPO / "configs" / "text.yml"),
             "--set", "ROOT_DIR", str(root), "TRAIN.SNAPSHOT_ITERS", str(n_iters // 2),
             "TRAIN.DISPLAY", "1", "TRAIN.USE_FLIPPED", "False"]
    t0 = time.perf_counter()
    out, counts = run_counted(train[0], ["--max-iters", str(n_iters)] + train[1:])
    report["train_s"] = time.perf_counter() - t0
    expect_launches(counts, {}, "ctpn-torch-train")
    first_run = iter_lines(out)
    if [i for i, _ in first_run] != list(range(1, n_iters + 1)) or \
            not np.isfinite([l for _, l in first_run]).all():
        raise AssertionError(f"ctpn-torch-train logged {first_run}")
    solver_dir = root / "output" / "ctpn_end2end" / "voc_2007_trainval"
    ckpts = solver_dir / "checkpoints"
    steps = sorted(int(p.name) for p in ckpts.iterdir())
    if steps != [n_iters // 2, n_iters]:
        raise AssertionError(f"checkpoints at {steps}")
    # the uninterrupted run's last step, set aside: --restore resumes from
    # the snapshot half way and retakes the steps after it
    uninterrupted = root / f"uninterrupted_{n_iters}"
    shutil.move(str(ckpts / str(n_iters)), str(uninterrupted))
    t0 = time.perf_counter()
    out, counts = run_counted(train[0], ["--max-iters", str(n_iters), "--restore"]
                              + train[1:])
    report["train_restore_s"] = time.perf_counter() - t0
    expect_launches(counts, {}, "ctpn-torch-train --restore")
    resumed = iter_lines(out)
    if not resumed or resumed[0][0] != n_iters // 2 + 1 or resumed[-1][0] != n_iters:
        raise AssertionError(f"ctpn-torch-train --restore logged {resumed}")
    report["resume"] = compare_resumed(root, uninterrupted, ckpts / str(n_iters), n_iters)
    log(f"  ctpn-torch-train: iterations 1-{n_iters} in {report['train_s']:.1f} s, "
        f"checkpoints {steps}; --restore resumed at {resumed[0][0]} and ran to "
        f"{resumed[-1][0]}: logged metrics and final state bit for bit those of the "
        f"uninterrupted run ({json.dumps(report['resume'])})")

    npz = root / "trained.npz"
    run_cli(["ctpn_tpu_torch.cli.export_model", "--ckpt", str(solver_dir),
             "--out", str(npz)])
    t0 = time.perf_counter()
    out, counts = run_counted("ctpn_tpu_torch.cli.demo", [
        "--artifact", str(npz), "--images", str(COMMITTED / "H"),
        "--output", str(root / "demo")])
    report["demo_s"] = time.perf_counter() - t0
    # a program run per photo, and one for the demo's warm-up batch
    expect_launches(counts, route_launches("default", len(PHOTOS) + 1),
                    "ctpn-torch-demo on the export")
    lines = 0
    for photo in PHOTOS:
        boxes = read_res_txt(str(root / "demo" / f"res_{photo.stem}.txt"))
        if not np.isfinite(boxes).all():
            raise AssertionError(f"ctpn-torch-demo {photo.name}: non-finite records")
        lines += len(boxes)
    report.update(demo_lines=lines, demo_launches=counts)
    log(f"  ctpn-torch-export --ckpt -> ctpn-torch-demo: {lines} lines on "
        f"{len(PHOTOS)} photos, launches {counts}")
    return report


# ------------------------------------------- training quality, host ops

SYNTH_ROOT = REPO / "output" / "chip_smoke_synth"  # git-ignored; removed at the end
SYNTH_IMAGES, SYNTH_HOLDOUT = 48, 16
SYNTH_ITERS, SYNTH_SEGMENT, SYNTH_BATCH = 120, 60, 8
# the JAX continuation run's model loss (docs/runs/synth_ft5d_1500_edgeclip_
# metrics.jsonl) tops out at 0.304
SYNTH_MAX_MEAN_LOSS = 0.30
SYNTH_F_DROP = 0.05


def random_boxes(rng, n, im_h=600, im_w=900, max_wh=150) -> np.ndarray:
    """(n, 4) well-formed float32 boxes inside an image (a copy of the
    tests' generator, ``tests/conftest.py::random_boxes``)."""
    x1 = rng.uniform(0, im_w - 2, n)
    y1 = rng.uniform(0, im_h - 2, n)
    w = rng.uniform(1, max_wh, n)
    h = rng.uniform(1, max_wh, n)
    x2 = np.minimum(x1 + w, im_w - 1)
    y2 = np.minimum(y1 + h, im_h - 1)
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)


def strip_scene(rng, n_lines=4, im_h=600, im_w=900, slope=0.0, gap_px=16) -> tuple:
    """Rows of 16-px text-proposal strips, shuffled (a copy of
    ``tests/test_connector.py::make_strip_scene``)."""
    boxes, scores = [], []
    for _ in range(n_lines):
        y = rng.uniform(40, im_h - 80)
        h = rng.uniform(20, 40)
        x_start = rng.uniform(0, 150)
        n_strips = rng.randint(3, 20)
        for s in range(n_strips):
            x1 = x_start + s * gap_px
            if x1 + 15 >= im_w:
                break
            yy = y + slope * (x1 - x_start) + rng.uniform(-1.5, 1.5)
            hh = h * rng.uniform(0.95, 1.05)
            boxes.append([x1, yy, x1 + 15, yy + hh])
            scores.append(rng.uniform(0.75, 1.0))
    boxes = np.array(boxes, np.float32)
    scores = np.array(scores, np.float32)
    perm = rng.permutation(len(boxes))
    return boxes[perm], scores[perm]


def check_native_host_ops() -> dict:
    """``native.py``'s library built by the host compiler on this machine,
    against the port's numpy oracles on the cases (and seeds) of
    ``tests/test_torch_native.py``: NMS keep lists and graph successors
    identical, overlaps and intersections within 1e-6."""
    from ctpn_tpu_torch import native
    from ctpn_tpu_torch.config import reset_cfg
    from ctpn_tpu_torch.postprocess.oracle import build_graph_np
    from ctpn_tpu_torch.utils.host_ref import (
        bbox_intersections_np,
        bbox_overlaps_np,
        py_nms,
    )

    reset_cfg()
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("native: no host C++ compiler found")
    report = {"build_s": time.perf_counter() - t0}
    for t in (0.3, 0.7):
        rng = np.random.RandomState(3)
        dets = np.hstack([random_boxes(rng, 200, max_wh=80),
                          rng.uniform(0, 1, 200).astype(np.float32)[:, None]])
        keep = native.nms(dets, t)
        if keep != py_nms(dets, t):
            raise AssertionError(f"native.nms at {t}: {keep} != py_nms")
        report[f"nms_{t}_kept"] = len(keep)
    rng = np.random.RandomState(3)
    b, q = random_boxes(rng, 50), random_boxes(rng, 31)
    err = max(float(np.abs(native.bbox_overlaps(b, q) - bbox_overlaps_np(b, q)).max()),
              float(np.abs(native.bbox_intersections(b, q)
                           - bbox_intersections_np(b, q)).max()))
    if not err <= 1e-6:
        raise AssertionError(f"native overlaps/intersections: max abs err {err}")
    report["overlaps_max_abs_err"] = err
    edges = 0
    for seed in (0, 1, 2):
        boxes, scores = strip_scene(np.random.RandomState(seed))
        want = build_graph_np(boxes.astype(np.float64), scores, (600, 900))
        succ = native.build_graph_successors(boxes, scores, 900)
        got = np.zeros_like(want)
        got[np.flatnonzero(succ >= 0), succ[succ >= 0]] = True
        if not np.array_equal(got, want):
            raise AssertionError(f"native graph successors, seed {seed}")
        edges += int(want.sum())
    report["graph_edges"] = edges
    return report


def holdout_batches(root: Path) -> int:
    """The batches of 4 that ``stream_detect`` forms over the holdout: one
    bucket per image shape, each bucket's images in batches of 4."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image, resize_im

    reset_cfg()
    stems = sorted(p.stem for p in (root / "raw" / "image").glob("*.jpg"))
    per_bucket: dict = {}
    for stem in stems[-SYNTH_HOLDOUT:]:
        im = load_image_bgr(str(root / "raw" / "image" / f"{stem}.jpg"))
        data = prep_image(resize_im(im, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)[0])[0]
        per_bucket[data.shape[:2]] = per_bucket.get(data.shape[:2], 0) + 1
    return sum(-(-n // 4) for n in per_bucket.values())


def holdout_report(out: str) -> dict:
    """``eval_holdout``'s JSON report (indented, between a ``{`` line and
    the next ``}`` line) from its output."""
    lines = out.splitlines()
    i = lines.index("{")
    return json.loads("\n".join(lines[i:lines.index("}", i) + 1]))


def drive_train_synth() -> dict:
    """The synthetic fine-tune through the entry points, from the shipped
    artifact, in a git-ignored root: ``train_synth.prepare_corpus`` (timed:
    the data preparation), ``eval_holdout`` (F before), ``train_synth`` at
    batch 8 in two segments of 60 iterations with the export and the score,
    ``eval_holdout`` on the export (F after). Gates: every logged loss
    finite, the second segment's first logged iteration 61, the mean logged
    model loss <= 0.30, geometric F @ 0.5 after >= before - 0.05, 2
    fused-NMS launches per holdout batch and no other kernel in each
    detection, and none in training."""
    from ctpn_tpu_torch.cli.train_synth import prepare_corpus

    root = SYNTH_ROOT
    shutil.rmtree(root, ignore_errors=True)
    common = ["--root", str(root), "--images", str(SYNTH_IMAGES),
              "--holdout", str(SYNTH_HOLDOUT)]
    report = {}
    t0 = time.perf_counter()
    prepare_corpus(str(root), SYNTH_IMAGES, SYNTH_HOLDOUT)
    report["prepare_s"] = time.perf_counter() - t0
    batches = holdout_batches(root)
    detect = route_launches("default", batches)

    t0 = time.perf_counter()
    out, counts = run_counted("ctpn_tpu_torch.cli.eval_holdout",
                              ["--artifact", str(ARTIFACT)] + common)
    report["eval_before_s"] = time.perf_counter() - t0
    expect_launches(counts, detect, "eval_holdout, shipped artifact")
    before = holdout_report(out)

    t0 = time.perf_counter()
    out, _ = run_counted("ctpn_tpu_torch.cli.train_synth", common + [
        "--iters", str(SYNTH_ITERS), "--batch", str(SYNTH_BATCH), "--lr", "2e-5",
        "--stepsize", "80", "--segment-iters", str(SYNTH_SEGMENT),
        "--init-artifact", str(ARTIFACT)], timeout=900)
    report["train_synth_s"] = time.perf_counter() - t0
    per_process = launch_lines(out)
    if len(per_process) != 3:
        raise AssertionError(f"train_synth: {len(per_process)} LAUNCHES lines, expected "
                             "the two segments' and its own")
    expect_launches(per_process[0], {}, "train_synth segment 1 (training only)")
    expect_launches(per_process[1], detect, "train_synth segment 2 (training, then "
                    "the holdout detection)")
    expect_launches(per_process[2], {}, "train_synth (the segments' parent)")
    seg2 = out.split(f"== segment -> iter {SYNTH_ITERS} ==")[1]
    resumed = iter_lines(seg2)
    if not resumed or resumed[0][0] != SYNTH_SEGMENT + 1:
        raise AssertionError(f"train_synth segment 2 logged {resumed}")
    rows = [json.loads(ln) for ln in
            (root / "output" / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows]
    # the solver logs each segment's first step and every 20th (DISPLAY)
    want = [n for a, b in ((0, SYNTH_SEGMENT), (SYNTH_SEGMENT, SYNTH_ITERS))
            for n in range(a + 1, b + 1) if n == a + 1 or n % 20 == 0]
    if steps != want:
        raise AssertionError(f"train_synth logged steps {steps}, expected {want}")
    losses = {k: [r[k] for r in rows] for k in
              ("total_loss", "model_loss", "rpn_cls_loss", "rpn_box_loss")}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"train_synth: non-finite losses {losses}")
    mean_loss = float(np.mean(losses["model_loss"]))
    if not mean_loss <= SYNTH_MAX_MEAN_LOSS:
        raise AssertionError(f"train_synth: mean model loss {mean_loss} > "
                             f"{SYNTH_MAX_MEAN_LOSS} ({losses['model_loss']})")
    # sec_per_iter is the mean since the segment began: the steady steps
    # are those after segment 2's second logged step (81-120)
    seg2_rows = [(r["step"] - SYNTH_SEGMENT, r["sec_per_iter"]) for r in rows
                 if r["step"] > SYNTH_SEGMENT]
    (n0, t0_mean), (n1, t1_mean) = seg2_rows[1 if len(seg2_rows) > 2 else 0], seg2_rows[-1]
    if n1 == n0:  # one logged step: the mean from the segment's start
        n0, t0_mean = 0, 0.0
    step_ms = 1e3 * (n1 * t1_mean - n0 * t0_mean) / (n1 - n0)
    step_range = f"{SYNTH_SEGMENT + n0 + 1}-{SYNTH_SEGMENT + n1}"
    ckpt = root / "output" / "checkpoints" / str(SYNTH_ITERS) / "state.pt"
    report.update(model_loss=losses["model_loss"], mean_model_loss=mean_loss,
                  ms_per_step=step_ms, steady_steps=step_range,
                  checkpoint_mib=ckpt.stat().st_size / 2**20)

    t0 = time.perf_counter()
    out, counts = run_counted("ctpn_tpu_torch.cli.eval_holdout",
                              ["--artifact", str(root / "artifact.npz")] + common)
    report["eval_after_s"] = time.perf_counter() - t0
    expect_launches(counts, detect, "eval_holdout, fine-tuned export")
    after = holdout_report(out)
    f_before = before["geometric@0.5"]["f_measure"]
    f_after = after["geometric@0.5"]["f_measure"]
    report.update(holdout_batches=batches, before=before, after=after)
    log(f"  data preparation ({SYNTH_IMAGES + SYNTH_HOLDOUT} images): "
        f"{report['prepare_s']:.2f} s; {SYNTH_ITERS} iterations at batch {SYNTH_BATCH} in two "
        f"segments, resumed at {resumed[0][0]}: {step_ms:.2f} ms per step (steps "
        f"{step_range}), mean model loss {mean_loss:.4f}; checkpoint "
        f"{report['checkpoint_mib']:.2f} MiB")
    log(f"  holdout ({SYNTH_HOLDOUT} images, {batches} batches): geometric F @ 0.5 "
        f"{f_before:.4f} before, {f_after:.4f} after; launches per detection "
        f"{detect}")
    if not f_after >= f_before - SYNTH_F_DROP:
        raise AssertionError(f"holdout geometric F @ 0.5 fell from {f_before} to {f_after}")
    return report


# ------------------------------------------------------ captured programs


def device_busy_share(fn) -> float:
    """Summed device time of the kernels ``fn()`` runs (``torch.profiler``)
    over the wall time of the window, which ends when the card is done.
    The detect program runs on one stream at a time, so no kernel time
    counts twice."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e6 / window


def drive_captured(dev) -> dict:
    """The detect program captured once per shape and replayed
    (``inference/graphs.py``) on the default route, the served route, O mode
    and the frozen default route, on the photo batch of 8. For each: the
    eager program issued with host syncs made an error; the first
    ``run_batch`` (warm-up run and capture); three replayed batches issued
    with host syncs made an error (the fetch outside), with exact launches
    per batch; replayed records against the eager program's (counts exact,
    records within 0.5 px, the largest float difference printed); eager and
    replayed wall ms per batch with the fetch, the device busy share of
    one batch of each, capture seconds and the graph pool's MiB."""
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
    from ctpn_tpu_torch.inference.frozen import FrozenCTPN, FrozenPredictor, export_frozen
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    data, infos = photo_batch()
    x, info = torch.from_numpy(data).to(dev), torch.from_numpy(infos).to(dev)
    params = load_params(str(ARTIFACT), device=dev)
    replays = 3
    default, served = ROUTE_LAUNCHES["default"], ROUTE_LAUNCHES["served"]
    cases = (("default", [], "H", False, default),
             ("served", SERVED_ROUTE, "H", False, served),
             ("O mode", [], "O", False, default),
             ("frozen default", [], "H", True, default))
    report = {}
    OUT.mkdir(parents=True, exist_ok=True)
    for name, sets, mode, frozen, want in cases:
        reset_cfg()
        cfg_from_list(sets)
        if frozen:
            path = OUT / "captured_frozen.npz"
            export_frozen(params, str(path), shapes=[tuple(data.shape[:3])], device=dev)
            art = FrozenCTPN(str(path), device=dev)
            pred, eager = FrozenPredictor(art), art.program_on(dev)
        else:
            pred = CTPNPredictor(params, mode=mode, device=dev)
            eager = pred.program
        eager(x, info)  # cuDNN's choice, the device constants
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            want_out = eager(x, info)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want_flat = flat_outputs(want_out)

        t0 = time.perf_counter()
        first = flat_outputs(pred.run_batch(data, infos))  # warm-up run, capture
        first_s = time.perf_counter() - t0
        graphs = art.runner if frozen else pred.graphs
        (entry,) = graphs.graphs.values()

        torch.cuda.synchronize()
        zero_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [pred.run_batch(data, infos) for _ in range(replays)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs = [flat_outputs(o) for o in outs]  # the fetch, outside
        expect_launches(launch_counts(), {k: replays * n for k, n in want.items()},
                        f"captured {name}: {replays} replayed batches of 8")
        worst, diff = compare_outputs(first, want_flat, f"captured {name}, first call")
        for out in outs:
            w, d = compare_outputs(out, want_flat, f"captured {name}, replay")
            worst, diff = max(worst, w), max(diff, d)

        def eager_batch():
            _, lines = eager(torch.from_numpy(data).to(dev), torch.from_numpy(infos).to(dev))
            lines.count.cpu()

        def replayed_batch():
            _, lines = pred.run_batch(data, infos)
            lines.count.cpu()

        eager_s = time_batches(eager_batch)
        replay_s = time_batches(replayed_batch)
        row = {
            "batch": "x".join(map(str, data.shape[:3])) + " uint8",
            "eager_ms_per_batch": eager_s * 1e3,
            "replayed_ms_per_batch": replay_s * 1e3,
            "eager_device_busy_share": device_busy_share(eager_batch),
            "replayed_device_busy_share": device_busy_share(replayed_batch),
            "first_call_s": first_s, "capture_s": entry.capture_s,
            "pool_mib": graphs.pool_mib(),
            "launches_per_batch": want, "host_syncs_per_batch": 0,
            "records_worst_pair_px": worst, "max_abs_diff": diff,
            "line_counts": outs[0][5].tolist(), "iters": 10,
        }
        report[name] = row
        log(f"  captured {name} " + json.dumps(row))
        del pred, eager, graphs, entry
    reset_cfg()
    shutil.rmtree(OUT, ignore_errors=True)
    return report


def profiled_names(fn) -> set:
    """Names of the host and device events of ``fn()`` (``torch.profiler``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()}


def check_stage_clock(dev) -> dict:
    """The stage clock (``utils/timer.py``, ``ops/csrc/stage_clock.cu``) on
    the card. The stamp kernel alone: rows around queued sleeps, in order,
    counted on the device. Tracing off: the default-route predictor has no
    clock, and a profiler trace of a replay holds no ``ctpn.*`` event and no
    stamp kernel. Tracing on: the predictor's replays give the plain
    predictor's records bit for bit, each replay writes one row, the trace
    holds the ``ctpn.graphs.*`` spans and four stamp kernels per replay, and
    the stages' device ms per batch are printed beside the replayed wall ms
    per batch."""
    from ctpn_tpu_torch.config import reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils import timer
    from ctpn_tpu_torch.utils.weights import load_params

    clock = timer.StageClock(dev)
    for _ in range(3):
        for name in timer.STAGES:
            torch.cuda._sleep(2_000_000)  # about a millisecond
            clock.stamp(name)
    alone = clock.read()
    if clock.row() != 3 or alone["rows"] != 3 or not all(
            alone[k] > 0.2 for k in ("forward", "proposal_layer", "detect_lines")):
        raise AssertionError(f"stage clock: stamps around sleeps read {alone}")

    reset_cfg()
    data, infos = photo_batch()
    params = load_params(str(ARTIFACT), device=dev)
    was = timer.enabled()
    report = {"stamps_alone_ms": alone}
    try:
        timer.enable(False)
        plain = CTPNPredictor(params, device=dev)
        if plain.clock is not None:
            raise AssertionError("stage clock: a predictor built with tracing off has one")
        want = flat_outputs(plain.run_batch(data, infos))  # warm-up run, capture

        def replay(pred):
            def fn():
                _, lines = pred.run_batch(data, infos)
                lines.count.cpu()
            return fn

        names = profiled_names(replay(plain))
        bad = sorted(n for n in names if n.startswith("ctpn.") or "stage_stamp" in n)
        if bad:
            raise AssertionError(f"stage clock: tracing off, a replay's trace holds {bad}")

        timer.enable(True)
        timer.reset()
        pred = CTPNPredictor(params, device=dev)
        compare_outputs(flat_outputs(pred.run_batch(data, infos)), want,
                        "traced predictor, first call")
        row0 = pred.clock.row()
        outs = [pred.run_batch(data, infos) for _ in range(5)]
        for out in outs:
            got = flat_outputs(out)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("stage clock: a traced replay's outputs differ "
                                     "from the plain predictor's")
        stages = pred.clock.read(row0)
        if stages is None or stages["rows"] != 5:
            raise AssertionError(f"stage clock: 5 replays read {stages}")
        names = profiled_names(replay(pred))
        missing = {"ctpn.graphs.upload", "ctpn.graphs.replay", "ctpn.graphs.clone",
                   "ctpn.graphs.finish"} - names
        if missing or not any("stage_stamp" in n for n in names):
            raise AssertionError(f"stage clock: tracing on, the trace lacks {missing} "
                                 "or the stamp kernel")
        report.update(stages_ms_per_batch=stages,
                      replayed_ms_per_batch=time_batches(replay(pred)) * 1e3,
                      spans=timer.totals())
        log("  stage clock " + json.dumps(report))
    finally:
        timer.enable(was)
        timer.reset()
    return report


# ------------------------------------------------------ captured training

CAPTURED_TRAIN_BATCHES = (1, 2, 8)


def same_step(a: dict, b: dict) -> bool:
    """Two :func:`step_record` results equal bit for bit: metrics, update and
    raw gradients."""
    return (a["metrics"] == b["metrics"] and torch.equal(a["delta"], b["delta"])
            and torch.equal(a["grad"], b["grad"]))


def check_captured_parity(dev) -> dict:
    """Three replayed steps against three eager steps: 2x256x384, f32 with
    TF32 off, Adam at lr 1e-4, from the same parameters and draws. The
    captured side calls ``TrainGraphs`` with the pinned host batch (its
    first call is the eager warm-up step and the capture, the next three
    replay); before each step the eager side (the bucket's ``TrainStep``
    on the batch on the card) is set to the captured side's state, in
    place, so that each pair of steps starts from one state. Each step:
    loss and gradient norm within 1e-4 relative and the update as
    :func:`compare_updates` holds the card to the CPU (phase 11's
    tolerances); and, since the step runs only reproducible kernels
    (``train_step.reproducible``), bit for bit: the eager step taken twice
    from one state, and the eager step against the captured one (metrics,
    update and gradients); a second eager model that took the four steps
    on its own must end with the captured model's parameters exactly
    (drift 0.0)."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.models.factory import init_params
    from ctpn_tpu_torch.ops.anchor_target import num_anchors
    from ctpn_tpu_torch.parallel.multicard import no_tf32
    from ctpn_tpu_torch.training.graphs import TrainGraphs
    from ctpn_tpu_torch.training.train_step import (
        Batch,
        build_train_step,
        create_train_state,
    )
    from ctpn_tpu_torch.utils.weights import params_from_jax

    reset_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.SOLVER, cfg.TRAIN.LEARNING_RATE = "Adam", 1e-4
    h, w = TRAIN_PARITY_BUCKET
    host = Batch.from_numpy(train_arrays(13, 2, (h, w)), pin=True)
    state_dict = params_from_jax(init_params(cfg.RNG_SEED))
    gen = torch.Generator().manual_seed(7)
    draws = [torch.rand((2, 2, num_anchors(h // 16, w // 16)), generator=gen)
             for _ in range(4)]
    try:
        with no_tf32():
            dev_batch = host.to(dev)
            eager_model = fresh_train_model(dev, state_dict)
            eager_state = create_train_state(eager_model)
            eager_step = build_train_step(eager_model, h // 16, w // 16)
            free_model = fresh_train_model(dev, state_dict)  # four eager steps alone
            free_state = create_train_state(free_model)
            free_step = build_train_step(free_model, h // 16, w // 16)
            model = fresh_train_model(dev, state_dict)
            graphs = TrainGraphs(create_train_state(model), dev)
            steps = []
            for i, d in enumerate(draws):
                start = keep(graphs.state)
                before = [p.detach().clone() for p in model.parameters()]
                eager = []
                for _ in range(2):  # the eager step, twice from one state
                    rewind(eager_state, start)
                    eager.append(step_record(eager_model, before,
                                             eager_step(eager_state, dev_batch, d)))
                ref = eager[0]
                got = step_record(model, before, graphs(host, d))
                free_step(free_state, dev_batch, d)
                rel = {k: abs(got["metrics"][k] - ref["metrics"][k]) / abs(ref["metrics"][k])
                       for k in ("total_loss", "model_loss", "grad_norm")}
                what = f"captured step {i + 1} ({'replayed' if i else 'warm-up'}) against eager"
                if max(rel.values()) > 1e-4:
                    raise AssertionError(f"{what}: relative differences {rel}")
                worst, worst_noisy, n_noisy = compare_updates(ref, got, cfg.TRAIN.LEARNING_RATE,
                                                              what)
                if not same_step(eager[0], eager[1]):
                    raise AssertionError(f"step {i + 1}: two eager steps from one state differ "
                                         f"(update by {float((eager[0]['delta'] - eager[1]['delta']).abs().max())})")
                if not same_step(ref, got):
                    raise AssertionError(f"{what}: not bit for bit (update by {worst}, "
                                         f"{worst_noisy} where |g| <= 1e-6)")
                steps.append({"step": i + 1, "replayed": i > 0, "rel_diff": rel,
                              "update_max_abs_diff": worst,
                              "noisy_update_max_abs_diff": worst_noisy,
                              "elements_grad_le_1e-6": n_noisy})
            free_diff = max(float((a.detach() - b.detach()).abs().max())
                            for a, b in zip(free_model.parameters(), model.parameters()))
            if free_diff != 0.0:
                raise AssertionError(f"four free-running eager steps drifted {free_diff} from "
                                     "four captured steps")
            report = {"bucket": f"2x{h}x{w}", "dtype": "float32, TF32 off",
                      "eager_steps": graphs.eager_steps,
                      "replays": len(draws) - graphs.eager_steps, "steps": steps,
                      "rel_diff_worst": max(max(r["rel_diff"].values()) for r in steps),
                      "update_max_abs_diff": max(r["update_max_abs_diff"] for r in steps),
                      "free_running_params_max_abs_diff": free_diff}
    finally:
        reset_cfg()
    log("  captured parity " + json.dumps(report))
    return report


def time_captured_steps(dev, batch_sizes=CAPTURED_TRAIN_BATCHES, iters: int = 10) -> list:
    """Full width, 608x912, bf16, Adam, at each batch size, ``TPU.REMAT``
    off and on, from the same parameters: eager steps (the bucket's
    ``TrainStep`` on the batch on the card, after two warm-ups) against
    replayed steps (``TrainGraphs`` on the pinned host batch, after its
    first call). Per setting: ms per step over ``iters`` (host clock, ended
    by a fetch and a synchronize), :func:`profile_steps` of both (busy
    share, kernels per step), the capture's seconds, the graph pool's MiB,
    the peak of ``max_memory_allocated`` over an eager step and over the
    first call (warm-up and capture); then three replayed steps issued with
    host syncs made an error (the fetch outside)."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.models.factory import init_params
    from ctpn_tpu_torch.training.graphs import TrainGraphs
    from ctpn_tpu_torch.training.train_step import Batch, create_train_state
    from ctpn_tpu_torch.utils.weights import params_from_jax

    reset_cfg()
    cfg.TRAIN.SOLVER = "Adam"
    h, w = TRAIN_BUCKET
    arrays = train_arrays(14, max(batch_sizes), (h, w))
    state_dict = params_from_jax(init_params(cfg.RNG_SEED))
    rows = []
    for n in batch_sizes:
        host = Batch.from_numpy([a[:n] for a in arrays], pin=True)
        dev_batch = host.to(dev)
        for remat in (False, True):
            cfg.TPU.REMAT = remat
            model = fresh_train_model(dev, state_dict)
            state = create_train_state(model)
            graphs = TrainGraphs(state, dev)
            step = graphs.step_fn(h, w)

            def eager():
                return step(state, dev_batch)

            def replayed():
                return graphs(host)

            eager()
            eager()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            eager()
            torch.cuda.synchronize()
            eager_peak = torch.cuda.max_memory_allocated(dev)
            eager_ms = time_steps(eager, iters)
            eager_prof = profile_steps(eager)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            replayed()  # the eager warm-up step, then the capture
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            first_peak = torch.cuda.max_memory_allocated(dev)
            replayed()
            replay_ms = time_steps(replayed, iters)
            replay_prof = profile_steps(replayed)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs = [replayed() for _ in range(3)]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            losses = [float(m["total_loss"]) for m in outs]  # the fetch, outside
            if not np.isfinite(losses).all():
                raise AssertionError(f"batch {n}, REMAT {remat}: replayed losses {losses}")
            (entry,) = graphs.graphs.values()
            rows.append({
                "batch": n, "remat": remat, "bucket": f"{h}x{w}", "dtype": "bfloat16",
                "eager_ms_per_step": eager_ms, "replayed_ms_per_step": replay_ms,
                "eager_img_per_s": n / eager_ms * 1e3,
                "replayed_img_per_s": n / replay_ms * 1e3,
                "eager_device_busy_share": eager_prof["device_busy_share"],
                "replayed_device_busy_share": replay_prof["device_busy_share"],
                "device_ms_per_step": replay_prof["device_ms_per_step"],
                "eager_device_ms_per_step": eager_prof["device_ms_per_step"],
                "kernels_per_step": eager_prof["kernels_per_step"],
                "first_call_s": first_s, "capture_s": entry.capture_s,
                "pool_mib": graphs.pool_mib(), "eager_peak_mib": eager_peak / 2**20,
                "first_call_peak_mib": first_peak / 2**20,
                "host_syncs_per_step": 0, "losses": losses, "iters": iters,
                "top_kernels": replay_prof["top_kernels"][:3]})
            log("  captured step " + json.dumps(rows[-1]))
            del model, state, graphs, step, entry, eager, replayed
            torch.cuda.empty_cache()
    reset_cfg()
    return rows


# ------------------------------------------------------------- multi-card


def drive_multicard() -> dict:
    """``ctpn_tpu_torch.parallel.multicard.run()`` over every visible card
    (its gates raise), then this phase's launch counts: every CTPN kernel
    ran on the DP paths (EAST's run in no DP path)."""
    from ctpn_tpu_torch.parallel import multicard

    report = multicard.run()
    ctpn = set(ROUTE_LAUNCHES["default"]) | set(ROUTE_LAUNCHES["served"])
    counts = {name: n for name, n in launch_counts().items() if name in ctpn}
    idle = [name for name, n in counts.items() if not n]
    if idle:
        raise AssertionError(f"multi-card phase: {idle} never launched ({counts})")
    train = report["training"]
    log("  multicard " + json.dumps({
        "cards": report["cards"], "replicas": report["replicas"],
        "ranks": report["ranks"], "card_line": report["card_line"],
        "descent": {k: train["descent"].get(k) for k in
                    ("losses", "step", "eager_steps", "replayed_steps",
                     "rerun_params_max_abs_diff")},
        "parity": train["parity"], "ddp_steps": train["ddp_steps"],
        "inference": report["inference"], "frozen": report["frozen"],
        "dp_detect": report["dp_detect"], "launches_in_phase": counts,
        "seconds": {k: report[k] for k in ("training_s", "inference_s", "frozen_s",
                                           "readings_s")}}))
    return report


# ------------------------------------------------------------- card against CPU


def record_diffs(a: np.ndarray, b: np.ndarray) -> list:
    """Greedy one-to-one pairing of the rows of ``a`` with the rows of ``b``
    (nearest first, no limit): the max abs difference of each pair."""
    used = np.zeros(len(b), bool)
    diffs = []
    for row in a:
        if used.all():
            break
        d = np.abs(b - row[None]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        used[j] = True
        diffs.append(float(d[j]))
    return diffs


def check_card_against_cpu(dev, bf16_recs: list) -> dict:
    """ROADMAP D1: ``detect_image`` on the five photos in float32 with TF32
    off, once on the card and once on the CPU (the kernels' plain versions,
    the program the CPU tests hold against the JAX package): records paired
    one-to-one within 0.5 px. Then the card's bf16 records of phase 4
    against the f32 CPU records, reported, not gated."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.parallel.multicard import no_tf32
    from ctpn_tpu_torch.utils.image import load_image_bgr
    from ctpn_tpu_torch.utils.weights import load_params

    images = [load_image_bgr(str(p)) for p in PHOTOS]
    reset_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    try:
        with no_tf32():
            card = CTPNPredictor(load_params(str(ARTIFACT), device=dev), device=dev)
            card_recs = [card.detect_image(im) for im in images]
            del card
            host = CTPNPredictor(load_params(str(ARTIFACT), device="cpu"), device="cpu")
            t0 = time.perf_counter()
            host_recs = [host.detect_image(im) for im in images]
            host_s = time.perf_counter() - t0
    finally:
        reset_cfg()
    worst, bf16_worst = 0.0, []
    for photo, a, b, c in zip(PHOTOS, card_recs, host_recs, bf16_recs):
        w = rows_match(a, b, 0.5)  # counts equal, every record paired
        worst = max(worst, w)
        diffs = record_diffs(c, b)
        bf16_worst.append(max(diffs, default=0.0))
        log(f"  {photo.name}: f32 card {len(a)} records, CPU {len(b)}, worst pair "
            f"{w} px; bf16 card {len(c)} records, {len(diffs)} paired with the f32 "
            f"CPU records, largest difference {bf16_worst[-1]} px, "
            f"{sum(d <= 0.5 for d in diffs)} within 0.5 px")
    report = {"f32_card_vs_cpu_worst_px": worst,
              "f32_records": sum(len(r) for r in card_recs),
              "bf16_card_vs_f32_cpu_largest_px": max(bf16_worst),
              "bf16_records": sum(len(r) for r in bf16_recs),
              "cpu_s_per_photo": host_s / len(PHOTOS)}
    log("  card against CPU " + json.dumps(report))
    return report


# ------------------------------------------------------------- load


ROUTE_SETS = {"default": [], "served": SERVED_ROUTE}
LOAD_SERVING = ["--clients", "32", "--sustained", "48"]
LOAD_SUSTAINED = ["--seconds", "8"]
LOAD_STREAMING = ["--images", "64", "--latency", "--artifact", str(ARTIFACT)]
LOAD_BUCKETS = ((608, 912), (912, 608))  # what the scripts and servers warm
COLD_SHAPE, COLD_BUCKET = (600, 600), (608, 608)  # a bucket no phase warms


def load_script(name: str):
    """``scripts/<name>`` as a module: its helpers, without running main."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{Path(name).stem}", REPO / "scripts" / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_load_script(name: str, args: list, route: str, card: str) -> dict:
    """``scripts/<name>`` through ``run_counted`` on ``route``: its JSON lines
    by metric. Gates every line: no error, nothing shed, every request
    answered, the route and card it names, and the kernels' launches in the
    child exactly the route's per program run."""
    sets = ["--set", *ROUTE_SETS[route]] if ROUTE_SETS[route] else []
    t0 = time.perf_counter()
    out, counts = run_counted(str(REPO / "scripts" / name), args + sets, timeout=600)
    lines = {}
    for ln in out.splitlines():
        if ln.startswith("{"):
            line = json.loads(ln)
            lines[line["metric"]] = line
    if not lines:
        raise AssertionError(f"{name} printed no JSON line:\n{out}")
    for metric, line in lines.items():
        if line["route"] != route or line["card"] != card:
            raise AssertionError(f"{name} {metric}: ran on {line['route']}, {line['card']}")
        if line.get("errors", 0) or line.get("shed", 0) or line.get("ok") != line.get("sent"):
            raise AssertionError(f"{name} {metric}: {line}")
    runs = max(line["program_runs"] for line in lines.values())
    check_route_launches(counts, runs, f"{name}, {route} route", route)
    log(f"  {name} ({route} route, {time.perf_counter() - t0:.1f} s): launches "
        f"{counts} over {runs} program runs")
    return lines


def drive_load_scripts(card: str) -> dict:
    """The three load scripts in child processes, the HTTP one on both
    routes; returns their JSON lines."""
    out = {}
    for route in ("default", "served"):
        line = run_load_script("torch_bench_serving.py", LOAD_SERVING, route,
                               card)["serving_http_p50_ms"]
        burst = line["burst"]
        if burst["batches"] >= burst["ok"]:
            raise AssertionError(f"HTTP burst, {route} route: {burst['batches']} batches "
                                 f"for {burst['ok']} requests: no coalescing")
        if line["program_runs"] != line["warm_runs"] + line["batches_run"]:
            raise AssertionError(f"HTTP, {route} route: {line['program_runs']} program "
                                 f"runs, {line['warm_runs']} warm-ups and "
                                 f"{line['batches_run']} batches")
        out[f"serving_{route}"] = line
        for phase in ("burst", "sustained"):
            log(f"  HTTP {phase}, {route} route: " + json.dumps(line[phase]))
    out.update(run_load_script("torch_bench_serving_sustained.py", LOAD_SUSTAINED,
                               "default", card))
    out.update(run_load_script("torch_bench_streaming.py", LOAD_STREAMING, "default", card))
    if "ctpn_single_image_latency_p50" not in out:
        raise AssertionError("the streaming script printed no latency line")
    return out


def handler_prep(body: bytes) -> tuple:
    """The server handler's work on a request body: decode, resize, pad.
    Returns (padded image, im_info, resize factor, top pad)."""
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.serving import _decode_image
    from ctpn_tpu_torch.utils.image import prep_image, resize_im

    resized, f1 = resize_im(_decode_image(body), cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
    data, info, pad = prep_image(resized)
    return data, info, f1, pad


def raw_records(pred, items: list, max_batch: int) -> list:
    """``run_padded`` of prepped ``items`` (``handler_prep`` tuples) at
    ``max_batch``: each item's records as the program returns them."""
    _, lines = pred.run_padded([it[0] for it in items], [it[1] for it in items], max_batch)
    counts, recs = lines.count.cpu().numpy(), lines.recs.cpu().numpy()
    return [recs[b, :int(counts[b])] for b in range(len(items))]


def direct_records(pred, body: bytes, max_batch: int) -> np.ndarray:
    """What the server answers for ``body``, computed alone: the handler's
    decode, resize and padding, the image alone through ``run_padded`` at
    ``max_batch`` (padded with copies of itself), the completer's
    ``unscale_records`` and the handler's rounding."""
    from ctpn_tpu_torch.inference.records import unscale_records

    item = handler_prep(body)
    (recs,) = raw_records(pred, [item], max_batch)
    _, info, f1, pad = item
    recs = unscale_records(recs, len(recs), f1, info, y_off=pad)
    return np.asarray([[round(v, 2) for v in rec] for rec in recs], np.float64).reshape(-1, 9)


def batch_dependence(pred, bodies: list, noise: dict, max_batch: int) -> dict:
    """Per bucket, the program's raw records of each body run alone (padded
    with copies of itself, read from slot 0), alone again, and in one batch
    behind ``noise[bucket]`` bodies (so in the last slots, beside other
    images): the largest difference between two alone runs (run to run) and
    between alone and batched. Fails unless both are 0.0 with equal counts:
    an image's records may not depend on its slot or its neighbours (the
    stride-16 convs run per image, ``models/vgg.py``)."""
    items = {}
    for body in bodies:
        item = handler_prep(body)
        items.setdefault(item[0].shape[:2], []).append(item)
    out = {}
    for bucket, group in items.items():
        fill = [handler_prep(b) for b in noise[bucket][:max_batch - len(group)]]
        alone = [raw_records(pred, [it], max_batch)[0] for it in group]
        again = [raw_records(pred, [it], max_batch)[0] for it in group]
        mixed = raw_records(pred, fill + group, max_batch)[len(fill):]
        row = {"images": len(group), "slots": [len(fill), max_batch - 1]}
        for name, other in (("run_to_run", again), ("alone_vs_batched", mixed)):
            diffs = [float(np.abs(a - b).max(initial=0.0)) if a.shape == b.shape
                     else f"counts {len(a)} and {len(b)}" for a, b in zip(alone, other)]
            row[name] = diffs
        out["x".join(map(str, bucket))] = row
    if any(d != 0.0 for row in out.values() for name in ("run_to_run", "alone_vs_batched")
           for d in row[name]):
        raise AssertionError(f"records depend on the batch slot or run: {out}")
    return out


def drive_load_in_process(dev, route: str, card: str) -> dict:
    """An in-process server on ``route`` under load, its answers held
    against direct runs:

    * the five photos and three repeats in one burst with 16 noise requests
      (a quarter portrait): each photo's answer equals its direct run
      (counts exact, records paired within 0.5 px, the largest difference
      printed), >= 75 % of the committed lines; then each bucket's photos
      run alone and behind noise, in the last slots of a batch: raw records
      equal bit for bit (``batch_dependence``);
    * 16 clients sending 48 fresh requests (a third portrait) and, while
      they run, one 600x600 scene in the 608x608 bucket, which no phase
      warmed: its program is run and captured while other batches are in
      flight; it is answered 200 with its direct run's records, and no
      other request fails.

    Launch counts over the phase: exactly the route's per program run."""
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
    from ctpn_tpu_torch.data.synth import render_image
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.serving import DetectionServer
    from ctpn_tpu_torch.utils.weights import load_params

    from PIL import Image

    bench = load_script("torch_bench_serving.py")
    reset_cfg()
    cfg_from_list(ROUTE_SETS[route])
    max_batch = 8
    pred = CTPNPredictor(load_params(str(ARTIFACT), device=dev), device=dev)
    for bucket in LOAD_BUCKETS:
        pred.warmup(bucket, batch=max_batch)

    def cold_keys():
        return [k for k in pred.graphs.graphs if tuple(k[2:4]) == COLD_BUCKET]

    if cold_keys():
        raise AssertionError(f"the {COLD_BUCKET} bucket was warm before the cold request")
    rng = np.random.RandomState(23)
    photos = [p.read_bytes() for p in PHOTOS]
    burst = [(i, photos[i]) for i in list(range(len(PHOTOS))) + [4, 1, 2]]
    burst += [(None, bench.fresh_jpeg(rng, bench.PORTRAIT if k % 4 == 0 else bench.LANDSCAPE))
              for k in range(16)]
    burst = [burst[k] for k in rng.permutation(len(burst))]
    buf = io.BytesIO()
    Image.fromarray(render_image(rng, width=COLD_SHAPE[1], height=COLD_SHAPE[0])[0]).save(
        buf, format="PNG")
    cold_body = buf.getvalue()

    runs = bench.count_runs(pred)
    srv = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=max_batch, window_ms=5.0)
    serve_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    serve_thread.start()
    host, port = srv.server_address
    url = f"http://{host}:{port}/detect"
    answers = [None] * len(burst)
    load = {}

    def client(slot):
        answers[slot] = bench.post(url, burst[slot][1])

    def sustained():
        load["lat"], load["wall"], load["errors"] = bench.run_phase(
            url, 16, 48, np.random.RandomState(29), mixed=True)

    try:
        zero_launch_counts()  # counts of this phase's program runs only
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(burst))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        burst_wall = time.perf_counter() - t0
        burst_batches = srv.batcher.batches_run
        loader = threading.Thread(target=sustained)
        loader.start()
        deadline = time.monotonic() + 120
        while srv.batcher.batches_run < burst_batches + 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        in_flight_from = srv.batcher.batches_run - burst_batches
        t0 = time.perf_counter()
        cold = bench.post(url, cold_body)
        cold_s = time.perf_counter() - t0
        load_running = loader.is_alive()
        loader.join(timeout=600)
        torch.cuda.synchronize()
        counts, program_runs = launch_counts(), runs[0]
        batches, shed = srv.batcher.batches_run, srv.batcher.shed
    finally:
        srv.shutdown()
        srv.batcher.join(timeout=60)
        serve_thread.join(timeout=60)
        srv.server_close()
    check_route_launches(counts, program_runs, f"in-process load, {route} route", route)
    if load.get("errors") or shed or len(load.get("lat", ())) != 48:
        raise AssertionError(f"sustained load, {route} route: errors {load.get('errors')}, "
                             f"shed {shed}, {len(load.get('lat', ()))} of 48 answered")
    if burst_batches >= len(burst):
        raise AssertionError(f"{burst_batches} batches for a burst of {len(burst)}")
    got = {}
    for slot, (photo, _body) in enumerate(burst):
        if answers[slot] is None:
            raise AssertionError(f"burst request {slot} got no answer")
        recs = bench.check_response(*answers[slot])
        if photo is not None:
            got.setdefault(photo, []).append(recs)
    cold_recs = bench.check_response(*cold)
    (cold_key,) = cold_keys()
    capture_s = pred.graphs.graphs[cold_key].capture_s

    worst = 0.0
    hits = n_ref = 0
    for i, photo in enumerate(PHOTOS):
        want = direct_records(pred, photos[i], max_batch)
        diffs = [rows_match(recs, want, 0.5) for recs in got[i]]
        worst = max([worst] + diffs)
        hit, n = recall_vs_committed(got[i][0], photo)
        hits, n_ref = hits + hit, n_ref + n
        log(f"  {photo.name} under load ({len(got[i])} answers): {len(want)} records, "
            f"paired with its direct run, largest difference {diffs} px; committed "
            f"lines {hit}/{n}")
    if hits < 0.75 * n_ref:
        raise AssertionError(f"only {hits}/{n_ref} committed reference lines found")
    cold_worst = rows_match(cold_recs, direct_records(pred, cold_body, max_batch), 0.5)
    # each bucket's photos batched behind noise, against each alone
    noise = {LOAD_BUCKETS[0]: [bench.fresh_jpeg(rng) for _ in range(max_batch)],
             LOAD_BUCKETS[1]: [bench.fresh_jpeg(rng, bench.PORTRAIT) for _ in range(max_batch)]}
    dependence = batch_dependence(pred, photos, noise, max_batch)
    report = {
        "route": route, "card": card, "burst_requests": len(burst),
        "burst_batches": burst_batches, "burst_wall_s": burst_wall,
        "photo_records_largest_diff": worst, "committed_recall": f"{hits}/{n_ref}",
        "raw_records_largest_diff": dependence,
        "sustained": bench.phase_summary(load["lat"], load["wall"], load["errors"],
                                         batches - burst_batches, 49),
        "cold_bucket": {"bucket": list(COLD_BUCKET), "records": len(cold_recs),
                        "largest_diff": cold_worst, "latency_s": cold_s,
                        "capture_s": capture_s, "batches_before": in_flight_from,
                        "sustained_still_running": load_running},
        "program_runs": program_runs, "launches": counts}
    log("  in-process load " + json.dumps(report))
    reset_cfg()
    return report


def drive_load(dev, card: str) -> dict:
    """Phase 20: the load scripts in child processes, then the in-process
    server under load on both routes; prints the numbers beside the card."""
    report = {"scripts": drive_load_scripts(card),
              "in_process": [drive_load_in_process(dev, r, card)
                             for r in ("default", "served")]}
    s = report["scripts"]
    summary = {"card": card}
    for route in ("default", "served"):
        line = s[f"serving_{route}"]
        summary[f"http_{route}"] = {
            phase: {k: line[phase][k] for k in ("p50_ms", "p95_ms", "p99_ms", "img_per_s",
                                                "img_per_batch")}
            for phase in ("burst", "sustained")}
        summary[f"http_{route}"]["host_ms_per_request"] = line["host_ms_per_request"]
    batcher = s["serving_batcher_sustained_throughput"]
    summary["batcher"] = {k: batcher[k] for k in (
        "value", "jit_rate", "batcher_efficiency", "p50_ms", "p99_ms", "img_per_batch")}
    summary["streaming_img_per_s"] = s["ctpn_streaming_serving_throughput"]["value"]
    latency = s["ctpn_single_image_latency_p50"]
    summary["batch1_latency_ms"] = {"p50": latency["value"], "p90": latency["p90_ms"],
                                    "max": latency["max_ms"]}
    summary["cold_bucket"] = {r["route"]: r["cold_bucket"] for r in report["in_process"]}
    log("  load " + json.dumps(summary))
    return report


# ------------------------------------------------------------- slot independence

def drive_slot_buckets(dev, card: str) -> dict:
    """Phase 23: in every bucket of ``cfg.TPU.BUCKETS``, on the default
    route, the served route and in O mode, at batch 8 and 16, the images
    of ``scripts/torch_slot_dependence.py::bucket_content`` (the photos that
    land in the bucket and two renders sized into it, prepped as the
    server's handler preps them) in the first slots of a batch and in its
    last slots behind noise: each image's raw records equal bit for bit
    (counts and values), and each bucket's images give records. One
    capture per shape: a batch of noise runs and captures the program, and
    both compared batches replay it, as the server does; each shape's graph
    is freed after it."""
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    slot = load_script("torch_slot_dependence.py")
    reset_cfg()
    t0 = time.perf_counter()
    content = slot.bucket_content()
    prep_s = time.perf_counter() - t0
    params = load_params(str(ARTIFACT), device=dev)
    rows = []
    try:
        for route, (sets, mode) in slot.ROUTES.items():
            reset_cfg()
            cfg_from_list(sets)
            pred = CTPNPredictor(params, mode=mode, device=dev)
            for bucket, (images, noise) in content.items():
                for batch in slot.BATCHES:
                    row = slot.slot_runs(pred, images, noise, batch)
                    pred.graphs.graphs.clear()  # one shape's graph at a time
                    torch.cuda.empty_cache()
                    rows.append({"route": route, "bucket": "x".join(map(str, bucket)),
                                 "batch": batch, **row})
                    if any(d != 0.0 for d in row["records"]) or not sum(row["counts"]):
                        raise AssertionError(f"records depend on the batch slot: {rows[-1]}")
            del pred
    finally:
        reset_cfg()
    report = {"card": card, "content_prep_s": prep_s, "keys": len(rows),
              "images": sum(len(r["records"]) for r in rows),
              "records": sum(sum(r["counts"]) for r in rows),
              "largest_record_diff": max(d for r in rows for d in r["records"]),
              "rois_equal": all(d == 0.0 for r in rows for d in r["rois"]),
              "rows": [{k: r[k] for k in ("route", "bucket", "batch", "slots_last",
                                          "counts", "records")} for r in rows]}
    log("  slot independence " + json.dumps(report))
    return report


# ------------------------------------------------------------- orbax artifacts

ORBAX_FIXTURE = REPO / "tests" / "data" / "orbax"  # written by the JAX package
ORBAX_OUT = REPO / "output" / "chip_smoke_orbax"  # git-ignored; removed at the end


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def nested_tree(flat: dict) -> dict:
    """Flat ``a/b/c`` tensors -> the nested JAX-layout tree of numpy arrays."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.cpu().numpy()
    return tree


def zstd_decode_rate(root: Path, reps: int = 5) -> tuple:
    """MB/s of ``zstd.decompress`` over the zarr chunks of the OCDBT
    checkpoint at ``root`` (the decoder alone: the frames are read first)."""
    from ctpn_tpu_torch.utils import orbax_io, zstd

    store = orbax_io.OcdbtStore(str(root))
    frames = []
    for keys, _ in orbax_io.leaf_paths(str(root)):
        name = ".".join(keys)
        z = json.loads(store.get(f"{name}/.zarray"))
        size = int(np.prod(z["chunks"])) * orbax_io.DTYPES[z["dtype"]].itemsize
        frames.append((store.get(f"{name}/{'.'.join('0' * len(z['chunks']))}"), size))
    t0 = time.perf_counter()
    for _ in range(reps):
        for frame, size in frames:
            zstd.decompress(frame, size=size)
    sec = time.perf_counter() - t0
    decoded = reps * sum(size for _, size in frames)
    return decoded / sec / 1e6, sum(len(f) for f, _ in frames), decoded // reps


def drive_orbax(dev, default_recs: list, card: str) -> dict:
    """Phase 22: orbax artifact directories, read and written without JAX.
    The committed JAX-written fixtures against the shipped ``.npz``, the
    full-width export read back on the card, ``CTPNPredictor`` on orbax-read
    weights against phase 4's records (tolerance 0) with its launches, the
    serve CLI on a directory; host times beside the card line."""
    from ctpn_tpu_torch.config import reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.ops import _build
    from ctpn_tpu_torch.ops import nms_fused as NF
    from ctpn_tpu_torch.training import checkpoint
    from ctpn_tpu_torch.utils import zstd
    from ctpn_tpu_torch.utils.image import load_image_bgr
    from ctpn_tpu_torch.utils.weights import load_params, load_pretrained_into

    report = {"card": card}
    ORBAX_OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _build.build(["zstd_decode"])
    report["zstd_build_s"] = time.perf_counter() - t0
    log(f"  zstd_decode built by the host compiler in {report['zstd_build_s']:.2f} s")

    with np.load(ARTIFACT) as npz:
        shipped = {k: npz[k].astype(np.float32) for k in npz.files}
    zstd.MODES.clear()
    fixture = load_params(str(ORBAX_FIXTURE / "artifact"), device="cpu")
    bad = [k for k, v in fixture.items() if not bits_equal(v.numpy(), shipped[k])]
    if bad or not fixture:
        raise AssertionError(f"committed orbax fixture differs from the .npz: {bad}")
    log(f"  committed JAX-written fixture: {len(fixture)} leaves equal to the shipped "
        f".npz widened to float32, bit for bit; zstd modes {dict(zstd.MODES)}")
    solver = ORBAX_FIXTURE / "solver"
    step = checkpoint.latest_step(str(solver))
    want = checkpoint.load_jax_params(str(solver), step)
    out = run_cli(["ctpn_tpu_torch.cli.export_model", "--ckpt", str(solver),
                   "--out", str(ORBAX_OUT / "solver.npz")])
    if f"restored step {step}" not in out:
        raise AssertionError(f"ctpn-torch-export --ckpt on the JAX solver step: {out}")
    with np.load(ORBAX_OUT / "solver.npz") as got:
        flat = {f"{a}/{b}": v for a, leaves in want.items() for b, v in leaves.items()}
        if sorted(got.files) != sorted(flat) or not all(
                bits_equal(got[k].astype(np.float32), flat[k]) for k in flat):
            raise AssertionError("ctpn-torch-export --ckpt: the .npz differs from "
                                 "the JAX solver step's state.params")
    log(f"  ctpn-torch-export --ckpt on the JAX solver step {step} (subprocess): "
        f"{len(flat)} leaves equal to its state.params")

    art = ORBAX_OUT / "artifact"
    run_cli(["ctpn_tpu_torch.cli.export_model", "--npy", str(ARTIFACT), "--out", str(art)])
    t0 = time.perf_counter()
    host = load_params(str(art), device="cpu")
    report["plain_read_s"] = time.perf_counter() - t0
    report["plain_mb"] = sum(t.nbytes for t in host.values()) / 1e6
    npz_params = load_params(str(ARTIFACT), device=dev)
    params = load_params(str(art), device=dev)
    if sorted(params) != sorted(npz_params) or len(params) != 38 or not all(
            torch.equal(params[k], npz_params[k]) for k in params):
        raise AssertionError("the orbax export read on the card differs from the .npz")
    log(f"  ctpn-torch-export --out <dir>: {len(params)} leaves, "
        f"{report['plain_mb']:.1f} MB plain layout, read on the host in "
        f"{report['plain_read_s']:.3f} s; on the card equal to the .npz route")
    report["decode_mb_s"], frames_b, decoded_b = zstd_decode_rate(
        ORBAX_FIXTURE / "artifact" / "params")
    log(f"  zstd decode of the fixture's chunks: {frames_b} bytes of frames -> "
        f"{decoded_b} bytes, {report['decode_mb_s']:.1f} MB/s")

    # the fixture's leaves overlaid on the export: the same weights as the .npz
    weights = load_pretrained_into(nested_tree(params), str(ORBAX_FIXTURE / "artifact"),
                                   ignore_missing=False)
    reset_cfg()
    pred = CTPNPredictor(weights, device=dev)
    pred.warmup((608, 912))
    zero_launch_counts()  # counts of this path only
    hits = n_ref = lines = 0
    for photo, want_recs in zip(PHOTOS, default_recs):
        before = NF.nms_keep_sorted_fused.LAUNCHES
        recs = pred.detect_image(load_image_bgr(str(photo)))
        torch.cuda.synchronize()
        if NF.nms_keep_sorted_fused.LAUNCHES - before != 2:
            raise AssertionError(f"{photo.name}: nms_fused launched "
                                 f"{NF.nms_keep_sorted_fused.LAUNCHES - before} times, not 2")
        if not bits_equal(recs, want_recs):
            raise AssertionError(f"{photo.name}: records of orbax-read weights differ "
                                 "from phase 4's")
        hit, n = recall_vs_committed(recs, photo)
        check_budget(photo.name, len(recs), n, "orbax weights")
        hits, n_ref, lines = hits + hit, n_ref + n, lines + len(recs)
        log(f"  orbax weights {photo.name}: {len(recs)} lines equal to phase 4's bit "
            f"for bit, nms_fused +2, committed lines {hit}/{n}")
    expect_launches(launch_counts(), route_launches("default", len(PHOTOS)), "orbax weights")
    if hits < 0.75 * n_ref:
        raise AssertionError(f"orbax weights: only {hits}/{n_ref} committed lines found")
    check_precision(hits, lines, "orbax weights")
    report["launches"] = launch_counts()
    del pred

    answers, first_s = {}, {}
    for name, source in (("npz", ARTIFACT), ("orbax", art)):
        def one_post(port, name=name):
            status, out = post(f"http://127.0.0.1:{port}/detect", PHOTOS[1].read_bytes())
            first_s[name] = time.perf_counter() - t0
            if status != 200 or out.get("count", 0) <= 0:
                raise AssertionError(f"ctpn-torch-serve on the {name} artifact: {status} {out}")
            answers[name] = np.asarray(out["boxes"], np.float64).reshape(-1, 9)

        t0 = time.perf_counter()
        # batch 1, as phase 9's detect_image ran: records move with the batch
        serve_subprocess(["--artifact", str(source), "--no-warmup", "--max-batch", "1"],
                         one_post)
    if not bits_equal(answers["orbax"], answers["npz"]):
        raise AssertionError("ctpn-torch-serve: the directory's answer differs from the .npz's")
    frozen = FROZEN_PHOTO_RECS.get(PHOTOS[1].name)  # absent when phase 9 did not run
    worst = rows_match(answers["orbax"], frozen, 0.5) if frozen is not None else None
    report["first_answer_s"] = first_s
    log(f"  ctpn-torch-serve --artifact <dir>: {PHOTOS[1].name} answered with "
        f"{len(answers['orbax'])} lines, equal to the server on the .npz; paired with "
        f"phase 9's records, worst {worst} px; first answer {first_s['orbax']:.2f} s "
        f"(.npz {first_s['npz']:.2f} s)")
    log("  orbax " + json.dumps(report))
    return report


# ------------------------------------------------------------- bench_torch.py

BENCH_TIMEOUT_S = 300  # per child of bench_torch.py's supervisor


def run_bench(route: str) -> tuple:
    """``python3 bench_torch.py`` as a user runs it, at its defaults on
    ``route``: its JSON line and its ``# bench_torch`` report."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_CHILD_TIMEOUT_S=str(BENCH_TIMEOUT_S), BENCH_BACKOFF_S="5")
    if ROUTE_SETS[route]:
        env["BENCH_CFG_SET"] = " ".join(ROUTE_SETS[route])
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], cwd=str(REPO),
                          capture_output=True, text=True, env=env,
                          timeout=3 * BENCH_TIMEOUT_S + 120)
    out = proc.stdout.strip().splitlines()
    try:
        line = json.loads(out[-1])
    except (IndexError, ValueError):
        raise AssertionError(f"bench_torch.py ({route}) printed no parseable line "
                             f"(rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr[-3000:]}")
    reports = [json.loads(ln[len("# bench_torch "):]) for ln in proc.stderr.splitlines()
               if ln.startswith("# bench_torch ")]
    return line, (reports[-1] if reports else None), proc.stderr


def drive_bench(card_name: str, captured: dict) -> dict:
    """``bench_torch.py`` on the default and the served route (batch 48, 14
    replays on a batch already on the card, both rows). Fails on a null
    value (a failed records gate is one), a retry, another device than the
    card, content other than ``real``, or launches per replayed batch other
    than the route's; prints each line beside phase 16's replayed ms per
    batch of the route, which is another figure: batch 8 of the photos,
    uploaded from the host in every call."""
    lines = {}
    for route in ("default", "served"):
        t0 = time.perf_counter()
        line, report, err = run_bench(route)
        if line.get("value") is None or line.get("attempts") != 1 or report is None:
            raise AssertionError(f"bench_torch.py ({route}): {line}\n{err[-3000:]}")
        if line["device"] != card_name or line["content"] != "real":
            raise AssertionError(f"bench_torch.py ({route}) ran on {line['device']} "
                                 f"with {line['content']} content: {line}")
        want = {k: float(n) for k, n in ROUTE_LAUNCHES[route].items()}
        for name, row in report["rows"].items():
            if row["launches_per_batch"] != want:
                raise AssertionError(f"bench_torch.py ({route}), {name} row: launches per "
                                     f"batch {row['launches_per_batch']}, want {want}")
        log(f"  bench_torch.py {route} route ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(line))
        log(f"  bench_torch.py {route} report: " + json.dumps(report))
        log(f"  {route}: {1e3 * line['batch'] / line['value']:.2f} ms per batch of "
            f"{line['batch']} already on the card; phase 16: "
            f"{captured[route]['replayed_ms_per_batch']:.2f} ms per batch of 8 photos "
            "uploaded per call (not the same figure)")
        lines[route] = line
    return lines


# ------------------------------------------------------------------ EAST

EAST_ARTIFACT = REPO / "data" / "artifacts" / "east_vgg16_synth_f16.npz"
# the cell east_device_b32's shape: 32 renders at 1280x720 padded to 736x1280
EAST_BATCH, EAST_BUCKET = 32, (736, 1280)
# kernel launches per EAST program run in bf16: a conv epilogue per conv
# (13 of the trunk, 6 of the merge branch, the last conv), the walk, the
# quad bitmask and the resolve; the merge branch's three skip inputs
EAST_LAUNCHES = {"conv_epilogue": 20, "lanms_walk": 1, "quad_bitmask": 1, "nms_resolve": 1,
                 "resize_concat": 3}
# float ops of one quad IoU test at its least (benchmark/flops_east.py)
QUAD_IOU_OPS = 112


def east_cfg(bucket=EAST_BUCKET) -> None:
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg

    reset_cfg()
    cfg_from_list(["NET_NAME", "EAST_VGG16", "TPU.BUCKETS", [list(bucket)],
                   "TEXT.SCALE", 720, "TEXT.MAX_SCALE", 1280,
                   "TEST.SCALES", [720], "TEST.MAX_SIZE", 1280])


def rect_cells(rng, n: int, words: int, jitter: float = 1.5) -> np.ndarray:
    """(n, 9) cells of ``words`` rotated rectangles, in a shuffled raster-
    like order (runs of the same word), scores in [0.8, 1)."""
    from ctpn_tpu_torch.plain.east import restore_rbox

    cx, cy = rng.uniform(0, 1200, words), rng.uniform(0, 700, words)
    w, h = rng.uniform(20, 200, words), rng.uniform(10, 40, words)
    a = rng.uniform(-0.6, 0.6, words)
    geo = np.stack([h / 2, w / 2, h / 2, w / 2], 1).astype(np.float32)
    base = restore_rbox(cx.astype(np.float32), cy.astype(np.float32), geo, a.astype(np.float32))
    runs = np.repeat(rng.randint(0, words, (n + 7) // 8), 8)[:n]
    q = base[runs] + rng.normal(0, jitter, (len(runs), 8)).astype(np.float32)
    s = rng.uniform(0.8, 1.0, len(runs)).astype(np.float32)
    return np.concatenate([s[:, None], q], 1).astype(np.float32)


def check_east_kernels(dev) -> list:
    """The walk and the quad bitmask against their plain versions, bit for
    bit: cell-like runs, empty and one-cell images, ties, a cap reached;
    the bitmask around word multiples, identical quads, invalid tails."""
    from ctpn_tpu_torch.ops import lanms, quad_nms

    rng = np.random.RandomState(25)
    out = []
    walk_cases = []
    for counts, cap in (([4000, 0, 1, 2500, 37] + [3000] * 27, 4096), ([300, 300], 16),
                        ([64, 64], 4096)):
        m = max(counts)
        cells = np.zeros((len(counts), m, 9), np.float32)
        for i, n in enumerate(counts):
            cells[i, :n] = rect_cells(rng, n, max(n // 80, 1))
        if cap == 4096 and len(counts) == 2:  # ties: one quad, equal scores
            cells[:, :, :] = cells[:1, :1, :]
        walk_cases.append((torch.from_numpy(cells), torch.tensor(counts, dtype=torch.int32), cap))
    for cells, count, cap in walk_cases:
        got = lanms.lanms_walk(cells.to(dev), count.to(dev), 0.2, cap)
        want = lanms.lanms_walk_ref(cells, count, 0.2, cap)
        for a, b, name in zip(got, want, ("merged", "cells", "count", "overflow")):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"lanms_walk {tuple(cells.shape)} cap {cap}: {name} differs")
        log(f"  lanms_walk {tuple(cells.shape)} cap {cap}: equal; kept "
            f"{want[2].tolist()[:6]} overflow {want[3].tolist()[:6]}")
    for b, k, valid_n in ((4, 31, 31), (4, 33, 20), (2, 1000, 700), (8, 512, 300)):
        q = torch.from_numpy(rect_cells(rng, b * k, max(k // 3, 1), jitter=4.0)[:, 1:]
                             ).reshape(b, k, 8)
        valid = torch.arange(k)[None].expand(b, k) < torch.randint(0, valid_n + 1, (b, 1))
        valid[0, :valid_n] = True
        for case, qq in (("rects", q), ("identical", q[:, :1].expand(b, k, 8).contiguous())):
            got = quad_nms.quad_bitmask(qq.to(dev), valid.to(dev), 0.2).cpu()
            want = quad_nms.quad_bitmask_ref(qq, valid, 0.2)
            if not torch.equal(got, want):
                raise AssertionError(f"quad_bitmask ({b},{k}) {case}: words differ")
        log(f"  quad_bitmask ({b},{k}) valid <= {valid_n}: equal (rects, identical)")
    out.append({"name": "lanms_walk", "cases": len(walk_cases), "equal": True})
    out.append({"name": "quad_bitmask", "cases": 8, "equal": True})
    return out


def east_batch(n: int = EAST_BATCH):
    """``n`` held-out renders at 1280x720, prepped into the bucket."""
    from ctpn_tpu_torch.cli.train_east_synth import holdout
    from ctpn_tpu_torch.utils.image import prep_image

    data, infos = [], []
    for im, _ in holdout(n):
        d, info, _ = prep_image(im)
        data.append(d)
        infos.append(info)
    return np.stack(data), np.stack(infos)


def greedy_tests(mask: np.ndarray, count: int) -> int:
    """IoU tests of greedy NMS over ``count`` sorted quads whose
    suppression bits are ``mask`` (count, words) (the reference's loop)."""
    bits = np.unpackbits(mask[:count].view(np.uint8), axis=1, bitorder="little")[:, :count]
    alive = np.ones(count, bool)
    tests = 0
    for i in range(count):
        if not alive[i]:
            continue
        alive[i] = False
        tests += int(alive[i + 1:].sum())
        alive &= ~bits[i].astype(bool)
    return tests


def records_of(recs, n: int) -> list:
    r, c = recs.recs.cpu().numpy(), recs.count.cpu().numpy()
    return [r[i, :int(c[i])] for i in range(n)]


def check_east_epilogue_sites(model, xs) -> list:
    """The conv epilogue at each of EAST's 20 sites (13 trunk convs, the
    six merge convs, the last conv) on the batch ``xs`` (mean subtracted),
    against its plain version bit for bit: the network run eagerly with
    every call of the op checked as it is made."""
    from ctpn_tpu_torch.models import vgg
    from ctpn_tpu_torch.ops import conv_epilogue as EP

    sites, real = [], vgg.conv_epilogue

    def checked(y, b, pool):
        got = real(y, b, pool)
        want = EP.conv_epilogue_ref(y, b, pool)
        same = got.shape == want.shape and torch.equal(bits_of(got), bits_of(want))
        sites.append({"shape": list(y.shape), "pool": pool, "equal": bool(same)})
        return got

    vgg.conv_epilogue = checked
    try:
        with torch.inference_mode():
            model.merge(model.trunk_taps(xs))
        torch.cuda.synchronize()
    finally:
        vgg.conv_epilogue = real
    log("  conv_epilogue at EAST's sites: " + "; ".join(
        f"{tuple(s['shape'])}{' pool' if s['pool'] else ''} "
        f"{'equal' if s['equal'] else 'DIFFERS'}" for s in sites))
    if len(sites) != EAST_LAUNCHES["conv_epilogue"] or sum(s["pool"] for s in sites) != 5:
        raise AssertionError(f"EAST: {len(sites)} epilogue sites, "
                             f"{sum(s['pool'] for s in sites)} pooled (want 20, 5)")
    bad = [s for s in sites if not s["equal"]]
    if bad:
        raise AssertionError(f"conv_epilogue differs from its plain version at {bad}")
    return sites


def drive_east(dev, artifact: Path = EAST_ARTIFACT) -> dict:
    """EAST on the card at the cell's shape: launches per replayed run,
    repeats bit for bit, each image's records in every slot and alone, the
    eager program against the replay, the caps' overflow, the stride-16
    maps per slot, the conv epilogue's 20 sites and the new kernels on the
    batch's own data against their plain versions, and the new kernels'
    times beside their bounds."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, EASTPredictor
    from ctpn_tpu_torch.ops import lanms, quad_nms
    from ctpn_tpu_torch.ops.nms_resolve import nms_resolve
    from ctpn_tpu_torch.postprocess.east import decode, east_kwargs
    from ctpn_tpu_torch.utils.weights import load_params

    east_cfg()
    pred = CTPNPredictor(load_params(str(artifact), device=dev), device=dev)
    assert isinstance(pred, EASTPredictor)
    data, infos = east_batch()
    x, info = torch.from_numpy(data).to(dev), torch.from_numpy(infos).to(dev)
    first = pred.graphs(x, info)
    first = pred.graphs(x, info)  # the first replay
    torch.cuda.synchronize()
    zero_launch_counts()
    runs = [pred.graphs(x, info) for _ in range(5)]
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {k: 5 * v for k, v in EAST_LAUNCHES.items()},
                    "EAST, 5 replayed runs")
    base = records_of(first[1], EAST_BATCH)
    for quads, recs in runs:
        if not all(np.array_equal(a, b) for a, b in zip(records_of(recs, EAST_BATCH), base)):
            raise AssertionError("EAST: a replay's records differ from the first")
    eager = pred.program(x, info)
    if not all(np.array_equal(a, b) for a, b in zip(records_of(eager[1], EAST_BATCH), base)):
        raise AssertionError("EAST: the eager program's records differ from the replay")
    q = first[0]
    counts = {"cells": q.cells.cpu().tolist(), "merged": q.count.cpu().tolist(),
              "records": first[1].count.cpu().tolist()}
    over = int(q.overflow.sum()) + int(first[1].overflow.sum())
    log("  EAST per image: cells mean %.1f max %d, merged mean %.1f max %d, records mean "
        "%.1f max %d; overflow %d" % (np.mean(counts["cells"]), max(counts["cells"]),
                                     np.mean(counts["merged"]), max(counts["merged"]),
                                     np.mean(counts["records"]), max(counts["records"]), over))
    if over:
        raise AssertionError(f"EAST: {over} quads past the caps")
    if min(counts["records"]) == 0:
        raise AssertionError("EAST: an image without records")

    # slots: every image alone (batch 1) and in the batch rolled by 13
    slot_diff = 0
    for i in range(EAST_BATCH):
        alone = pred.graphs(x[i:i + 1], info[i:i + 1])
        if not np.array_equal(records_of(alone[1], 1)[0], base[i]):
            slot_diff += 1
    rolled = pred.graphs(x.roll(13, 0), info.roll(13, 0))
    rolled_recs = records_of(rolled[1], EAST_BATCH)
    slot_diff += sum(not np.array_equal(rolled_recs[(i + 13) % EAST_BATCH], base[i])
                     for i in range(EAST_BATCH))
    # the maps behind any difference: each tap and the merge output per slot
    with torch.inference_mode():
        from ctpn_tpu_torch.inference.pipeline import mean_subtracted

        m = pred.model
        xs = mean_subtracted(x[:4])
        taps_b = m.trunk_taps(xs)
        merged_b = m.merge(taps_b)
        split = {}
        for j in range(4):
            taps_1 = m.trunk_taps(xs[j:j + 1])
            names = ["pool2", "pool3", "pool4", "pool5"]
            d = {n: float((a[j:j + 1].float() - b.float()).abs().max())
                 for n, a, b in zip(names, taps_b, taps_1)}
            d["merge"] = float((merged_b[j:j + 1].float() - m.merge(taps_1).float()).abs().max())
            split[j] = d
    log(f"  EAST slots: {slot_diff} of {2 * EAST_BATCH} image runs differ from the batch's; "
        f"maps batch vs alone (max abs): {json.dumps(split)}")
    if slot_diff:
        raise AssertionError("EAST: an image's records depend on its slot")

    # the conv epilogue at EAST's 20 sites on the whole batch
    sites = check_east_epilogue_sites(m, mean_subtracted(x))

    # the new kernels at the cell's shape, on this batch's own cells and
    # merged quads: against their plain versions bit for bit, then timed
    kw = east_kwargs()
    with torch.inference_mode():
        outs = m.head(m.merge(m.trunk_taps(mean_subtracted(x))))
        cells, ncount = decode(outs, info, kw["score_thresh"])
        walk = lanms.lanms_walk(cells, ncount, kw["nms_thresh"], kw["max_merged"])
    want = lanms.lanms_walk_ref(cells.cpu(), ncount.cpu(), kw["nms_thresh"], kw["max_merged"])
    for a, b, name in zip(walk, want, ("merged", "cells", "count", "overflow")):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"lanms_walk {tuple(cells.shape)} on the batch's cells: "
                                 f"{name} differs from the plain version")
    log(f"  lanms_walk {tuple(cells.shape)} on the batch's own cells (live per image up "
        f"to {int(ncount.max())}): equal to the plain version bit for bit")
    walk_ms = cuda_ms(lambda: lanms.lanms_walk(cells, ncount, kw["nms_thresh"],
                                               kw["max_merged"]), 10)
    rois, valid = first[0].rois, first[0].valid
    quads = rois[..., 1:].contiguous()
    mask_ms = cuda_ms(lambda: quad_nms.quad_bitmask(quads, valid, kw["nms_thresh"]), 20)
    mask = quad_nms.quad_bitmask(quads, valid, kw["nms_thresh"])
    if not torch.equal(mask.cpu(), quad_nms.quad_bitmask_ref(quads.cpu(), valid.cpu(),
                                                             kw["nms_thresh"])):
        raise AssertionError(f"quad_bitmask {tuple(mask.shape)} on the batch's merged "
                             "quads differs from the plain version")
    log(f"  quad_bitmask {tuple(mask.shape)} on the batch's merged quads (valid per image "
        f"up to {int(valid.sum(1).max())}): equal to the plain version bit for bit")
    resolve_ms = cuda_ms(lambda: nms_resolve(mask, valid), 20)
    walk_tests = int(np.maximum(ncount.cpu().numpy() - 1, 0).sum())
    mask_np, qc = mask.cpu().numpy(), q.count.cpu().numpy()
    nms_tests = sum(greedy_tests(mask_np[i], int(qc[i])) for i in range(EAST_BATCH))
    k = kw["max_merged"]
    walk_bytes = int(ncount.sum()) * 36 + int(walk[2].sum()) * 40
    # the words that hold a bit the work needs: each image's count rows of
    # ceil(count / 32) words, beside its quads read
    mask_bytes = sum(int(c) * ((int(c) + 31) // 32) * 4 + int(c) * 33 for c in qc)
    walk_bound = max(walk_bytes / HBM_BYTES_PER_S, walk_tests * QUAD_IOU_OPS / F32_OPS_PER_S)
    mask_bound = max(mask_bytes / HBM_BYTES_PER_S, nms_tests * QUAD_IOU_OPS / F32_OPS_PER_S)
    times = {"lanms_walk_ms": walk_ms, "lanms_bound_ms": walk_bound * 1e3,
             "walk_tests": walk_tests, "quad_bitmask_ms": mask_ms,
             "quad_bitmask_bound_ms": mask_bound * 1e3, "nms_tests": nms_tests,
             "nms_resolve_ms": resolve_ms}
    log("  EAST kernels at (32, 736x1280): " + json.dumps(times))
    return {"counts": counts, "times": times, "slot_differences": slot_diff, "maps": split,
            "epilogue_sites": len(sites)}


# ------------------------------------------------------------------ CRAFT

CRAFT_ARTIFACT = REPO / "data" / "artifacts" / "craft_vgg16bn_synth_f16.npz"
# the cell craft_device_b32's shape: 32 renders at 1280x720 padded to 736x1280
CRAFT_BATCH, CRAFT_BUCKET = 32, (736, 1280)
# kernel launches per CRAFT program run in bf16 at the cell's batch: a conv
# epilogue per conv with a ReLU (11 of the trunk; 8 of the decoder's blocks
# and 4 of conv_cls, on the whole batch), the four blocks' skip inputs, one
# labelling and one box kernel
CRAFT_SITES = 23
CRAFT_LAUNCHES = {"conv_epilogue": CRAFT_SITES, "resize_concat": 4, "ccl_label": 1,
                  "craft_boxes": 1}
CRAFT_KW = dict(low_text=0.4, link_threshold=0.4, text_threshold=0.7, min_area=10)


def craft_cfg(bucket=CRAFT_BUCKET) -> None:
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg

    reset_cfg()
    cfg_from_list(["NET_NAME", "CRAFT_VGG16_BN", "TPU.BUCKETS", [list(bucket)]])


def blob_maps(rng, b: int, h: int, w: int, words: int) -> torch.Tensor:
    """(b, h, w, 2) made-up maps: rotated bars of characters (region) with
    links between them (affinity), noise, and scores near the thresholds."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    maps = np.zeros((b, h, w, 2), np.float32)
    maps[..., 0] = rng.uniform(-0.3, 0.45, (b, h, w))
    maps[..., 1] = rng.uniform(-0.3, 0.42, (b, h, w))
    for i in range(b):
        for _ in range(words):
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            a, n = rng.uniform(-0.8, 0.8), rng.randint(1, 9)
            size = rng.uniform(2, 12)
            for c in range(n):
                px = cx + c * 1.4 * size * np.cos(a)
                py = cy + c * 1.4 * size * np.sin(a)
                d = ((xx - px) ** 2 + (yy - py) ** 2) / (size * size / 4)
                maps[i, ..., 0] = np.maximum(maps[i, ..., 0], np.exp(-d) * rng.uniform(0.6, 1.0))
                if c:
                    qx, qy = px - 0.7 * size * np.cos(a), py - 0.7 * size * np.sin(a)
                    d = ((xx - qx) ** 2 + (yy - qy) ** 2) / (size * size / 6)
                    maps[i, ..., 1] = np.maximum(maps[i, ..., 1], np.exp(-d) * 0.8)
    maps[rng.rand(b, h, w) < 0.002, 0] = 0.7  # exact thresholds here and there
    maps[rng.rand(b, h, w) < 0.002, 1] = 0.4
    return torch.from_numpy(maps)


def same_labels(got, want, what: str) -> None:
    names = ("labels", "stats", "score", "count", "overflow", "on", "labelled")
    for a, b, name in zip(got, want, names):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"ccl_label {what}: {name} differs from the plain version")


def check_craft_kernels(dev) -> list:
    """The labelling and box kernels against their plain versions, bit for
    bit, on made-up maps: the cell's shape with its extents, small maps,
    empty maps, extents of one row and one column, a cap reached."""
    from ctpn_tpu_torch.ops import ccl, craft_boxes as cb

    rng = np.random.RandomState(26)
    cases = [("cell", blob_maps(rng, 4, 368, 640, 120), [[360, 640], [368, 640], [300, 500],
                                                         [368, 1]], 512),
             ("small", blob_maps(rng, 3, 33, 47, 10), [[33, 47], [1, 47], [20, 30]], 64),
             ("empty", torch.full((2, 40, 64, 2), -1.0), [[40, 64], [0, 0]], 16),
             ("cap", blob_maps(rng, 2, 120, 200, 200), [[120, 200], [120, 200]], 5),
             ("wide", blob_maps(rng, 1, 64, 1500, 300), [[64, 1500]], 1024)]
    kept = 0
    for name, maps, ext, cap in cases:
        extent = torch.tensor(ext, dtype=torch.int32)
        args = (CRAFT_KW["low_text"], CRAFT_KW["link_threshold"], CRAFT_KW["text_threshold"],
                CRAFT_KW["min_area"], cap)
        got = ccl.ccl_label(maps.to(dev), extent.to(dev), *args)
        want = ccl.ccl_label_ref(maps, extent, *args)
        same_labels(got, want, f"{name} {tuple(maps.shape)}")
        recs = cb.craft_boxes(maps.to(dev), *[t.to(dev) for t in want[:4]], extent.to(dev),
                              CRAFT_KW["low_text"], 2.0)
        plain = cb.craft_boxes_ref(maps, *want[:4], extent, CRAFT_KW["low_text"], 2.0)
        if not torch.equal(recs.cpu(), plain):
            raise AssertionError(f"craft_boxes {name}: boxes differ from the plain version")
        kept += int(want[3].sum())
        log(f"  ccl_label, craft_boxes {name} {tuple(maps.shape)} cap {cap}: equal; kept "
            f"{want[3].tolist()} overflow {want[4].tolist()} labelled {want[6].tolist()}")
    return [{"name": "ccl_label", "cases": len(cases), "equal": True, "kept": kept},
            {"name": "craft_boxes", "cases": len(cases), "equal": True}]


def craft_batch(pred, n: int = CRAFT_BATCH):
    """``n`` held-out renders at 1280x720, prepped by CRAFT's rule."""
    from ctpn_tpu_torch.cli.train_craft_synth import holdout

    preps = [pred.prep(im) for im, _ in holdout(n)]
    return np.stack([p[0] for p in preps]), np.stack([p[1] for p in preps])


def check_craft_epilogue_sites(model, xs) -> list:
    """The conv epilogue at each of CRAFT's 23 sites on the batch ``xs``
    (normalised), against its plain version bit for bit."""
    from ctpn_tpu_torch.models import vgg
    from ctpn_tpu_torch.ops import conv_epilogue as EP

    sites, real = [], vgg.conv_epilogue

    def checked(y, b, pool):
        got = real(y, b, pool)
        want = EP.conv_epilogue_ref(y, b, pool)
        same = got.shape == want.shape and torch.equal(bits_of(got), bits_of(want))
        sites.append({"shape": list(y.shape), "pool": pool, "equal": bool(same)})
        return got

    vgg.conv_epilogue = checked
    try:
        with torch.inference_mode():
            model.decoder(model.trunk_taps(xs))
        torch.cuda.synchronize()
    finally:
        vgg.conv_epilogue = real
    log("  conv_epilogue at CRAFT's sites: " + "; ".join(
        f"{tuple(s['shape'])}{' pool' if s['pool'] else ''} "
        f"{'equal' if s['equal'] else 'DIFFERS'}" for s in sites))
    if len(sites) != CRAFT_SITES or sum(s["pool"] for s in sites) != 3:
        raise AssertionError(f"CRAFT: {len(sites)} epilogue sites, "
                             f"{sum(s['pool'] for s in sites)} pooled (want 23, 3)")
    bad = [s for s in sites if not s["equal"]]
    if bad:
        raise AssertionError(f"conv_epilogue differs from its plain version at {bad}")
    return sites


def craft_answers(out, n: int) -> list:
    text, recs = out
    r, c = recs.recs.cpu().numpy(), recs.count.cpu().numpy()
    m = text.maps.cpu().numpy()
    return [(r[i, :int(c[i])], m[i]) for i in range(n)]


def drive_craft(dev, artifact: Path = CRAFT_ARTIFACT) -> dict:
    """CRAFT on the card at the cell's shape: launches per replayed run,
    repeats bit for bit, each image's maps and boxes in every slot and
    alone, the eager program against the replay, the cap's overflow, the
    taps and maps of four slots, the conv epilogue's 23 sites and
    both new kernels on the batch's own maps against their plain versions,
    and their times beside their bounds."""
    from ctpn_tpu_torch.inference.pipeline import CRAFTPredictor, CTPNPredictor, craft_normalised
    from ctpn_tpu_torch.ops import ccl, craft_boxes as cb
    from ctpn_tpu_torch.postprocess.craft import craft_kwargs, map_extent
    from ctpn_tpu_torch.utils.weights import load_params

    craft_cfg()
    pred = CTPNPredictor(load_params(str(artifact), device=dev), device=dev)
    assert isinstance(pred, CRAFTPredictor)
    data, infos = craft_batch(pred)
    x, info = torch.from_numpy(data).to(dev), torch.from_numpy(infos).to(dev)
    first = pred.graphs(x, info)
    first = pred.graphs(x, info)  # the first replay
    torch.cuda.synchronize()
    zero_launch_counts()
    runs = [pred.graphs(x, info) for _ in range(5)]
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {k: 5 * v for k, v in CRAFT_LAUNCHES.items()},
                    "CRAFT, 5 replayed runs")
    base = craft_answers(first, CRAFT_BATCH)

    def same(a, b):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    for out in runs:
        if not all(same(a, b) for a, b in zip(craft_answers(out, CRAFT_BATCH), base)):
            raise AssertionError("CRAFT: a replay's maps or boxes differ from the first")
    eager = pred.program(x, info)
    if not all(same(a, b) for a, b in zip(craft_answers(eager, CRAFT_BATCH), base)):
        raise AssertionError("CRAFT: the eager program's answers differ from the replay")
    t = first[0]
    counts = {k: getattr(t, k).cpu().tolist() for k in ("on", "labelled", "count")}
    over = int(t.overflow.sum())
    log("  CRAFT per image: pixels on mean %.1f, components mean %.1f max %d, kept mean %.2f "
        "max %d min %d; overflow %d" % (
            np.mean(counts["on"]), np.mean(counts["labelled"]), max(counts["labelled"]),
            np.mean(counts["count"]), max(counts["count"]), min(counts["count"]), over))
    if over:
        raise AssertionError(f"CRAFT: {over} components past the cap")
    if min(counts["count"]) == 0:
        raise AssertionError("CRAFT: an image without boxes")

    # slots: every image alone (batch 1) and in the batch rolled by 13
    slot_diff = 0
    for i in range(CRAFT_BATCH):
        alone = craft_answers(pred.graphs(x[i:i + 1], info[i:i + 1]), 1)[0]
        slot_diff += not same(alone, base[i])
    rolled = craft_answers(pred.graphs(x.roll(13, 0), info.roll(13, 0)), CRAFT_BATCH)
    slot_diff += sum(not same(rolled[(i + 13) % CRAFT_BATCH], base[i])
                     for i in range(CRAFT_BATCH))
    m = pred.model
    with torch.inference_mode():
        xs = craft_normalised(x[:4])
        taps_b = m.trunk_taps(xs)
        maps_b = m.maps(taps_b)
        split = {}
        for j in range(4):
            taps_1 = m.trunk_taps(xs[j:j + 1])
            names = ["conv2_2", "conv3_2", "conv4_2", "conv5_2"]
            d = {n: float((a[j:j + 1].float() - b.float()).abs().max())
                 for n, a, b in zip(names, taps_b, taps_1)}
            d["maps"] = float((maps_b[j:j + 1] - m.maps(taps_1)).abs().max())
            split[j] = d
    log(f"  CRAFT slots: {slot_diff} of {2 * CRAFT_BATCH} image runs differ from the batch's; "
        f"maps batch vs alone (max abs): {json.dumps(split)}")
    if slot_diff:
        raise AssertionError("CRAFT: an image's maps or boxes depend on its slot")

    sites = check_craft_epilogue_sites(m, craft_normalised(x))

    # both kernels on the batch's own maps, against their plain versions
    kw = craft_kwargs()
    maps = first[0].maps
    extent = map_extent(info, maps)
    args = (kw["low_text"], kw["link_threshold"], kw["text_threshold"], kw["min_area"],
            kw["max_boxes"])
    got = ccl.ccl_label(maps, extent, *args)
    want = ccl.ccl_label_ref(maps, extent, *args)  # the plain version, on the card
    same_labels(got, want, f"on the batch's maps {tuple(maps.shape)}")
    recs = cb.craft_boxes(maps, *got[:4], extent, kw["low_text"], 2.0)
    plain = cb.craft_boxes_ref(maps, *got[:4], extent, kw["low_text"], 2.0)
    if not torch.equal(recs.cpu(), plain.cpu()):
        raise AssertionError("craft_boxes on the batch's maps differs from the plain version")
    log("  ccl_label and craft_boxes on the batch's own maps: equal to their plain versions "
        "bit for bit")
    ccl_ms = cuda_ms(lambda: ccl.ccl_label(maps, extent, *args), 20)
    boxes_ms = cuda_ms(lambda: cb.craft_boxes(maps, *got[:4], extent, kw["low_text"], 2.0), 20)
    ext = extent.cpu().numpy()
    pixels = int((ext[:, 0] * ext[:, 1]).sum())
    st, cnt = got[1].cpu().numpy(), got[3].cpu().numpy()
    box_px = int(sum(int(st[i, k, 4]) * int(st[i, k, 5]) for i in range(len(cnt))
                     for k in range(int(cnt[i]))))
    # bytes the work needs: the maps read and the labels written over the
    # extents; the boxes' label and region reads over each component's box
    ccl_bytes = pixels * (8 + 4)
    boxes_bytes = box_px * (4 + 8) + int(cnt.sum()) * (24 + 4 + 36)
    times = {"ccl_label_ms": ccl_ms, "ccl_bound_ms": ccl_bytes / HBM_BYTES_PER_S * 1e3,
             "craft_boxes_ms": boxes_ms,
             "craft_boxes_bound_ms": boxes_bytes / HBM_BYTES_PER_S * 1e3,
             "pixels": pixels, "box_pixels": box_px, "kept": int(cnt.sum())}
    log("  CRAFT kernels at (32, 736x1280): " + json.dumps(times))
    return {"counts": counts, "times": times, "slot_differences": slot_diff, "maps": split,
            "epilogue_sites": len(sites)}


# --------------------------------------------------------------------- DB

DB_ARTIFACT = REPO / "data" / "artifacts" / "dbnet_r50_dcn_synth.npz"
# the cell db_device_b32's shape: 32 renders at 1280x720 resized to 736x1312
DB_BATCH, DB_BUCKET = 32, (736, 1312)
# kernel launches per DB program run in bf16: a conv epilogue per conv with
# a ReLU (the stem, two per bottleneck, the head's conv and first
# transposed conv), a deformable conv per bottleneck of stages 2-4, a
# residual epilogue per bottleneck, one labelling and one box kernel
DB_SITES = 13
DB_BLOCKS = 16
DB_LAUNCHES = {"conv_epilogue": 35, "deform_conv": DB_SITES, "residual_epilogue": DB_BLOCKS,
               "ccl_label": 1, "db_boxes": 1}
DB_KW = dict(thresh=0.3, box_thresh=0.7, unclip=1.5, min_size=3.0)


def db_cfg(bucket=DB_BUCKET) -> None:
    from ctpn_tpu_torch.cli.train_db_synth import db_cfg as cfg_db
    from ctpn_tpu_torch.config import cfg_from_list

    cfg_db()
    cfg_from_list(["TPU.BUCKETS", [list(bucket)]])


def same_deform(got, want, what: str, cols=None) -> dict:
    """The kernel's product against the plain version's: within a bfloat16
    step of the largest output (a column's mask may round another way
    where the sigmoid's exp differs by an ulp); the columns, where given,
    equal but for such roundings."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) or 1.0
    gap = float((g - w).abs().max())
    row = {"what": what, "max_abs": gap, "scale": scale,
           "equal_frac": float((got == want).float().mean())}
    if cols is not None:
        kc, pc = cols
        row["col_equal_frac"] = float((kc == pc).float().mean())
        row["col_max_abs"] = float((kc.float() - pc.float()).abs().max())
        if row["col_equal_frac"] < 0.999 or row["col_max_abs"] > 2 ** -7 * max(
                float(pc.float().abs().max()), 1e-30):
            raise AssertionError(f"deform_conv {what}: columns differ: {row}")
    if gap > 2 ** -7 * scale:
        raise AssertionError(f"deform_conv {what}: products differ: {row}")
    return row


def kernel_columns(x, om, stride):
    from ctpn_tpu_torch.ops import deform_conv as D

    n, c, h, w = x.shape
    ho, wo = om.shape[2:]
    col = torch.empty((n, ho * wo, 9 * c), dtype=torch.bfloat16, device=x.device)
    D._KERNEL(x.device, x, om.permute(0, 2, 3, 1).contiguous(), col, n, c, h, w, ho, wo,
              stride)
    return col


def db_blob_maps(rng, b: int, h: int, w: int, words: int) -> torch.Tensor:
    """(b, h, w) made-up probability maps: rotated bars of words, noise,
    values at the threshold here and there."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    maps = rng.uniform(0.0, 0.29, (b, h, w)).astype(np.float32)
    for i in range(b):
        for _ in range(words):
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            a, L, t = rng.uniform(-0.6, 0.6), rng.uniform(4, 80), rng.uniform(2, 16)
            u = (xx - cx) * np.cos(a) + (yy - cy) * np.sin(a)
            v = -(xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)
            inside = (np.abs(u) <= L / 2) & (np.abs(v) <= t / 2)
            maps[i][inside] = rng.uniform(0.6, 1.0, int(inside.sum()))
    maps[rng.rand(b, h, w) < 0.002] = 0.3  # on the threshold: off
    return torch.from_numpy(maps)


def check_db_kernels(dev) -> list:
    """The deformable conv against its plain version on made-up cases; the
    8-connected labelling of one channel and the box kernel against their
    plain versions, bit for bit, on made-up maps."""
    from ctpn_tpu_torch.ops import ccl, db_boxes as DBB, deform_conv as D

    g = torch.Generator().manual_seed(28)
    rows = []
    for name, (n, c, h, w, o, s, scale) in {
            "between": (2, 128, 46, 82, 128, 1, 1.5), "stride2": (2, 128, 92, 164, 128, 2, 1.5),
            "leave_the_map": (2, 256, 23, 41, 256, 1, 8.0), "integers": (2, 64, 20, 30, 64, 1, 0.0),
            "zero_masks": (1, 8, 5, 7, 16, 1, 3.0), "c512": (2, 512, 23, 41, 512, 2, 1.0)}.items():
        x = torch.randn(n, c, h, w, generator=g).to(dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        ho, wo = D.out_size(h, w, s)
        om = torch.randn(n, 27, ho, wo, generator=g)
        om[:, :18] *= scale
        if name == "integers":
            om[:, :18] = torch.randint(-3, 4, (n, 18, ho, wo), generator=g).float()
        if name == "zero_masks":
            om[:, 18:] = -200.0
        om = om.to(dev)
        wt = (torch.randn(o, c, 3, 3, generator=g) * 0.05).to(dev, torch.bfloat16)
        got = D.deform_conv(x, om, wt, s)
        want = D.deform_conv_ref(x, om, wt, s)
        if got.is_cuda and not got.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError("deform_conv's output is not channels_last")
        rows.append(same_deform(got, want, name, (kernel_columns(x, om, s),
                                                  D.sample_columns(x, om, s))))
        if name == "zero_masks" and got.abs().max():
            raise AssertionError("deform_conv: zero masks gave a product")
    log("  deform_conv on made-up cases: " + json.dumps(rows))
    rng = np.random.RandomState(28)
    cases = [("cell", db_blob_maps(rng, 3, 736, 1312, 60), [[736, 1312], [700, 1200], [736, 1]],
              100),
             ("small", db_blob_maps(rng, 2, 33, 47, 6), [[33, 47], [1, 47]], 16),
             ("empty", torch.zeros(2, 40, 64), [[40, 64], [0, 0]], 8),
             ("cap", db_blob_maps(rng, 1, 200, 300, 80), [[200, 300]], 5)]
    taken = 0
    for name, prob, ext, cap in cases:
        extent = torch.tensor(ext, dtype=torch.int32)
        dest = extent.float() * 1.5
        args = (DB_KW["thresh"], 0.0, 0.0, 1, cap)
        got = ccl.ccl_label(prob[..., None].to(dev), extent.to(dev), *args, connectivity=8)
        want = ccl.ccl_label_ref(prob[..., None], extent, *args, connectivity=8)
        same_labels(got, want, f"8-connected {name} {tuple(prob.shape)}")
        kw = (DB_KW["box_thresh"], DB_KW["unclip"], DB_KW["min_size"])
        recs = DBB.db_boxes(prob.to(dev), want[0].to(dev), want[1].to(dev), want[3].to(dev),
                            extent.to(dev), dest.to(dev), *kw)
        plain = DBB.db_boxes_ref(prob, want[0], want[1], want[3], extent, dest, *kw)
        for a, b, what in zip(recs, plain, ("records", "keep")):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"db_boxes {name}: {what} differ from the plain version")
        taken += int(want[3].sum())
        log(f"  ccl_label (8-connected), db_boxes {name} {tuple(prob.shape)} cap {cap}: equal; "
            f"taken {want[3].tolist()} kept {plain[1].sum(1).tolist()} overflow "
            f"{want[4].tolist()}")
    return [{"name": "deform_conv", "cases": len(rows), "rows": rows},
            {"name": "ccl_label_8", "cases": len(cases), "equal": True, "taken": taken},
            {"name": "db_boxes", "cases": len(cases), "equal": True}]


def db_batch(pred, n: int = DB_BATCH):
    """``n`` held-out renders at 1280x720, prepped by DB's rule."""
    from ctpn_tpu_torch.cli.train_craft_synth import holdout

    preps = [pred.prep(im) for im, _ in holdout(n)]
    return np.stack([p[0] for p in preps]), np.stack([p[1] for p in preps])


def db_answers(out, n: int) -> list:
    text, recs = out
    r, c = recs.recs.cpu().numpy(), recs.count.cpu().numpy()
    m = text.maps.cpu().numpy()
    return [(r[i, :int(c[i])], m[i]) for i in range(n)]


def offset_stats(om, h: int, w: int, stride: int) -> dict:
    """What a deformable site's offsets and masks ``om`` (N, 27, Ho, Wo)
    make of its sampling on an (h, w) input: the mean |dy| and |dx| in
    pixels; the share of samples whose point is not a whole pixel, and of
    those within 0.05 px of one in both directions (a near-grid gather);
    the share that lies wholly off the map (y <= -1, y >= h, x <= -1 or
    x >= w: every corner reads 0); and the mean mask."""
    from ctpn_tpu_torch.ops.deform_conv import TAPS

    om = om.float()
    dy, dx = om[:, 0:2 * TAPS:2], om[:, 1:2 * TAPS:2]
    ho, wo = om.shape[2:]
    tap = torch.arange(TAPS, device=om.device)
    y = (torch.arange(ho, device=om.device) * stride).view(1, 1, ho, 1) - 1 \
        + (tap // 3).view(1, TAPS, 1, 1) + dy
    x = (torch.arange(wo, device=om.device) * stride).view(1, 1, 1, wo) - 1 \
        + (tap % 3).view(1, TAPS, 1, 1) + dx
    off_y, off_x = (y - y.round()).abs(), (x - x.round()).abs()
    return {"mean_abs_dy": float(dy.abs().mean()), "mean_abs_dx": float(dx.abs().mean()),
            "between_pct": 100 * float(((off_y > 0) | (off_x > 0)).float().mean()),
            "near_grid_pct": 100 * float(((off_y < 0.05) & (off_x < 0.05)).float().mean()),
            "off_map_pct": 100 * float(((y <= -1) | (y >= h) | (x <= -1) | (x >= w))
                                       .float().mean()),
            "mean_mask": float(torch.sigmoid(om[:, 2 * TAPS:]).mean())}


def db_site_checks(model, xs) -> list:
    """The deformable conv at each of the 13 sites on the batch ``xs``
    (normalised): the kernel against its plain version, each one's ms, the
    site's least time (the op's bytes at the HBM rate or its operations at
    the bfloat16 peak), and its offsets' ``offset_stats``."""
    from ctpn_tpu_torch.models import resnet
    from ctpn_tpu_torch.ops import deform_conv as D

    calls, real = [], resnet.deform_conv

    def kept(x, om, w, stride):
        calls.append((x, om, w, stride))
        return real(x, om, w, stride)

    resnet.deform_conv = kept
    try:
        with torch.inference_mode():
            model.trunk(xs)
        torch.cuda.synchronize()
    finally:
        resnet.deform_conv = real
    sites = []
    for k, (x, om, w, stride) in enumerate(calls, start=1):
        n, c, h, wd = x.shape
        o, (ho, wo) = w.shape[0], om.shape[2:]
        with torch.inference_mode():
            row = same_deform(real(x, om, w, stride), D.deform_conv_ref(x, om, w, stride),
                              f"site {k}")
            ms = cuda_ms(lambda: real(x, om, w, stride), 10)
            plain_ms = cuda_ms(lambda: D.deform_conv_ref(x, om, w, stride), 3)
            sample_ms = cuda_ms(lambda: kernel_columns(x, om, stride), 10)
        ops = 2.0 * n * ho * wo * c * o * 9
        nbytes = n * (c * h * wd * 2 + 27 * ho * wo * 4 + o * ho * wo * 2) + o * c * 9 * 2
        bound = max(ops / BF16_TENSOR_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        sites.append(dict(row, site=k, shape=[n, c, h, wd], stride=stride, ms=ms,
                          sample_ms=sample_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_pct=100 * bound / ms, offsets=offset_stats(om, h, wd, stride)))
    for s in sites:
        log(f"  deform_conv site {s['site']} {tuple(s['shape'])}/{s['stride']}: "
            f"{s['ms']:.3f} ms (sampling {s['sample_ms']:.3f}), bound {s['bound_ms']:.3f} "
            f"({s['bound_pct']:.1f} %), plain {s['plain_ms']:.3f}; max gap {s['max_abs']:.3g} "
            f"of {s['scale']:.3g}, {100 * s['equal_frac']:.2f} % equal; offsets "
            + json.dumps(s["offsets"]))
    if len(sites) != DB_SITES:
        raise AssertionError(f"DB: {len(sites)} deformable sites (want {DB_SITES})")
    return sites


def drive_db(dev, artifact: Path = DB_ARTIFACT) -> dict:
    """DB on the card at the cell's shape: launches per replayed run,
    repeats bit for bit, each image's map and boxes in every slot and
    alone, the eager program against the replay, the cap's overflow, the
    kernel at the 13 sites, both post-process kernels on the batch's own
    map against their plain versions, and their times."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, DBPredictor, craft_normalised
    from ctpn_tpu_torch.ops import ccl, db_boxes as DBB
    from ctpn_tpu_torch.postprocess.db import db_kwargs, map_extent
    from ctpn_tpu_torch.utils.weights import load_params

    db_cfg()
    pred = CTPNPredictor(load_params(str(artifact), device=dev), device=dev)
    assert isinstance(pred, DBPredictor)
    data, infos = db_batch(pred)
    x, info = torch.from_numpy(data).to(dev), torch.from_numpy(infos).to(dev)
    torch.cuda.reset_peak_memory_stats()
    first = pred.graphs(x, info)
    first = pred.graphs(x, info)  # the first replay
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    zero_launch_counts()
    runs = [pred.graphs(x, info) for _ in range(5)]
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {k: 5 * v for k, v in DB_LAUNCHES.items()},
                    "DB, 5 replayed runs")
    base = db_answers(first, DB_BATCH)

    def same(a, b):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    for out in runs:
        if not all(same(a, b) for a, b in zip(db_answers(out, DB_BATCH), base)):
            raise AssertionError("DB: a replay's map or boxes differ from the first")
    eager = pred.program(x, info)
    if not all(same(a, b) for a, b in zip(db_answers(eager, DB_BATCH), base)):
        raise AssertionError("DB: the eager program's answers differ from the replay")
    t, r = first
    counts = {"on": t.on.cpu().tolist(), "labelled": t.labelled.cpu().tolist(),
              "taken": t.count.cpu().tolist(), "kept": r.count.cpu().tolist()}
    over = int(t.overflow.sum())
    log("  DB per image: pixels on mean %.1f, components mean %.1f max %d, boxes kept mean "
        "%.2f max %d min %d; overflow %d; peak memory %.2f GB" % (
            np.mean(counts["on"]), np.mean(counts["labelled"]), max(counts["labelled"]),
            np.mean(counts["kept"]), max(counts["kept"]), min(counts["kept"]), over, peak / 1e9))
    if over:
        raise AssertionError(f"DB: {over} components past the cap")

    slot_diff = 0
    for i in range(DB_BATCH):
        alone = db_answers(pred.graphs(x[i:i + 1], info[i:i + 1]), 1)[0]
        slot_diff += not same(alone, base[i])
    rolled = db_answers(pred.graphs(x.roll(13, 0), info.roll(13, 0)), DB_BATCH)
    slot_diff += sum(not same(rolled[(i + 13) % DB_BATCH], base[i]) for i in range(DB_BATCH))
    log(f"  DB slots: {slot_diff} of {2 * DB_BATCH} image runs differ from the batch's")
    if slot_diff:
        raise AssertionError("DB: an image's map or boxes depend on its slot")

    m = pred.model
    sites = db_site_checks(m, craft_normalised(x))

    kw = db_kwargs()
    prob = first[0].maps
    extent = map_extent(info, prob)
    dest = info[:, 2:4].contiguous()
    args = (kw["thresh"], 0.0, 0.0, 1, kw["max_boxes"])
    got = ccl.ccl_label(prob[..., None], extent, *args, connectivity=8)
    want = ccl.ccl_label_ref(prob[..., None], extent, *args, connectivity=8)
    same_labels(got, want, f"8-connected on the batch's map {tuple(prob.shape)}")
    bkw = (kw["box_thresh"], kw["unclip_ratio"], kw["min_size"])
    recs = DBB.db_boxes(prob, got[0], got[1], got[3], extent, dest, *bkw)
    plain = DBB.db_boxes_ref(prob, got[0], got[1], got[3], extent, dest, *bkw)
    if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(recs, plain)):
        raise AssertionError("db_boxes on the batch's map differs from the plain version")
    log("  ccl_label and db_boxes on the batch's own map: equal to their plain versions bit "
        "for bit")
    ccl_ms = cuda_ms(lambda: ccl.ccl_label(prob[..., None], extent, *args, connectivity=8), 20)
    boxes_ms = cuda_ms(lambda: DBB.db_boxes(prob, got[0], got[1], got[3], extent, dest, *bkw),
                       20)
    st, cnt = got[1].cpu().numpy(), got[3].cpu().numpy()
    box_px = int(sum(int(st[i, k, 4]) * int(st[i, k, 5]) for i in range(len(cnt))
                     for k in range(int(cnt[i]))))
    ext = extent.cpu().numpy()
    pixels = int((ext[:, 0] * ext[:, 1]).sum())
    times = {"ccl_label_ms": ccl_ms,
             "ccl_bound_ms": pixels * (4 + 4) / HBM_BYTES_PER_S * 1e3,
             "db_boxes_ms": boxes_ms,
             "db_boxes_bound_ms": (box_px * 8 + int(cnt.sum()) * 64) / HBM_BYTES_PER_S * 1e3,
             "pixels": pixels, "box_pixels": box_px, "taken": int(cnt.sum()),
             "dcn_ms": sum(s["ms"] for s in sites),
             "dcn_bound_ms": sum(s["bound_ms"] for s in sites),
             "dcn_plain_ms": sum(s["plain_ms"] for s in sites), "peak_bytes": int(peak)}
    log("  DB kernels at (32, 736x1312): " + json.dumps(times))
    return {"counts": {k: [float(np.mean(v)), max(v), min(v)] for k, v in counts.items()},
            "times": times, "slot_differences": slot_diff, "sites": sites}


# ------------------------------------------------------ residual_epilogue


def check_residual_epilogue_kernel(dev) -> dict:
    """The residual epilogue against its plain version (PyTorch's passes on
    the card), bit for bit, on made-up maps with -0.0, NaN and infinities
    among the values, with and without each bias, and on adds that round
    at a tie."""
    from ctpn_tpu_torch.ops import residual_epilogue as RE

    rng = np.random.RandomState(29)
    cases = [((2, 256, 23, 41), True, True), ((2, 512, 12, 21), True, False),
             ((2, 1024, 6, 11), False, True), ((2, 2048, 3, 6), False, False),
             ((3, 24, 9, 13), True, True), ((1, 8, 1, 1), True, False)]
    with torch.inference_mode():
        for shape, with_b, with_bi in cases:
            y, idt = edge_values(rng, shape, dev), edge_values(rng, shape, dev)
            b = edge_values(rng, (shape[1],), dev) if with_b else None
            bi = edge_values(rng, (shape[1],), dev) if with_bi else None
            got = RE.residual_epilogue(y, b, idt, bi)
            if not (got.is_contiguous(memory_format=torch.channels_last)
                    and torch.equal(bits_of(got), bits_of(RE.residual_epilogue_ref(
                        y, b, idt, bi)))):
                raise AssertionError(f"residual_epilogue {shape} biases {with_b, with_bi} "
                                     "differs from the plain version")
        # ties: 1 + 2**-8 and (1 + 2**-7) + 2**-8 round to even
        halves = torch.tensor([1.0, 1.0 + 2 ** -7] * 4).view(1, 8, 1, 1)
        y = halves.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b = torch.full((8,), 2 ** -8, dtype=torch.bfloat16, device=dev)
        got = RE.residual_epilogue(y, b, y, b)
        if not torch.equal(bits_of(got), bits_of(RE.residual_epilogue_ref(y, b, y, b))):
            raise AssertionError("residual_epilogue: a tie rounds otherwise than PyTorch's add")
    log(f"  residual_epilogue on {len(cases) + 1} made-up cases (edge values, each bias on "
        "and off, ties): equal to the plain version bit for bit")
    return {"name": "residual_epilogue", "cases": len(cases) + 1, "equal": True}


def check_residual_epilogue_sites(model, xs) -> list:
    """The op at each of DB's 16 bottlenecks on the batch ``xs``
    (normalised) through ``model``'s trunk: its output against the plain version
    on the same inputs and against the block's tail as PyTorch ran it
    before the op (conv3 and the projection with their biases, the sum,
    ``F.relu``), bit for bit; then its ms, the launcher's alone, the plain
    passes' ms, and its byte bound (both maps and biases read, the output
    written, at 3.35 TB/s)."""
    from ctpn_tpu_torch.models import resnet
    from ctpn_tpu_torch.ops import residual_epilogue as RE

    real, current, sites = resnet.residual_epilogue, {}, []

    def checked(y, b, idt, bi):
        got = real(y, b, idt, bi)
        block, x, out = current["block"], current["x"], current["out"]
        ds = block.downsample
        before = F.relu(block.conv3(out) + (x if ds is None else ds(x)))
        same = (torch.equal(bits_of(got), bits_of(RE.residual_epilogue_ref(y, b, idt, bi)))
                and torch.equal(bits_of(got), bits_of(before)))
        del before
        nbytes = 2 * (y.numel() + idt.numel() + got.numel()) + sum(
            2 * t.numel() for t in (b, bi) if t is not None)
        ms = cuda_ms(lambda: real(y, b, idt, bi), 20)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        sites.append({"shape": list(y.shape), "projection": ds is not None, "equal": same,
                      "ms": ms, "launcher_ms": launch_ms(RE, y, b, idt, bi),
                      "plain_ms": cuda_ms(lambda: RE.residual_epilogue_ref(y, b, idt, bi), 5),
                      "bound_ms": bound, "bound_pct": 100 * bound / ms, "bytes": nbytes})
        return got

    def at_block(block, args):
        current.update(block=block, x=args[0])

    def at_conv3(conv, args):
        current["out"] = args[0]

    blocks = [b for b in model.modules() if isinstance(b, resnet.Bottleneck)]
    hooks = [b.register_forward_pre_hook(at_block) for b in blocks]
    hooks += [b.conv3.register_forward_pre_hook(at_conv3) for b in blocks]
    resnet.residual_epilogue = checked
    try:
        with torch.inference_mode():
            model.trunk(xs)
        torch.cuda.synchronize()
    finally:
        resnet.residual_epilogue = real
        for h in hooks:
            h.remove()
        current.clear()
    for k, s in enumerate(sites, start=1):
        log(f"  residual_epilogue block {k} {tuple(s['shape'])}"
            f"{' projection' if s['projection'] else ''}: "
            f"{'equal' if s['equal'] else 'DIFFERS'}; {s['ms']:.4f} ms ({s['launcher_ms']:.4f} "
            f"launcher), bound {s['bound_ms']:.4f} ({s['bound_pct']:.1f} %), plain "
            f"{s['plain_ms']:.4f}")
    if len(sites) != DB_BLOCKS:
        raise AssertionError(f"DB: {len(sites)} residual epilogues (want {DB_BLOCKS})")
    bad = [k for k, s in enumerate(sites, start=1) if not s["equal"]]
    if bad:
        raise AssertionError(f"residual_epilogue differs from the passes at blocks {bad}")
    return sites


def drive_residual_epilogue(dev, artifact: Path = DB_ARTIFACT) -> dict:
    """Phase 29: the kernel on made-up cases; then at DB's 16 bottlenecks
    on the cell's renders at its batch and shape; 16 launches per replayed
    DB program run over 5 replays; none with gradients on."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, craft_normalised
    from ctpn_tpu_torch.ops import residual_epilogue as RE
    from ctpn_tpu_torch.utils.weights import load_params

    entry = check_residual_epilogue_kernel(dev)
    db_cfg()
    pred = CTPNPredictor(load_params(str(artifact), device=dev), device=dev)
    data, infos = db_batch(pred)
    x, info = torch.from_numpy(data).to(dev), torch.from_numpy(infos).to(dev)
    sites = check_residual_epilogue_sites(pred.model, craft_normalised(x))
    total = {k: sum(s[k] for s in sites) for k in ("ms", "bound_ms", "plain_ms", "bytes")}
    log(f"  residual_epilogue, {DB_BLOCKS} blocks per batch of {DB_BATCH}: {total['ms']:.4f} "
        f"ms, bound {total['bound_ms']:.4f} ({100 * total['bound_ms'] / total['ms']:.1f} %, "
        f"{total['bytes'] / total['ms'] / 1e9:.3f} TB/s), plain {total['plain_ms']:.4f}")
    pred.graphs(x, info)
    pred.graphs(x, info)  # the capture, then the first replay
    torch.cuda.synchronize()
    zero_launch_counts()
    for _ in range(5):
        pred.graphs(x, info)
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {k: 5 * v for k, v in DB_LAUNCHES.items()},
                    "DB, 5 replayed runs")
    zero_launch_counts()
    with torch.enable_grad():  # training runs the plain passes
        pred.model.trunk(craft_normalised(x[:2]))
    torch.cuda.synchronize()
    if RE.residual_epilogue.LAUNCHES:
        raise AssertionError("DB's trunk with gradients on launched residual_epilogue")
    log("  residual_epilogue: 16 launches per replayed DB run over 5 runs, none with "
        "gradients on")
    del pred, x, info
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernel": entry, "sites": sites, "total": total}


# ---------------------------------------------------------- resize_concat


def check_resize_concat_kernel(dev) -> dict:
    """The resize-and-concatenate kernel against its plain version, bit for
    bit, on made-up maps with -0.0, NaN and infinities among the values."""
    from ctpn_tpu_torch.ops import resize_concat as RC

    rng = np.random.RandomState(27)
    cases = [  # (n, c1, h, w), (c2, H, W)
        ((4, 64, 19, 29), (32, 38, 57)), ((4, 64, 37, 57), (32, 75, 113)),
        ((2, 24, 37, 57), (8, 75, 113)), ((2, 16, 75, 113), (8, 37, 57)),
        ((3, 8, 1, 1), (16, 9, 13)), ((2, 512, 23, 40), (512, 46, 80)),
        ((2, 1024, 46, 80), (512, 46, 80)), ((2, 64, 184, 320), (128, 368, 640)),
        ((1, 8, 5, 7), (8, 5, 7)),
    ]
    for (n, c1, h, w), (c2, hh, ww) in cases:
        x = edge_values(rng, (n, c1, h, w), dev)
        skip = edge_values(rng, (n, c2, hh, ww), dev)
        got = RC.resize_concat(x, skip)
        want = RC.resize_concat_ref(x, skip)
        if not (got.shape == want.shape and torch.equal(bits_of(got), bits_of(want))):
            raise AssertionError(f"resize_concat {(n, c1, h, w)} to {(c2, hh, ww)} differs "
                                 "from the plain version")
        if not got.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError("resize_concat's output is not channels_last")
    log(f"  resize_concat on {len(cases)} made-up cases (edge values, uneven ratios, a "
        "shrink, equal sizes): equal to the plain version bit for bit")
    return {"name": "resize_concat", "cases": len(cases), "equal": True}


def check_resize_concat_sites(run, what: str, want: int) -> list:
    """Every call of the op while ``run()`` runs a model: each checked
    against the plain version bit for bit as the model makes it, then
    timed on its own inputs (the op, its launcher alone, the plain passes)
    beside its byte bound."""
    from ctpn_tpu_torch.models import vgg
    from ctpn_tpu_torch.ops import resize_concat as RC

    calls, real = [], vgg.resize_concat

    def checked(h, skip):
        got = real(h, skip)
        want_ = RC.resize_concat_ref(h, skip)
        calls.append((h, skip, got.shape == want_.shape
                      and torch.equal(bits_of(got), bits_of(want_))))
        return got

    vgg.resize_concat = checked
    try:
        with torch.inference_mode():
            run()
        torch.cuda.synchronize()
    finally:
        vgg.resize_concat = real
    sites = []
    for h, skip, equal in calls:
        out_bytes = h.shape[0] * (h.shape[1] + skip.shape[1]) * skip.shape[2] * skip.shape[3] * 2
        bound = (h.numel() * 2 + skip.numel() * 2 + out_bytes) / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(lambda: real(h, skip), 20)
        sites.append({"h": list(h.shape), "skip": list(skip.shape), "equal": bool(equal),
                      "ms": ms, "launcher_ms": launch_ms(RC, h, skip), "bound_ms": bound,
                      "bound_pct": 100 * bound / ms,
                      "plain_ms": cuda_ms(lambda: RC.resize_concat_ref(h, skip), 20)})
    del calls
    for s in sites:
        log(f"  resize_concat at {what}'s {tuple(s['h'])} + {tuple(s['skip'])}: "
            f"{'equal' if s['equal'] else 'DIFFERS'}; {s['ms']:.4f} ms ({s['launcher_ms']:.4f} "
            f"launcher), bound {s['bound_ms']:.4f} ({s['bound_pct']:.1f} %), plain "
            f"{s['plain_ms']:.4f}")
    if len(sites) != want:
        raise AssertionError(f"{what}: {len(sites)} resize_concat sites (want {want})")
    bad = [(s["h"], s["skip"]) for s in sites if not s["equal"]]
    if bad:
        raise AssertionError(f"resize_concat differs from its plain version at {what}'s {bad}")
    return sites


def drive_resize_concat(dev) -> dict:
    """Phase 27: the kernel on made-up cases, then at every call site of
    EAST's and CRAFT's cells on their own renders at their batch and shape,
    and no launch with gradients on."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, craft_normalised, mean_subtracted
    from ctpn_tpu_torch.ops import resize_concat as RC
    from ctpn_tpu_torch.utils.weights import load_params

    entry = check_resize_concat_kernel(dev)
    result = {"kernel": entry}
    for name, cfg_fn, artifact, want in (("EAST", east_cfg, EAST_ARTIFACT, 3),
                                         ("CRAFT", craft_cfg, CRAFT_ARTIFACT, 4)):
        cfg_fn()
        pred = CTPNPredictor(load_params(str(artifact), device=dev), device=dev)
        m = pred.model
        if name == "EAST":
            data, _ = east_batch()
            xs = mean_subtracted(torch.from_numpy(data).to(dev))
            run = lambda: m.merge(m.trunk_taps(xs))  # noqa: E731
        else:
            data, _ = craft_batch(pred)
            xs = craft_normalised(torch.from_numpy(data).to(dev))
            run = lambda: m.decoder(m.trunk_taps(xs))  # noqa: E731
        result[name] = check_resize_concat_sites(run, name, want)
        total = {k: sum(s[k] for s in result[name]) for k in ("ms", "bound_ms", "plain_ms")}
        log(f"  resize_concat, {name}'s {want} sites per batch of {xs.shape[0]}: "
            f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f}, plain {total['plain_ms']:.4f}")
        zero_launch_counts()
        with torch.enable_grad():  # training runs the plain passes
            run_grad = m.maps if name == "CRAFT" else m.merge
            run_grad(m.trunk_taps(xs[:2]))
        torch.cuda.synchronize()
        if RC.resize_concat.LAUNCHES:
            raise AssertionError(f"{name} with gradients on launched resize_concat")
        del pred, m, xs, run
        gc.collect()
        torch.cuda.empty_cache()
    return result


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ctpn_tpu_torch.ops import _build, _kernel

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1/24] device: {torch.cuda.get_device_name(0)} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build(_kernel.sources() + ["stage_clock"])
    log(f"[2/24] build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            # registers, shared memory, spills, and ptxas's performance
            # notes (C75xx: e.g. wgmma serialized)
            if any(k in line for k in ("registers", "smem", "spill", "(C75")):
                log(f"  {name}: {line.strip()}")

    if "--craft" in argv:
        log("[26/26] CRAFT: the labelling and box kernels, the captured program at "
            "(32, 736x1280)")
        entries = check_craft_kernels(dev)
        craft = drive_craft(dev) if CRAFT_ARTIFACT.exists() else None
        print(json.dumps({"kernels": entries, "craft": craft}))
        print(card)
        return 0

    if "--db" in argv:
        log("[28/28] DB: the deformable conv, 8-connected labelling and box kernels, the "
            "captured program at (32, 736x1312)")
        entries = check_db_kernels(dev) + check_craft_kernels(dev)
        db = drive_db(dev) if DB_ARTIFACT.exists() else None
        print(json.dumps({"kernels": entries, "db": db}))
        print(card)
        return 0

    if "--residual" in argv:
        log("[29/29] residual_epilogue: made-up cases, DB's 16 bottlenecks at "
            "(32, 736x1312), the launch gates")
        print(json.dumps({"residual_epilogue": drive_residual_epilogue(dev)}))
        print(card)
        return 0

    if "--resize-concat" in argv:
        log("[27/27] resize_concat: made-up cases, every call site of EAST and CRAFT at "
            "(32, 736x1280)")
        print(json.dumps({"resize_concat": drive_resize_concat(dev)}))
        print(card)
        return 0

    if "--east" in argv:
        log("[25/25] EAST: the walk and quad bitmask kernels, the captured program at "
            "(32, 736x1280)")
        entries = check_east_kernels(dev)
        east = drive_east(dev)
        print(json.dumps({"kernels": entries, "east": east}))
        print(card)
        return 0

    log("[3/24] kernels against their plain versions")
    entries = [check_nms_kernel(dev), check_bitmask_kernel(dev), check_stem_kernel(dev),
               check_resolve_kernel(dev), check_conv_epilogue_kernel(dev)]
    calls = connector_calls(dev)
    entries += [check_chain_walk_kernel(dev, calls), check_successors_kernel(dev, calls)]
    del calls
    torch.cuda.empty_cache()
    if "--kernels-only" in argv:
        print(json.dumps({"kernels": entries}))
        print(card)
        return 0

    log("[4/24] main path (default config)")
    default_recs = drive_main_path(dev, entries[0], entries[4], entries[5], entries[6])

    log("[5/24] serving path (TPU.NMS_FUSED False, TPU.FUSED_STEM True)")
    drive_serving_path(dev, entries[1], entries[3], entries[2], default_recs)
    for entry in entries:
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']} was never launched on its path")

    log("[6/24] serve CLI")
    check_cli()

    shutil.rmtree(OUT, ignore_errors=True)
    try:
        log("[7/24] O mode")
        drive_o_mode(dev)

        log("[8/24] host post-processing (detect_image_host, H and O)")
        drive_host_path(dev)

        log("[9/24] frozen artifacts (default and served routes)")
        frozen = drive_frozen(dev)

        log("[10/24] CLIs: demo, eval, export --frozen, demo --frozen, serve frozen")
        check_clis(frozen)
    finally:
        shutil.rmtree(OUT, ignore_errors=True)

    log("[11/24] training: one step on the card against the CPU")
    zero_launch_counts()
    t0 = time.perf_counter()
    train = {"parity": check_train_parity(dev)}
    seconds = {"parity": time.perf_counter() - t0}
    log("[12/24] training: full-width steps at 608x912, batch 1 and 2, REMAT off and "
        "on, eager and replayed")
    t0 = time.perf_counter()
    train["steps"] = full_size_steps(dev)
    seconds["steps"] = time.perf_counter() - t0
    expect_launches(launch_counts(), {}, "training phases 11-12")
    log("[13/24] training: data, overfit, train, restore, export --ckpt, demo")
    t0 = time.perf_counter()
    try:
        train["entry_points"] = drive_training_entry_points(dev)
    finally:
        shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    seconds["entry_points"] = time.perf_counter() - t0
    train["seconds"] = seconds
    log("  train " + json.dumps(train))

    log("[14/24] training quality: synthetic fine-tune, holdout before and after; "
        "native host ops")
    t0 = time.perf_counter()
    try:
        quality = {"native": check_native_host_ops(),
                   "train_synth": drive_train_synth()}
    finally:
        shutil.rmtree(SYNTH_ROOT, ignore_errors=True)
    quality["seconds"] = time.perf_counter() - t0
    log("  quality " + json.dumps(quality))

    log("[15/24] multi-card: DP training, DP detection on both routes, DP frozen "
        "artifact (every visible card)")
    zero_launch_counts()
    t0 = time.perf_counter()
    drive_multicard()
    log(f"  multi-card phase {time.perf_counter() - t0:.1f} s")

    log("[16/24] captured programs: default route, served route, O mode, frozen "
        "default route (CUDA graphs replayed against the eager program)")
    t0 = time.perf_counter()
    captured = drive_captured(dev)
    captured["stage clock"] = check_stage_clock(dev)
    log(f"  captured-program phase {time.perf_counter() - t0:.1f} s")

    zero_launch_counts()
    log("[17/24] captured training: three replayed steps against three eager "
        "steps (2x256x384, f32)")
    t0 = time.perf_counter()
    check_captured_parity(dev)
    log("[18/24] captured training at 608x912, batch 1, 2 and 8, REMAT off and on: "
        "eager against replayed, host syncs an error")
    time_captured_steps(dev)
    expect_launches(launch_counts(), {}, "captured training, phases 17-18")
    log(f"  captured-training phases {time.perf_counter() - t0:.1f} s")

    log("[19/24] card against CPU: detect_image on the photos in float32, TF32 off "
        "(ROADMAP D1); bf16 against it, reported")
    t0 = time.perf_counter()
    check_card_against_cpu(dev, default_recs)
    log(f"  card-against-CPU phase {time.perf_counter() - t0:.1f} s")

    log("[20/24] load: the three load scripts (HTTP on both routes, the batcher, "
        "streaming), records under load against direct runs, a cold bucket under load")
    t0 = time.perf_counter()
    drive_load(dev, card)
    log(f"  load phase {time.perf_counter() - t0:.1f} s")

    log("[22/24] orbax artifacts: the JAX package's directories read without JAX, "
        "the port's written, detection on orbax-read weights, serve on a directory")
    t0 = time.perf_counter()
    try:
        drive_orbax(dev, default_recs, card)
    finally:
        shutil.rmtree(ORBAX_OUT, ignore_errors=True)
    log(f"  orbax phase {time.perf_counter() - t0:.1f} s")

    log("[23/24] slot independence: every bucket, default and served routes and O "
        "mode, batch 8 and 16, an image's raw records in the first and last slots")
    t0 = time.perf_counter()
    drive_slot_buckets(dev, card)
    log(f"  slot phase {time.perf_counter() - t0:.1f} s")

    log("[24/24] bench_torch.py on the default and served routes (subprocess, batch 48, "
        "replays on a batch already on the card)")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # this process's cached blocks, for the child
    drive_bench(torch.cuda.get_device_name(0), captured)
    log(f"  bench phase {time.perf_counter() - t0:.1f} s")

    log("[25/25] EAST: the walk and quad bitmask kernels, the captured program at "
        "(32, 736x1280)")
    t0 = time.perf_counter()
    zero_launch_counts()
    entries += check_east_kernels(dev)
    east = drive_east(dev)
    log(f"  EAST phase {time.perf_counter() - t0:.1f} s")

    log("[26/26] CRAFT: the labelling and box kernels, the captured program at "
        "(32, 736x1280)")
    t0 = time.perf_counter()
    zero_launch_counts()
    entries += check_craft_kernels(dev)
    craft = drive_craft(dev)
    log(f"  CRAFT phase {time.perf_counter() - t0:.1f} s")

    log("[27/27] resize_concat: made-up cases, every call site of EAST and CRAFT at "
        "(32, 736x1280)")
    t0 = time.perf_counter()
    zero_launch_counts()
    resize = drive_resize_concat(dev)
    entries.append(resize["kernel"])
    log(f"  resize_concat phase {time.perf_counter() - t0:.1f} s")

    log("[28/28] DB: the deformable conv, 8-connected labelling and box kernels, the "
        "captured program at (32, 736x1312)")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    zero_launch_counts()
    entries += check_db_kernels(dev)
    db = drive_db(dev)
    log(f"  DB phase {time.perf_counter() - t0:.1f} s")

    log("[29/29] residual_epilogue: made-up cases, DB's 16 bottlenecks at "
        "(32, 736x1312), the launch gates")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    residual = drive_residual_epilogue(dev)
    entries.append(residual["kernel"])
    log(f"  residual_epilogue phase {time.perf_counter() - t0:.1f} s")

    log(f"[21/24] result (all phases {time.perf_counter() - t_start:.1f} s)")
    print(json.dumps({"kernels": entries, "east": east, "craft": craft,
                      "resize_concat": resize, "db": db, "residual_epilogue": residual}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
