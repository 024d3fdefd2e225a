#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives only ``oncilla_tpu_torch`` (no JAX), in phases; any failure exits
nonzero with a traceback and nothing ``ok`` is printed after it:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — builds the CUDA kernels from ``oncilla_tpu_torch/csrc``.
3. kernels — each copy kernel (write_rows, read_rows, local_copy) against
   its plain PyTorch version, byte for byte, at 4 KiB .. 1 GiB + 4 KiB
   (sizes that end on a bulk copy's short last tile) at offsets above 4 GiB
   of a 16 GiB arena and off the 32 KiB tile grid; then, at one KV page and
   at 1 GiB, times the way callers meet them
   (``oncilla_tpu_torch/benchmarks/kernel_times``): ``ms`` from CUDA events
   over calls that rotate over 8 extents a side at one page, so the L2 is
   cold (the median of 20 windows of 4 passes, ``issue_us`` the
   host's issue time a call in them), ``device_ms`` from ``torch.profiler``
   over the same calls, ``host_us`` the wrapper's issue time at 4 KiB; the
   plain version and one PyTorch ``copy_`` on the same extents, beside the
   bound 2*nbytes / datasheet HBM rate.
3a. attention — the paged decode attention kernel (``ops/attn.py``) at the
   Mixtral decode cell's widths (32 rows, 8 KV heads of 4 query heads,
   head size 128, bf16; contexts of 1,152 and 2,304 keys plus 64 tail
   slots of a 128-slot tail) against its plain version (output and the
   written tail slot); ``ms`` from CUDA events over back-to-back calls,
   ``device_ms`` the ``torch.profiler`` device time of its kernels a call,
   ``bound_ms`` the valid K/V bytes over the datasheet HBM rate,
   ``plain_ms`` the plain version, ``library_ms`` PyTorch's
   ``scaled_dot_product_attention`` over the concatenated K/V with the same
   mask (a yardstick the port never calls).
4. ocm_test loop — ``ocm_init`` on a 16 GiB device arena: alloc, put, get,
   copy and free at 4 KiB .. 1 GiB on LOCAL_DEVICE and LOCAL_HOST, the copy
   matrix, scrub-on-free, the typed errors, the alloc p50; the kernels'
   launch counters must rise.
5. serving — Llama-3-8B geometry (bf16, seeded random weights on the card):
   2 paged-decode requests through ``BucketedPagedDecoder`` (LOCAL_DEVICE
   pages of 128 tokens, refetch), each 256 teacher-forced prompt tokens
   then 128 greedy tokens; launch counts must show every page put and
   every page re-read went through the kernels; logits and greedy tokens
   are held against the unpaged ``decode_step``; tokens/s of the plain,
   device, host, device_fused and fused modes of the kv_decode harness
   (the fused modes replay one CUDA-graph token step); one
   ``torch.profiler`` window of paged decode (device busy share, kernel
   time by name).
5b. engine — the serving engine (``oncilla_tpu_torch.serving``) on the
   same weights: six requests (a 100-token shared prefix, 12-token
   suffixes, t0 and t1 identical, 32 new tokens each) over 16-token pages
   of 2 MiB in a tiered store (8 HOT, 8 WARM, COLD the host stand-in),
   five runs: A interleaved eager, B batched eager, C batched with CUDA
   graphs, D as C with every page HOT (A-D fault off-card pages without
   prefetch workers, so B, C and D seat the same batches), and E the
   engine as shipped (graphed, two prefetch workers, yield-on-cold
   seating). Checks: C's tokens and the first step of each shape bucket
   equal B's bit for bit; D's tokens C's; t0's continuation t1's bit for
   bit in A-D; B's tokens A's, and in E t1's t0's, wherever the reference's
   top-2 margin exceeds twice their largest logit difference (the margin
   rule: that difference at most 0.25, a quarter of the rows held at
   least); page moves, prefix hits, a CoW adoption and
   batches of 2+ in B, C and E, E's prefetcher threaded; and every HOT
   page put and get one launch of ``write_rows``/``read_rows``.
6. fabric — the one-sided device fabric on a 4-row ``SpmdIciPlane`` whose
   rows (2 GiB - 4 KiB each, the largest the JAX plane allows) all lie on
   the one card: the one-sided copy K4 against its plain version, byte for
   byte, across rows up to 1 GiB + 4 KiB, within a row (local fast path)
   and as a ``force_remote`` loopback up to 512 MiB, with extents touching
   a row's last block and every other byte of the fabric checked unchanged,
   timed at one cold page and at 1 GiB as phase 3 times K1-K3; then
   REMOTE_DEVICE handles placed by two of the port's daemons (two rows a
   rank, their device arenas the rows; put/get/copy through the plane,
   ``Ocm.copy`` riding K4 with no get) and ``ring_shift`` both ways; then
   ``copy_bench`` at ``bench.py``'s sizes (its JSON line; its segment checks
   must pass), and the copy loops K9 and K10 against their plain loops at 3
   iterations.
7. bench — ``bench.py``'s measurement path at the JAX ceiling probes' sizes:
   the read stream K6 over 256 MiB (the buffer unchanged, the sum of the
   bytes it landed equal to the buffer's), the copy streams K7 at 1/2/4/8
   streams and the staged copy K8 at 2 and 3 iterations on 128 MiB, byte
   for byte against their plain versions; then ``ceiling_probe()`` at its
   defaults and the port's ``benchmarks/bench.run`` (copy legs, ceiling,
   gb_sweep over a 2 GiB + 256 MiB arena up to 1 GiB with the amortized
   leg, the wire legs early, the mfu legs, GUPS, the serving harness in a
   subprocess on the card, kv_decode, the wire legs again), their JSON
   lines and the grader's rows (``benchmarks/check``); ``detail.errors``
   must be empty, every ceiling leg must be measured, rows 1-3
   must not read NO DATA, rows 4 (mfu_train) and 5 (device_fused against
   plain) must be graded, row 6 (the wire legs, ``detail.dcn`` verified on
   the native daemons) must pass, ``detail.mfu`` and ``detail.mfu_train``
   must be above 0 with a train variant measured (all eight of
   ``benchmarks/mfu.train_variants``), GUPS must conserve its updates and
   the serving harness's chaos and warm-boot legs be byte-exact.
8. wire — the daemon client (``oncilla_tpu_torch.runtime``), run after
   phase 5b while the weights are on the card: two daemons of the port's
   own copy of the native daemon (built with the C++ compiler, one compile
   per unit at once) on loopback, two rows each of a 4-row plane of 256 MiB
   rows on the card, rank 1's host arena 2 GiB + 256 MiB; the app is
   ``ocm_init(OcmConfig(nodefile=..., rank=0), ici_plane=plane)``. (a)
   REMOTE_HOST at 4 KiB .. 1 GiB lands on rank 1, put from a card tensor and
   got back byte-equal (whole, at offsets, into card and pinned buffers),
   live in rank 1's STATUS until freed; (a2) two threads of the app put
   and get 16 MiB card tensors at once, byte-equal, each transfer on a
   staging buffer of its own; (b) the copy matrix of the four
   kinds at one KV page, byte for byte, with K1/K2 launches on the
   LOCAL_DEVICE legs and K4 (no get) on REMOTE_DEVICE -> REMOTE_DEVICE; (c)
   daemon-placed REMOTE_DEVICE handles on rank 1 read as zeros, and a
   plane-less CPU process writes and reads one through the daemons' relay
   while the controller reads those bytes on the card; (d) the typed errors
   (bounds, double free, an alloc past rank 1's arena, use after tini); (e)
   serving runs F and G, runs E and C with their COLD tier on rank 1 behind
   a client that declares PRIO_LOW, and 2 WARM pages so that pages reach
   it: G's tokens equal C's bit for bit (the
   same seating), F's E's and F's t1 its t0 by the margin rule (E and F
   seat by their workers' timing), every COLD page read back over the wire
   the bytes put (a host copy kept beside the client), ``cold_sim`` False, COLD puts/gets equal the
   client's wire transfers, HOT puts/gets the K1/K2 launches, every daemon
   drained; (f) the C client library (``runtime/cluster.build_lib``,
   ``libocm_tpu.so`` and ``ocm_c_demo`` built from the checkout's sources
   with g++ and gcc), after the app's tini, behind a controller at rank 0
   whose ``IciDataPlane`` has the same 4 rows: the demo app runs its three
   journeys on REMOTE_DEVICE at 16 MiB as a process of its own holding no
   card, then this process drives the library through ctypes at rank 1:
   128 MiB of seeded bytes put into a daemon-placed REMOTE_DEVICE handle,
   the controller's ``ctx.get`` on the card row and the library's
   ``ocmc_get`` both equal to them, and K1/K2 launches equal to the
   ``PLANE_PUT``/``PLANE_GET`` ops the plane server served (the count
   ``launches_libocm``). It prints REMOTE_HOST put/get GB/s at one page and
   1 GiB from/to card and pinned tensors (median of 5) beside a pinned
   host -> card ``copy_``, alloc/free p50 through the daemons, F's and G's
   tokens/s beside E's and C's, and the C library's relayed put/get GB/s
   at 16 and 128 MiB beside a plane-less Python client's on the same
   handle and check (c)'s second process.
8b. daemons_py — the port's Python daemons (``python -m
   oncilla_tpu_torch.runtime.daemon``), right after phase 8 while the
   weights are on the card. On two of them, sized as phase 8's pair: (a)
   REMOTE_HOST of card tensors at 4 KiB, one page, 256 MiB and 1 GiB byte
   for byte, GB/s at one page and 1 GiB (median of 5) and alloc/free p50
   over 200, beside phase 8's native figures; (b) a daemon-placed
   REMOTE_DEVICE page through the app's ``IciDataPlane`` and a plane-less
   second process whose put and get the daemons relay: bytes equal, K1/K2
   launches exactly the relayed puts and gets; then a copy between two
   such handles on a ``SpmdIciPlane``: one K4 launch, bytes equal; (c)
   one request of 256 teacher-forced and 32 greedy tokens through
   ``BucketedPagedDecoder`` at Llama-3-8B width (128-token pages,
   refetch), with REMOTE_DEVICE pages and with REMOTE_HOST pages: logits
   and tokens equal the unpaged ``decode_step`` bit for bit, one K1 launch
   a REMOTE_DEVICE page stored and one K2 a page fetched, tokens/s for
   each. On three, with standby masters, hash placement, 2 replicas and a
   fast detector: (d) 16 REMOTE_HOST handles of 2 MiB, replicated by the
   client (``OcmConfig(replicas=2)``), put from card tensors, the leader
   SIGKILLed, ranks 1 and 2 agree on its successor at a higher epoch within
   a stated budget (the election time printed), new allocations land, every
   handle reads back byte for byte through ``ctx.get`` (a dead primary's by
   the client's failover to its promoted replica, which the handle then
   names); (e) a PRIO_LOW client's CONNECT is granted
   FLAG_CAP_QOS and its profile shows in STATUS, where the native daemon
   declines; (f) no daemon pid is among ``nvidia-smi``'s compute apps, and
   no daemon holds the card's device nodes open (this process, which holds
   a context, is the positive control).
8c. client — the client halves of the daemons' features, right after 8b
   while the weights are on the card. On two Python daemons sized as 8b's
   pair, serving the shm fabric: (a) an ``OCM_MUX=1`` app puts and gets
   REMOTE_HOST card tensors at 4 KiB, a page, 256 MiB and 1 GiB, whole and
   at offsets, byte for byte; GB/s at a page and 1 GiB (median of 5) and
   alloc/free p50 over 200 beside a blocking client's; 64 tenants in this
   process hold one channel a peer; AsyncOcm's 32 concurrent 2 MiB gets,
   their aggregate GB/s, every page checked; a mux client against two
   native daemons runs lockstep, byte for byte; (b) an ``OCM_FABRIC=shm``
   app selects shm (its fabric map, the daemon's STATUS counters), 1 GiB of
   card tensors byte for byte with GB/s beside (a)'s tcp, ACK coalescing
   granted on tcp and the tuner's plan printed; (e) runs H (E's settings)
   and I (C's) with the COLD tier on rank 1 behind a PRIO_LOW mux client, 2
   WARM pages: H's prefetcher async, every COLD page of the sync and the
   AsyncOcm leg the bytes put, I's tokens C's bit for bit, H's E's by the
   margin rule, HOT puts/gets the K1/K2 launches, tokens/s beside C, E, F,
   G. On three with 8b (d)'s control plane, the app with ``replicas=2`` and
   ``OCM_HEDGE_MS=25``: (d) a handle's primary SIGSTOPped, a get returns
   byte for byte from the replica with the handle unchanged (its time
   printed), a put with ``deadline_ms=400`` raises ``OcmDeadlineExceeded``
   within its budget and 1.6 s, SIGCONT; (c) that primary SIGKILLed, a put
   and a get on the handle work and its rank moves to the promoted replica,
   all 16 handles read back through ``ctx.get``.
8d. warmboot — the FROZEN tier and the engine's warm boot, right after 8c
   while the weights are on the card: six requests sharing a 256-token
   prefix (12-token suffixes, t0 and t1 identical, 32 new tokens) over
   16-token pages with run C's settings (batched, graphed, no prefetch
   workers), 8 HOT and 4 WARM pages, COLD the host stand-in, bounded at 8
   pages once a ``FrozenStore`` (in a temporary directory) is attached.
   Arms: ref (no frozen backend), seeded (its close persists the prefix
   trie), cold (a fresh context, no backend), warm0 and warm (fresh
   contexts over the seeded dir, whose ``__init__`` restores the trie;
   warm0 is the discarded warm-up pass that captures warm's graphs, as the
   JAX package's run_warmboot discards a jit-warm pass). Checks: seeded's
   and cold's tokens ref's bit for bit, warm's by the margin rule; the
   extents restored equal the ``prefix-`` keys persisted, each read back
   equal to its file; pages reached FROZEN in the seeded arm and every disk
   read is the bytes written; K1/K2 launches equal the HOT puts/gets in
   every arm; warm's prefix hit ratio above cold's and its mean TTFT below
   cold's; the seeded and warm arms audited clean by the port's flight
   recorder and auditor; then ``python -m oncilla_tpu_torch.persist
   --smoke`` exits 0. It prints TTFT, tokens/s, pages per tier and the
   disk bytes each way per arm.
8e. harness — the serving harness (``python -m oncilla_tpu_torch.serving``),
   right after 8d while the weights are on the card: (a) its paired cells
   (``_run_cell`` without, then with, prefix sharing) on the Llama-3-8B
   weights, the fleet of its measured cell (6 tenants of 32 prompt tokens,
   t0 and t1 identical, 16 new tokens, 8-token pages, 4 HOT and 6 WARM
   pages, no prefetch workers), COLD on 3 in-process daemons with 2
   replicas and host arenas for every page twice: prefix hits and a CoW
   adoption, fewer remote bytes shared, pages demoted and promoted, t0's
   tokens t1's bit for bit, shared's tokens noshare's bit for bit or by the
   margin rule, every rank drained, K1/K2 launches equal to each cell's HOT
   puts/gets; (b) ``python -m oncilla_tpu_torch.serving --smoke`` exits 0
   on the card (the tiny float32 model: every token assertion, the mux
   leg, the chaos leg and the warm boot's TTFT held as written); (c) GUPS
   over a handle's extent at a 16 MiB table (inside the L2) and a 1 GiB one,
   updates conserved.
8f. observed — the serving path observed, right after 8e while the weights
   are on the card: 8e (a)'s two cells again, in its order, on a fresh
   cluster of its settings, with the journal and the flight recorder on, the
   SLO watcher (``Ocm.start_slo``, a scrape every 0.5 s) on the app's
   control plane and the shared cell inside ``utils/debug.capture_trace``
   (``torch.profiler``, CPU and CUDA); the shared cell moves no byte over
   the wire, the noshare cell's COLD pages do: (a) each cell's tokens 8e's
   bit for bit or by the margin rule, t0's t1's, K1/K2 launches the HOT
   puts/gets; (b) the SLO block has 3
   evaluations, no fetch error, and the serving objectives saw traffic
   (every verdict printed, none held green); (c) ``Ocm.export_trace``: 3
   tracks, a cross-track flow, spans of the page path; (d) ``python -m
   oncilla_tpu_torch.obs critpath <flight-recorder dir>
   --require-cross-rank`` exits 0; (e) the profiler trace holds one
   ``bulk_copy_kernel`` event per K1/K2/K3 launch of the shared cell, each
   launched inside an ``ocm:put``/``ocm:get`` range; (f) the obs CLI on the
   live cluster through a nodefile:
   the table with the engine's serving row, ``--prom 0`` with
   ``ocm_serving_ttft_seconds``, ``slo --json`` exiting as its verdict
   says; (g) observed against unobserved tokens/s, and K1's host issue time
   at 4 KiB with recording off against phase 3's; (h) the operator's CLIs,
   each CLI's ``main`` in turn in one process of their own, reniced ahead
   of other work, each returning 0 on its OK line: ``resilience --smoke``,
   ``--leader-smoke`` and ``--deadline-smoke``, ``obs --smoke``, ``obs slo
   --selftest``, ``elastic --smoke``, ``qos --smoke``, ``fabric --smoke``.
D. demo — the walkthrough (``python -m oncilla_tpu_torch.examples.demo``,
   the JAX package's ``examples/demo.py``) in this process on the card,
   right after 8f: its ``main(["--device", "cuda"])`` prints its three
   sections and "demo complete"; a 1 MiB LOCAL_DEVICE put and get and a
   device->host copy, a REMOTE_HOST put/get and a checkpoint on two
   in-process daemons, 3 train steps of ``LlamaConfig.tiny()`` and 24
   paged decode steps (the sliced ``.step()`` path, so no A1). Its K1/K2
   launches must be those predicted (``DEMO_LAUNCHES``) and no other
   kernel launched.

5m. moe — the MoE family on the serving path, right after D once the
   Llama weights are freed: ``MoeConfig.mixtral_8x7b()`` (dim 4096, 32
   heads, 8 KV heads, ffn 14336, 8 experts, top-2, capacity factor 1.25,
   vocab 32000, bf16) cut to 8 of its 32 layers (23.75 GB of seeded
   weights made on the card), one request of a 256-token seeded prompt and
   128 greedy tokens over 128-token pages of 4 MiB, REMOTE_DEVICE on two
   in-process daemons' rows: (a) unpaged ``moe.generate`` and the
   teacher-forced ``decode_loop``; (b) ``PagedDecoder`` and (c)
   ``BucketedPagedDecoder(refetch=True)`` with ``moe.paged_hooks``, their
   logits and tokens (a)'s bit for bit; (d) the same decoder's
   ``step_page`` eager, held to (a) by its rows (90 % of the tokens agree,
   the median row's logits within 0.25), and through ``StepGraphs``, the
   eager run's bit for bit with one graph a context bucket; K1/K2 launches
   the pages stored/fetched; tokens/s beside the dense dispatch's and a
   sparse top-2 gather's weight-byte bounds; the weights freed before
   phase 6.

9. train — last, with nothing of the earlier phases on the card: the JAX
   package's training flagship (``benchmarks/mfu.train_sized_config``:
   1.1B parameters, bf16, all 16 layers, batch 4 of 1024 tokens, ids drawn
   from a Zipf law). (a) 8 steps of ``models/train.make_train_step`` with
   ``adamw(3e-4, 0.01)`` on batches from ``utils/data.prefetch_to_device``:
   finite losses, the last below the first; (b) the whole train state
   (params, µ, ν, count) through ``models/checkpoint.save`` to LOCAL_DEVICE
   on a 16 GiB arena (one write_rows launch a save, read_rows on load, the
   loaded state equal bit for bit), to LOCAL_HOST, and the params alone to
   REMOTE_HOST on two of the port's daemons, each loaded back bit for bit
   with its GB/s; (c) one step from the restored state against one from the
   live state and (d) 2 ``offload_opt`` steps against 2 plain ones, both
   under ``torch.use_deterministic_algorithms``, equal bit for bit (the
   phase runs in a process of its own, whose ``CUBLAS_WORKSPACE_CONFIG``
   is set before its first product); (e) the median step
   ms, tokens/s and MFU against the datasheet bf16 rate, and one profiled
   step (device busy share, the kernels that take the most time); then, in
   the same process, (f) the MoE train step on a mesh of one at
   Mixtral-8x7B widths, 2 of 32 layers (``MoeConfig.mixtral_8x7b``, seeded
   weights), batch 4 of 1024: 8 steps (finite, falling losses), step ms,
   tokens/s and MFU by the dense dispatch's FLOPs (every expert's capacity
   slots; the active top-2 count beside it), one ``remat`` and one
   ``ce_block`` step against the plain step (loss within rtol 1e-3, each
   leaf's update within 20 % in norm), the state saved to LOCAL_DEVICE and
   loaded back bit for bit with one K1 and one K2 launch; (g) two steps of
   the dense step on ``make_mesh(1)`` against two one-device steps from the
   same state, bit for bit (the mesh adds nothing on one card)
   (``benchmarks/train_mesh.py``).

The last lines are one JSON object with every kernel's numbers (the
copy kernels and the attention kernel A1, each with its launches on every
main path, counted from 0 before the path and read after it; a kernel no
main path launched fails the script), the card's name and power limit, and
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --across-cards`` (two or more cards) runs phases 1-2
and phase 6's one-sided copies and handle path with the 4 rows on
different cards: the fabric's cross-card form, TMA bulk stores through
peer-mapped pointers over NVLink, byte-equal to the plain version and
timed cuda:0 -> cuda:1 beside it and ``copy_``; then phase 8's check (c)
with the plane's rows on those cards; then
``spmd_ring_sweep`` over those rows (every row sending to the next card at
once, 1 MiB .. 256 MiB), then ``gups_mesh`` over every card (a 16 MiB table
a card, index rows exchanged card to card, updates conserved), beside every
card's ``nvidia-smi`` line. First of all it runs phase T, sharded training:
one process a card under NCCL, spawned with a file rendezvous
(``parallel/launch.spawn`` of ``benchmarks/train_mesh.phase_t``): (a) the
dense family at Llama-3-8B widths, all 32 layers, on ``make_mesh(4)`` =
(1, 2, 2) (tp 2, ring attention over sp 2), batch 1 x 4096, ``remat``; (b)
the MoE family at Mixtral-8x7B widths, 8 of 32 layers, on
``make_moe_mesh(4, n_experts=8)`` = (1, 4, 1), batch 4 x 1024; (c) GPipe,
Llama-3-8B, 32 layers, ``make_pp_mesh(4, 32)`` = (1, 4), 4 microbatches of
1 x 1024; (d) the MoE family over pp, 8 layers (2 a stage), the same
batch; each with finite, falling losses, step ms, tokens/s, MFU against
the cards' datasheet bf16 rate, the bytes a step hands to collectives by
mesh axes and one profiled step; (e) each family at a depth one card holds
(2 layers, float32, TF32 off; the MoE family 1 layer, so that (f) fits)
held to the one-device step on cuda:0 over 2 steps (losses within rtol
1e-4, every gathered leaf's update within 5 % in norm of the one-card
update); (f) the MoE
state of (e) saved whole to LOCAL_DEVICE on cuda:0 (one K1), one step taken
on its mesh, then restored by ``load_sharded`` on ``make_moe_mesh(4)`` =
(1, 2, 2) (one K2), bit for bit, and one step there within (e)'s
tolerance; (g) the multi-host walkthrough on the four processes
(``examples/multihost_train.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

GiB = 1 << 30
MiB = 1 << 20
KiB = 1 << 10
BLOCK = 4096  # the fabric's and the copy kernels' block

# Where each kernel's Pallas original is (file:line of its pallas_call),
# and the source of the kernel that replaces it.
_REPLACES = {
    "write_rows": "oncilla_tpu/ops/pallas_ici.py:552",
    "read_rows": "oncilla_tpu/ops/pallas_ici.py:481",
    "local_copy": "oncilla_tpu/ops/pallas_ici.py:418",
    "onesided_copy": "oncilla_tpu/ops/pallas_ici.py:145",
    "copy_loop": "bench.py:150",
    "remote_loop": "bench.py:223",
    "read_stream": "oncilla_tpu/benchmarks/ceiling.py:91",
    "copy_stream_loop": "oncilla_tpu/benchmarks/ceiling.py:175",
    "vmem_roundtrip": "oncilla_tpu/benchmarks/ceiling.py:259",
    "attn_decode": "none (XLA's attention)",
}
_SOURCE = {
    "write_rows": "oncilla_tpu_torch/csrc/dma.cu",
    "read_rows": "oncilla_tpu_torch/csrc/dma.cu",
    "local_copy": "oncilla_tpu_torch/csrc/dma.cu",
    "onesided_copy": "oncilla_tpu_torch/csrc/fabric.cu",
    "copy_loop": "oncilla_tpu_torch/csrc/copy_loops.cu",
    "remote_loop": "oncilla_tpu_torch/csrc/copy_loops.cu",
    "read_stream": "oncilla_tpu_torch/csrc/ceiling.cu",
    "copy_stream_loop": "oncilla_tpu_torch/csrc/copy_loops.cu",
    "vmem_roundtrip": "oncilla_tpu_torch/csrc/ceiling.cu",
    "attn_decode": "oncilla_tpu_torch/csrc/attn_decode.cu",
}

# The ceiling probes' sizes: the JAX probes' defaults (ceiling.py:112-295).
CEIL_READ = {"total_bytes": 256 * MiB, "chunk_bytes": 2 * MiB, "iters": 600}
CEIL_COPY = {"total_bytes": 128 * MiB, "nbytes": 64 * MiB, "iters": 2000}
CEIL_TRIP = {"total_bytes": 128 * MiB, "nbytes": 64 * MiB, "iters": 400,
             "chunk_bytes": 2 * MiB}
_DMA_KERNELS = ("write_rows", "read_rows", "local_copy")

# One Llama-3-8B KV page of 128 tokens, the size every page move has.
PAGE = 16 * MiB
# K1-K4 are held byte for byte against their plain versions at these sizes:
# a bulk copy's short last tile (36 KiB, 1 MiB + 4 KiB, 1 GiB + 4 KiB with
# 32 KiB tiles), one page and 1 GiB.
CHECK_SIZES = (4 * KiB, 36 * KiB, MiB + 4 * KiB, PAGE, GiB, GiB + 4 * KiB)
FABRIC_SIZES = CHECK_SIZES[:4] + (512 * MiB,) + CHECK_SIZES[4:]

# NVLink between two H100 SXM cards, each way (datasheet): the bound of a
# copy between rows on different cards.
NVLINK_RATE = 450e9

# Paged vs unpaged logits, bf16 weights and activations on both sides, are
# required to be equal bit for bit (tolerance 0). Both paths attend over
# the same slice of keys (positions [0, pos]) with the same shapes, so when
# every page comes back byte-exact they run the same kernels on the same
# bytes. Any looser bound would let a wrong page byte through: one bad bf16
# element of a 16 MiB page moves the logits by far less than a rounding
# step of their scale.
GREEDY_CHECK = 32
PAGE_TOKENS = 128
N_REQUESTS = 2
# The serving engine's pages: 16 tokens, 2 MiB at Llama-3-8B in bf16,
# above the 1 MiB kernel threshold, so every HOT put/get is K1/K2.
ENGINE_PAGE_TOKENS = 16
# Phase D's launches: section 1's 1 MiB LOCAL_DEVICE put (K1), its get and
# the device->host copy's get (K2 twice). The REMOTE_HOST legs, the
# checkpoint and the LOCAL_HOST KV pages move no byte through a kernel.
DEMO_LAUNCHES = {"write_rows": 1, "read_rows": 2}


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device(measured: tuple, prefix: str = "") -> dict:
    """``kernel_times.device_ms``'s (ms, method) as a row's keys."""
    ms, by = measured
    return {f"{prefix}device_ms": ms, f"{prefix}device_by": by}


def _byte_err(want: torch.Tensor, got: torch.Tensor, at: int, n: int) -> int:
    """Largest byte difference over [at, at+n); outside that range (the
    rest of an arena) the two must be equal outright."""
    if not (torch.equal(want[:at], got[:at])
            and torch.equal(want[at + n:], got[at + n:])):
        raise AssertionError(f"bytes outside [{at}, {at + n}) differ")
    return int((want[at:at + n].to(torch.int16)
                - got[at:at + n].to(torch.int16)).abs().max())


# -- phase 1 ----------------------------------------------------------------


def phase_device() -> dict:
    from oncilla_tpu_torch.utils.platform import hbm_rate

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    smi = cards[0]
    name = torch.cuda.get_device_name(0)
    for i, line in enumerate(cards):
        log(f"[device] nvidia-smi: {line}" + (f" (card {i})" if len(cards) > 1 else ""))
    log(f"[device] torch: {name}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()}")
    return {"smi": smi, "cards": cards, "name": name, "hbm_rate": hbm_rate(name)}


# -- phase 2 ----------------------------------------------------------------


def phase_build() -> float:
    from oncilla_tpu_torch.ops import dma

    secs = dma.build()
    for src, text in dma.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {src}: {line.strip()}")
    log(f"[build] kernels built in {secs:.3f} s")
    return secs


# -- phase 3 ----------------------------------------------------------------


def phase_kernels(device, arena_bytes: int, sizes, base: int, copy_gap: int,
                  rate: float, timed=(), timing: bool = True) -> dict:
    """Every kernel against its plain version at every size, byte for byte;
    then, at each size of ``timed``, its times the way callers meet them
    (``benchmarks/kernel_times``: a cold L2, device and host time)."""
    from oncilla_tpu_torch.benchmarks import kernel_times as kt
    from oncilla_tpu_torch.ops import dma

    arena = torch.zeros(arena_bytes, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    arena.copy_(torch.randint(0, 256, (arena_bytes,), generator=gen,
                              dtype=torch.uint8, device=device))
    rows = {k: [] for k in _DMA_KERNELS}
    src, dst = base, base + copy_gap
    for n in sizes:
        raw = torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8,
                            device=device)
        ref = arena.clone()
        dma.write_rows_plain(ref, raw, src)
        dma.write_rows(arena, raw, src)
        err_w = _byte_err(ref, arena, src, n)

        got = dma.read_rows(arena, src, n)
        err_r = _byte_err(dma.read_rows_plain(arena, src, n), got, 0, n)

        ref.copy_(arena)
        dma.local_copy_plain(ref, src, dst, n)
        dma.local_copy(arena, src, dst, n)
        err_c = _byte_err(ref, arena, dst, n)
        del ref, got, raw
        errs = {"write_rows": err_w, "read_rows": err_r, "local_copy": err_c}
        for name, err in errs.items():
            if err != 0:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {n} B (max byte error {err})")
            rows[name].append({"nbytes": n, "src": src, "dst": dst,
                               "max_abs_err": float(err)})
        log(f"[kernels] write_rows read_rows local_copy {n:>11d} B at {src} -> "
            f"{dst}: max_abs_err 0")
    if not timing:
        return rows

    # Issue time a call at 4 KiB; get as Ocm.get calls it, into a fresh tensor.
    small = torch.randint(0, 256, (BLOCK,), generator=gen, dtype=torch.uint8,
                          device=device)
    host = {"write_rows": kt.host_us(lambda: dma.write_rows(arena, small, src)),
            "read_rows": kt.host_us(lambda: dma.read_rows(arena, src, BLOCK)),
            "local_copy": kt.host_us(lambda: dma.local_copy(arena, src, dst, BLOCK))}
    for n in timed:
        k = kt.rotation(n)
        at = [(src + i * n, dst + i * n) for i in range(k)]
        raws = [torch.empty(n, dtype=torch.uint8, device=device).random_(
            0, 256, generator=gen) for _ in range(k)]
        outs = [torch.empty(n, dtype=torch.uint8, device=device) for _ in range(k)]
        # get as decode's page fetch calls it, into a tensor it holds (out=).
        fns = {
            "write_rows": (
                lambda i, s, d: dma.write_rows(arena, raws[i], s),
                lambda i, s, d: dma.write_rows_plain(arena, raws[i], s),
                lambda i, s, d: arena[s:s + n].copy_(raws[i]),
            ),
            "read_rows": (
                lambda i, s, d: dma.read_rows(arena, s, n, out=outs[i]),
                lambda i, s, d: dma.read_rows_plain(arena, s, n, outs[i]),
                lambda i, s, d: outs[i].copy_(arena[s:s + n]),
            ),
            "local_copy": (
                lambda i, s, d: dma.local_copy(arena, s, d, n),
                lambda i, s, d: dma.local_copy_plain(arena, s, d, n),
                lambda i, s, d: arena[d:d + n].copy_(arena[s:s + n]),
            ),
        }
        for name, (kern, plain, lib) in fns.items():
            calls = [[functools.partial(f, i, s, d) for i, (s, d) in enumerate(at)]
                     for f in (kern, plain, lib)]
            windows = kt.cold_windows(calls[0])
            rec = {"nbytes": n, "extents": k,
                   "ms": statistics.median(ms for ms, _ in windows),
                   "issue_us": statistics.median(us for _, us in windows),
                   **_device(kt.device_ms(calls[0], kt.BULK)), "host_us": host[name],
                   "plain_ms": kt.cold_ms(calls[1]), "library_ms": kt.cold_ms(calls[2]),
                   **_device(kt.device_ms(calls[2], kt.MEMCPY), "library_"),
                   "bound_ms": 2 * n / rate * 1e3}
            rows[name].append(rec)
            log(f"[kernels] {name:10s} {json.dumps(rec)}")
        del raws, outs
    del arena
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows


# -- phase 3a ---------------------------------------------------------------

# The decode cell's attention: batch 32, Mixtral's 8 KV heads of 4 query
# heads and head size 128, a 128-slot tail holding 64 tokens.
ATTN_SHAPE = {"B": 32, "KV": 8, "G": 4, "D": 128, "P": 128, "tail_len": 64}
ATTN_CONTEXTS = (1152, 2304)


def _attn_device_ms(fn, iters: int) -> float:
    """The device time of ``fn``'s attention kernels a call, from
    ``torch.profiler`` over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "attn_decode" in e.key)
    return us * 1e-3 / iters


def phase_attn(device, rate: float, iters: int = 50) -> list:
    """Phase 3a (module docstring): one record a context length."""
    import torch.nn.functional as F

    from oncilla_tpu_torch.ops import attn

    B, KV, G, D, P, tail_len = (ATTN_SHAPE[k] for k in ("B", "KV", "G", "D", "P",
                                                         "tail_len"))
    gen = torch.Generator(device=device).manual_seed(22)
    dt = torch.bfloat16
    rows = []
    for C in ATTN_CONTEXTS:
        def r(*s):
            return torch.randn(*s, generator=gen, device=device).to(dt)

        q, kn, vn = r(B, KV * G, 1, D), r(B, KV, 1, D), r(B, KV, 1, D)
        k_ctx, v_ctx, tail_k, tail_v = r(B, KV, C, D), r(B, KV, C, D), \
            r(B, KV, P, D), r(B, KV, P, D)
        meta = torch.tensor([[C + tail_len, tail_len, C, 0]] * B, device=device)
        mask, slot = attn.decode_masks(meta, C, P, None)
        ref_k, ref_v = tail_k.clone(), tail_v.clone()
        want = attn.attn_decode_plain(q, kn, vn, k_ctx, v_ctx, ref_k, ref_v, mask, slot)
        before = attn.attn_decode.launches
        got = attn.attn_decode(q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, meta, None)
        torch.cuda.synchronize(device)
        launches = attn.attn_decode.launches - before
        err = float((got.float() - want.float()).abs().max())
        if err > 2 ** -7 * float(want.float().abs().max()) or not (
                torch.equal(tail_k, ref_k) and torch.equal(tail_v, ref_v)):
            raise AssertionError(f"attn_decode differs from its plain version at "
                                 f"C {C}: max abs error {err}")
        nbytes = 2 * B * KV * (C + tail_len + 1) * D * 2  # the valid K/V
        rec = {"C": C, "keys": C + tail_len + 1, "launches_a_call": launches,
               "splits": attn.splits(C + P, B * KV, attn.slots(q, G)),
               "resident_ctas": attn.slots(q, G), "max_abs_err": err,
               "nbytes": nbytes, "bound_ms": nbytes / rate * 1e3}
        k_all = torch.cat([k_ctx, tail_k], 2)
        v_all = torch.cat([v_ctx, tail_v], 2)
        sdpa_mask = mask[:, :, None, :]
        fns = {
            "ms": lambda: attn.attn_decode(q, kn, vn, k_ctx, v_ctx, tail_k,
                                           tail_v, meta, None),
            "plain_ms": lambda: attn.attn_decode_plain(
                q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, mask, slot),
            "library_ms": lambda: F.scaled_dot_product_attention(
                q, k_all, v_all, attn_mask=sdpa_mask, enable_gqa=True),
        }
        for key, fn in fns.items():
            rec[key] = event_ms(fn, iters)
        rec["device_ms"] = _attn_device_ms(fns["ms"], iters)
        rec["hbm_share"] = rec["bound_ms"] / rec["device_ms"]
        rows.append(rec)
        log(f"[attn] {json.dumps(rec)}")
        del q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, ref_k, ref_v
    torch.cuda.empty_cache()
    return rows


# -- phase 4 ----------------------------------------------------------------


def _expect(exc, fn, what: str) -> None:
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{what}: {exc.__name__} was not raised")


def phase_ocm_test(device, device_arena: int, host_arena: int, sizes,
                   copy_sizes, alloc_iters: int = 2000) -> dict:
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER

    kinds = (OcmKind.LOCAL_DEVICE, OcmKind.LOCAL_HOST)
    gen = torch.Generator(device=device).manual_seed(1)

    def payload(n):
        return torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8,
                             device=device)

    ctx = ocm.ocm_init(ocm.OcmConfig(device_arena_bytes=device_arena,
                                     host_arena_bytes=host_arena),
                       device=device)
    t0 = time.perf_counter()
    # put / get round trips, every size, both local kinds.
    for kind in kinds:
        for n in sizes:
            h = ctx.alloc(n, kind)
            data = payload(n)
            ctx.put(h, data)
            back = ctx.get(h)
            if not torch.equal(back.to(device), data):
                raise AssertionError(f"{kind} put/get mismatch at {n} B")
            ctx.free(h)
    # the copy matrix, whole-extent and at block-aligned / unaligned offsets.
    for n in copy_sizes:
        for sk in kinds:
            for dk in kinds:
                s, d = ctx.alloc(n + 8192, sk), ctx.alloc(n + 8192, dk)
                data = payload(n)
                ctx.put(s, data, offset=4096)
                for so, do in ((4096, 0), (4096, 4096), (4096, 100)):
                    ctx.copy(d, s, nbytes=n, dst_offset=do, src_offset=so)
                    if not torch.equal(ctx.get(d, n, do).to(device), data):
                        raise AssertionError(
                            f"copy {sk}->{dk} {n} B at {so}->{do} mismatch")
                ctx.free(s)
                ctx.free(d)
    # scrub on free: a freed extent reads back as zeros when re-allocated.
    for kind in kinds:
        n = max(sizes)
        h = ctx.alloc(n, kind)
        ctx.put(h, payload(n))
        off = h.extent.offset
        ctx.free(h)
        h = ctx.alloc(n, kind)
        if h.extent.offset != off:
            raise AssertionError("first-fit did not reuse the freed extent")
        if int(torch.count_nonzero(ctx.get(h))) != 0:
            raise AssertionError(f"{kind}: freed bytes leaked to the next tenant")
        ctx.free(h)
    # typed errors.
    h = ctx.alloc(4096, OcmKind.LOCAL_DEVICE)
    _expect(ocm.OcmBoundsError, lambda: ctx.put(h, payload(8192)), "put past end")
    _expect(ocm.OcmBoundsError, lambda: ctx.get(h, 100, offset=4000), "get past end")
    ctx.free(h)
    _expect(ocm.OcmInvalidHandle, lambda: ctx.put(h, payload(16)), "use after free")
    _expect(ocm.OcmInvalidHandle, lambda: ctx.get(h), "get after free")
    _expect(ocm.OcmInvalidHandle, lambda: ctx.free(h), "double free")
    _expect(ocm.OcmOutOfMemory,
            lambda: ctx.alloc(device_arena + 4096, OcmKind.LOCAL_DEVICE), "oom")
    _expect(ocm.OcmConnectError,
            lambda: ctx.alloc(4096, OcmKind.REMOTE_DEVICE), "remote kind")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    loop_s = time.perf_counter() - t0
    # alloc latency (host side: the allocator's bookkeeping and the span).
    GLOBAL_TRACER.reset()
    for _ in range(alloc_iters):
        ctx.free(ctx.alloc(4096, OcmKind.LOCAL_DEVICE))
    p50_us = GLOBAL_TRACER.stats("alloc").p50_s * 1e6
    ctx.tini()
    del ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[ocm_test] loop {loop_s:.3f} s, alloc p50 {p50_us:.3f} us "
        f"over {alloc_iters} allocs")
    return {"loop_s": loop_s, "alloc_p50_us": p50_us}


# -- phase 5 ----------------------------------------------------------------


def serve_request(params, cfg, ctx, prompt: torch.Tensor, n_gen: int,
                  page_tokens: int, kind: str = "LOCAL_DEVICE"):
    """One decode request: teacher-forced prompt, then greedy tokens, all
    consumed, through paged KV of ``kind``. Returns (consumed ids,
    per-step logits, pages shipped)."""
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.models import llama
    from oncilla_tpu_torch.models.kv_paging import BucketedPagedDecoder

    dec = BucketedPagedDecoder(
        params, cfg, ctx, batch=1, page_tokens=page_tokens,
        kind=OcmKind[kind], dtype=cfg.dtype, refetch=True,
    )
    ids = list(prompt.view(-1, 1))
    logits = []
    for t in range(prompt.numel() + n_gen):
        lg = dec.step(ids[t])
        logits.append(lg)
        if t + 1 >= prompt.numel() and len(ids) < prompt.numel() + n_gen:
            ids.append(llama.greedy(lg))
    npages = len(dec.cache.pages)
    dec.close()
    return torch.cat(ids), torch.cat(logits), npages


def reference_logits(params, cfg, ids: torch.Tensor) -> torch.Tensor:
    """The unpaged decode over one contiguous cache, teacher-forced on
    ``ids``."""
    from oncilla_tpu_torch.models import llama

    rcfg = dataclasses.replace(cfg, max_seq=ids.numel())
    kv = llama.make_kv_cache(rcfg, 1, device=ids.device)
    out = []
    for t in range(ids.numel()):
        lg, kv = llama.decode_step(params, ids[t:t + 1], t, kv, rcfg)
        out.append(lg)
    return torch.cat(out)


def profile_decode(params, cfg, ctx, ids: torch.Tensor, page_tokens: int,
                   steps: int = 16) -> dict:
    """Where a paged-decode token's time goes: ``steps`` tokens after the
    first page boundary under ``torch.profiler``. The device's busy share
    is the kernels' summed time over the window's wall time (one stream, so
    kernels do not overlap); the profiler's own cost is in the wall time,
    so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.models.kv_paging import BucketedPagedDecoder

    dec = BucketedPagedDecoder(params, cfg, ctx, batch=1,
                               page_tokens=page_tokens,
                               kind=OcmKind.LOCAL_DEVICE, dtype=cfg.dtype,
                               refetch=True)
    steps = min(steps, ids.numel() - page_tokens)
    for t in range(page_tokens):
        dec.step(ids[t:t + 1])
    device = ids.device
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(page_tokens, page_tokens + steps):
            dec.step(ids[t:t + 1])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dec.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) * 1e-6
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    out = {
        "steps": steps, "ms_per_token": wall / steps * 1e3,
        "device_busy_ms_per_token": busy_s / steps * 1e3,
        "device_busy_share": busy_s / wall if kernels else None,
        "launches_per_token": sum(e.count for e in kernels) / steps,
        "top_kernels_ms_per_token": {
            e.key[:60]: e.self_device_time_total / steps * 1e-3 for e in top},
    }
    log(f"[serving] profile: {json.dumps(out)}")
    return out


def phase_serving(device, cfg, params, n_requests: int, prompt_len: int,
                  n_gen: int, page_tokens: int, bench_tokens: int,
                  check_launches: bool = True) -> dict:
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.benchmarks import kv_decode
    from oncilla_tpu_torch.models import llama
    from oncilla_tpu_torch.models.kv_paging import page_bytes
    from oncilla_tpu_torch.ops import dma

    t0 = time.perf_counter()
    page = page_bytes(cfg, page_tokens, cfg.dtype)
    npages = (prompt_len + n_gen) // page_tokens
    arena = max(64 * MiB, 2 * npages * page)
    ctx = ocm.ocm_init(ocm.OcmConfig(device_arena_bytes=arena,
                                     host_arena_bytes=arena), device=device)
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, prompt_len))
               .to(device) for _ in range(n_requests)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"[serving] {cfg.n_layers} layers dim {cfg.dim}, page {page} B, "
        f"set-up {time.perf_counter() - t0:.3f} s")

    # The main path: counts from 0 just before, read just after.
    dma.reset_launches()
    results, req_s = [], []
    for p in prompts:
        t1 = time.perf_counter()
        ids, logits, shipped = serve_request(params, cfg, ctx, p, n_gen,
                                             page_tokens)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        req_s.append(time.perf_counter() - t1)
        results.append((ids, logits))
        if shipped != npages:
            raise AssertionError(f"{shipped} pages shipped, want {npages}")
    launches = dma.launches()
    log(f"[serving] launches over {n_requests} requests: {launches}")
    want_k1 = n_requests * npages
    want_k2 = n_requests * npages * (npages + 1) // 2
    if check_launches and (launches["write_rows"] != want_k1
                           or launches["read_rows"] != want_k2):
        raise AssertionError(
            f"pages did not all go through the kernels: {launches}, want "
            f"write_rows={want_k1} read_rows={want_k2}")

    checks = []
    ng = min(GREEDY_CHECK, n_gen)
    for r, (ids, logits) in enumerate(results):
        ref = reference_logits(params, cfg, ids)
        if logits.shape != ref.shape or not torch.isfinite(logits).all():
            raise AssertionError("paged logits malformed")
        exact = torch.equal(logits, ref)
        err = float((logits - ref).abs().max())
        scale = float(ref.abs().max())
        ref_greedy = llama.greedy(ref[prompt_len - 1:prompt_len - 1 + ng])
        got_greedy = ids[prompt_len:prompt_len + ng]
        agree = int((ref_greedy == got_greedy).sum())
        # top-2 margin of the reference at the checked generated steps
        top2 = torch.topk(ref[prompt_len - 1:prompt_len - 1 + ng],
                          2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        checks.append({"request": r, "exact": exact, "max_abs_err": err,
                       "logit_scale": scale, "greedy_agree": agree,
                       "min_top2_margin": margin, "seconds": req_s[r]})
        log(f"[serving] request {r}: {req_s[r]:.3f} s, max|dlogit| {err:.6f} "
            f"of scale {scale:.4f}, greedy {agree}/{ng}, "
            f"min top-2 margin {margin:.6f}")
    for c in checks:
        if not c["exact"]:
            raise AssertionError(f"paged logits differ from the unpaged "
                                 f"decode: {c}")
        if c["greedy_agree"] != ng:
            raise AssertionError(f"greedy tokens disagree: {c}")

    bench_ids = torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, bench_tokens))).to(device)
    tok_s = kv_decode.run_modes(params, cfg, bench_ids, ctx, page_tokens)
    if set(tok_s) != set(kv_decode.MODES):
        raise AssertionError(f"kv_decode modes {sorted(tok_s)}, want "
                             f"{sorted(kv_decode.MODES)}")
    prof = profile_decode(params, cfg, ctx, bench_ids[0], page_tokens)
    log(f"[serving] kv_decode tokens/s over {bench_tokens} tokens: {tok_s}")
    ctx.tini()
    del ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "requests": checks, "tok_s": tok_s,
            "profile": prof,
            "pages_per_request": npages}


# -- phase 5b ---------------------------------------------------------------

# The serving engine's runs: (name, batched, prefetch workers, CUDA graphs,
# HOT pages). A is the reference; D keeps every page on the card. A-D fault
# their off-card pages synchronously (no prefetch workers), so seating never
# depends on a worker's timing and B, C and D step the same batches. E is
# the engine as shipped (graphs None: the engine's own choice, graphed on
# the card), with prefetch threads and yield-on-cold seating; it keeps its
# logits rows (one clone a row, so its tokens/s carries that cost) but never
# synchronises a step. Its seating follows the workers' timing, so on the
# GPU its batches, and with them the low bits of its logits, change from
# call to call (check c).
ENGINE_RUNS = (
    ("A", False, 0, False, 8),
    ("B", True, 0, False, 8),
    ("C", True, 0, True, 8),
    ("D", True, 0, True, 64),
    ("E", True, 2, None, 8),
)


def seeded_prompts(vocab: int, seed: int, *, n: int, shared: int,
                   suffix: int) -> list:
    """A shared prefix, one identical pair (t0/t1) and per-tenant suffixes:
    the JAX package's ``seeded_prompts`` (tests/test_serving_batched.py:77)
    at other lengths."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, vocab, shared).tolist()
    p0 = base + rng.integers(1, vocab, suffix).tolist()
    return [p0, list(p0)] + [base + rng.integers(1, vocab, suffix).tolist()
                             for _ in range(n - 2)]


def _recording_engine():
    """A ServingEngine that keeps what the checks read: the logits row of
    every emitted token by (tenant, position), the first batched step of
    every shape bucket (its rows and logits), and profiler windows of
    ``profile_steps`` batched steps whose bucket ran before. ``graphs``
    runs the steps through a graph cache (on the CPU: its bookkeeping
    without a capture) or eagerly, whatever the device; ``"engine"`` keeps
    the engine's own choice; a ``StepGraphs`` is a cache to use. ``timed`` synchronises each batched step to
    time it; the engine as shipped runs untimed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from oncilla_tpu_torch.models.graphs import StepGraphs
    from oncilla_tpu_torch.serving.engine import ServingEngine

    class RecordingEngine(ServingEngine):
        def __init__(self, *args, graphs, profile_steps=0, timed=True, **kw):
            super().__init__(*args, **kw)
            if isinstance(graphs, StepGraphs):
                self.graphs = graphs  # a cache shared with other engines
            elif graphs != "engine":
                self.graphs = StepGraphs(self.params, self.cfg) if graphs else None
            self.profile_steps = profile_steps
            self.timed = timed
            self.rows, self.first, self.profiles = {}, {}, []
            self.step_ms = []      # (batch, ms) of every unprofiled step
            self.profiler_s = 0.0  # the windows' own cost, outside the steps

        def _keep(self, sess, pos, row):
            self.rows[(sess.req.tenant, pos)] = row.float().clone()

        def _decode_one(self, sess, args, tags):
            out = super()._decode_one(sess, args, tags)
            if sess.prompt_consumed == len(sess.prompt):
                self._keep(sess, sess.pos, out[0][0])
            return out

        def _decode_page(self, sess, args, ctx_len):
            out = super()._decode_page(sess, args, ctx_len)
            if sess.prompt_consumed + self.page_tokens == len(sess.prompt):
                self._keep(sess, sess.pos + self.page_tokens - 1, out[0][0, -1])
            return out

        def _decode_batch(self, batch, args, tags):
            table, pool = args[4], args[2]
            bucket = (table.shape[0], table.shape[1], pool.shape[0])
            if (self.device.type == "cuda" and len(batch) >= 2
                    and len(self.profiles) < self.profile_steps
                    and bucket in self.first):
                out = self._profiled(batch, args, tags)
            elif not self.timed:
                out = super()._decode_batch(batch, args, tags)
            else:
                # Synchronised here, where the engine's argmax would wait.
                t0 = time.perf_counter()
                out = super()._decode_batch(batch, args, tags)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.step_ms.append((len(batch), (time.perf_counter() - t0) * 1e3))
            logits = out[0]
            if bucket not in self.first:
                rows = tuple((s.req.tenant, s.pos) for s in batch)
                self.first[bucket] = (rows, logits.clone())
            for b, s in enumerate(batch):
                if s.prompt_consumed == len(s.prompt):
                    self._keep(s, s.pos, logits[b])
            return out

        def _profiled(self, batch, args, tags):
            """One batched step under torch.profiler: its wall time to a
            synchronise, and the kernels' summed time and count in it. The
            window's time beyond the step's (the profiler's start, stop and
            event processing) is kept apart in ``profiler_s``."""
            torch.cuda.synchronize(self.device)
            t_window = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = super()._decode_batch(batch, args, tags)
                torch.cuda.synchronize(self.device)
                wall = time.perf_counter() - t0
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            self.profiler_s += time.perf_counter() - t_window - wall
            self.profiles.append({
                "batch": len(batch), "wall_ms": wall * 1e3,
                "kernel_ms": sum(e.self_device_time_total for e in kernels) * 1e-3,
                "kernels": sum(e.count for e in kernels)})
            return out

    return RecordingEngine


def _step_ms(steps: list) -> dict:
    """{batch size: [median ms, steps]} of the timed batched steps."""
    out = {}
    for b in sorted({b for b, _ in steps}):
        ms = [m for bb, m in steps if bb == b]
        out[str(b)] = [statistics.median(ms), len(ms)]
    return out


# The margin rule's limits. Sound runs on one H100 (bf16 logits, batches
# of other shapes) read a largest logit difference of 0.0625-0.0742 and hold
# 38-54 % of the rows they walk; a page of wrong bytes moves the logits far
# more, so past either limit the rule fails whatever rows it still holds.
MARGIN_MAX_DIFF = 0.25
MARGIN_MIN_HELD = 0.25


def _margin_check(ref_rows: dict, rows: dict) -> dict:
    """Check d: walk each tenant's emitted positions in order until the
    first token that differs (later rows have other contexts); over those
    rows the largest logit difference D; the tokens must be equal at every
    row whose reference top-2 margin exceeds 2 D. ``splits`` gives, for
    each tenant whose tokens part, the reference's top-2 margin and the
    logit difference at that row: a tie shows there as a margin within
    2 D. :func:`_hold_margin` holds the result."""
    tenants = sorted({t for t, _ in ref_rows})
    walked = []  # (token equal, margin, diff)
    splits = []
    for t in tenants:
        for pos in sorted(p for tt, p in ref_rows if tt == t):
            a, b = ref_rows[(t, pos)], rows.get((t, pos))
            if b is None:
                break
            top2 = torch.topk(a, 2).values
            equal = int(a.argmax()) == int(b.argmax())
            walked.append((equal, float(top2[0] - top2[1]),
                           float((a - b).abs().max())))
            if not equal:
                splits.append({"tenant": t, "pos": pos,
                               "top2_margin": walked[-1][1],
                               "logit_diff": walked[-1][2]})
                break
    dmax = max((d for _, _, d in walked), default=0.0)
    held = [w for w in walked if w[1] > 2 * dmax]
    return {"rows": len(walked), "max_abs_logit_diff": dmax,
            "min_top2_margin": min((m for _, m, _ in walked), default=None),
            "steps_held": len(held), "held_equal": all(e for e, _, _ in held),
            "tokens_differ": sum(not e for e, _, _ in walked),
            "splits": splits}


def _hold_margin(what: str, d: dict) -> None:
    """Raise unless ``d`` (a :func:`_margin_check`) holds: equal tokens at
    every held row, a largest logit difference within
    :data:`MARGIN_MAX_DIFF`, and at least :data:`MARGIN_MIN_HELD` of the
    walked rows held."""
    if (not d["held_equal"] or d["max_abs_logit_diff"] > MARGIN_MAX_DIFF
            or d["steps_held"] < max(1, MARGIN_MIN_HELD * d["rows"])):
        raise AssertionError(
            f"{what}: tokens differ where the margin decides, or the logits "
            f"moved past the rule's limits (difference <= {MARGIN_MAX_DIFF}, "
            f"rows held >= {MARGIN_MIN_HELD:.0%}): {d}")


def phase_engine(device, cfg, params, *, page_tokens: int, runs=ENGINE_RUNS,
                 n_requests: int = 6, shared: int = 100, suffix: int = 12,
                 new_tokens: int = 32, warm: int = 8, max_active: int = 4,
                 max_batch: int = 8, profile_steps: int = 4,
                 cold_backend=None) -> dict:
    """The serving engine at ``cfg``'s width: ``runs`` (:data:`ENGINE_RUNS`)
    over ``seeded_prompts``, each timed, with the launches of K1/K2 beside
    the store's HOT put/get counts. A run whose graphs entry is None is the
    engine as shipped, unrecorded. ``cold_backend`` (a daemon client) puts
    the COLD tier on a remote host; without it COLD is the host stand-in.
    Returns the report that :func:`check_engine` holds to checks a-f."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.obs import journal
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.serving.engine import Request, ServingEngine
    from oncilla_tpu_torch.serving.metrics import ServingStats
    from oncilla_tpu_torch.serving.prefix import PrefixCache
    from oncilla_tpu_torch.serving.tiers import TieredPageStore

    Engine = _recording_engine()
    page = ServingEngine.page_nbytes(cfg, page_tokens, cfg.dtype)
    prompts = seeded_prompts(cfg.vocab, 11, n=n_requests, shared=shared,
                             suffix=suffix)
    on_card = device.type == "cuda"
    log(f"[engine] {len(prompts)} requests of {len(prompts[0])} prompt tokens "
        f"+ {new_tokens}, pages of {page_tokens} tokens ({page} B), "
        f"max_active {max_active}, max_batch {max_batch}")
    was = journal.enabled()
    journal.set_enabled(True)
    report = {"runs": {}, "page_bytes": page}
    try:
        for name, batched, workers, graphs, hot in runs:
            ctx = ocm.ocm_init(ocm.OcmConfig(
                device_arena_bytes=max(64 * MiB, hot * page),
                host_arena_bytes=256 * MiB), device=device)
            store = TieredPageStore(ctx, page, hot_capacity=hot,
                                    warm_capacity=warm, cold_backend=cold_backend,
                                    stats=ServingStats(f"run {name}"))
            kw = dict(page_tokens=page_tokens, max_active=max_active,
                      prefetch_workers=workers, store_dtype=cfg.dtype,
                      name=f"run {name}", batched=batched, max_batch=max_batch)
            shipped = graphs is None
            eng = Engine(params, cfg, store, PrefixCache(store, page_tokens),
                         graphs="engine" if shipped else graphs,
                         profile_steps=profile_steps if name in "BC" else 0,
                         timed=not shipped, **kw)
            wrap = getattr(cold_backend, "wrap_prefetcher", None)
            if wrap is not None:
                wrap(eng.prefetcher)
            journal.clear()
            if on_card:
                torch.cuda.synchronize(device)
            # The main path: counts from 0 just before, read just after.
            dma.reset_launches()
            t0 = time.perf_counter()
            for i, p in enumerate(prompts):
                eng.submit(Request(tenant=f"t{i}", tokens=p,
                                   max_new_tokens=new_tokens))
            results = eng.run()
            if on_card:
                torch.cuda.synchronize(device)
            # Tokens/s over the run's wall time less the profiler windows'
            # own cost (their steps stay in).
            profiler_s = eng.profiler_s
            secs = time.perf_counter() - t0 - profiler_s
            launches = dma.launches()
            meta = eng.metrics_meta()
            out = {r.tenant: list(r.out_tokens) for r in results}
            emitted = sum(len(v) for v in out.values())
            rows = eng.rows
            rec = {
                "seconds": secs, "profiler_s": profiler_s, "shipped": shipped,
                "workers": workers, "settings": (batched, workers, graphs, hot),
                "cold_sim": meta["cold_sim"],
                "tok_s": emitted / secs, "emitted": emitted,
                "prefill_tokens": meta["tokens"]["prefill"],
                "steps": meta["batch"]["steps"],
                "batch_size_max": meta["batch"]["size_max"],
                "prefill_chunks": meta["batch"]["prefill_chunks"],
                "moves": meta["moves"], "prefix": meta["prefix"],
                "stalls": meta["stalls"], "prefetch": meta["prefetch"],
                "preempts": meta["preempts"],
                "prefetch_stall_events": sum(e["ev"] == "prefetch_stall"
                                             for e in journal.events()),
                "graphs": meta.get("graphs"),
                "hot_io": dict(store.io["hbm"]), "io": store.io,
                "launches": launches,
                "profiles": eng.profiles, "step_ms": _step_ms(eng.step_ms),
                "t0_vs_t1": _margin_check(
                    {k: v for k, v in rows.items() if k[0] == "t0"},
                    {("t0", p): v for (t, p), v in rows.items() if t == "t1"}),
                "out": out, "rows": rows, "first": eng.first,
            }
            report["runs"][name] = rec
            eng.close()
            store.close()
            ctx.tini()
            log(f"[engine] run {name}{' (as shipped)' if shipped else ''}: "
                f"{emitted} tokens in {secs:.3f} s "
                f"(+{profiler_s:.3f} s of profiler windows), "
                f"{rec['tok_s']:.3f} tokens/s, {rec['steps']} batched steps "
                f"(max {rec['batch_size_max']}), {rec['prefill_chunks']} "
                f"prefill chunks, graphs {rec['graphs']}, prefetch_stall "
                f"{rec['prefetch_stall_events']}, prefetch {rec['prefetch']}, "
                f"preempts {rec['preempts']}, moves {rec['moves']}, "
                f"prefix {rec['prefix']}, HOT io {rec['hot_io']}, COLD io "
                f"{rec['io']['remote']}, launches "
                f"write_rows={launches['write_rows']} "
                f"read_rows={launches['read_rows']}")
            for w in rec["profiles"]:
                log(f"[engine] run {name} profiled step: {json.dumps(w)}")
            log(f"[engine] run {name} batched step ms (median, count by "
                f"batch): {json.dumps(rec['step_ms'])}; t0 vs t1: "
                f"{json.dumps(rec['t0_vs_t1'])}")
    finally:
        journal.set_enabled(was)
        journal.clear()
    if "A" in report["runs"] and "B" in report["runs"]:
        d = _margin_check(report["runs"]["A"]["rows"],
                          report["runs"]["B"]["rows"])
        report["batched_vs_interleaved"] = d
        log(f"[engine] batched vs interleaved (d): {json.dumps(d)}")
    if "C" in report["runs"] and "E" in report["runs"]:
        # Reported, not held: E seats by its workers' timing, and another
        # batch changes low bits on the GPU (check d).
        c, e = report["runs"]["C"]["out"], report["runs"]["E"]["out"]
        same = sum(x == y for t in c for x, y in zip(c[t], e.get(t, [])))
        report["shipped_vs_c"] = {"tokens_equal": same,
                                  "tokens": sum(len(v) for v in c.values())}
        log(f"[engine] run E (as shipped) vs C: {json.dumps(report['shipped_vs_c'])}")
    if on_card:
        torch.cuda.empty_cache()
    return report


def check_engine(report: dict, check_launches: bool = True) -> None:
    """Checks a-f of the serving engine's runs; raises on the first that
    fails."""
    runs = report["runs"]
    b, c, dd = (runs[k] for k in "BCD")
    # a. graphs against eager: tokens, and the first step of each bucket.
    if c["out"] != b["out"]:
        raise AssertionError(f"run C (graphs) tokens differ from run B: "
                             f"{c['out']} vs {b['out']}")
    if set(c["first"]) != set(b["first"]):
        raise AssertionError(f"buckets differ: {sorted(b['first'])} vs "
                             f"{sorted(c['first'])}")
    for bucket, (rows, logits) in c["first"].items():
        brows, blogits = b["first"][bucket]
        if rows != brows or not torch.equal(logits, blogits):
            raise AssertionError(f"bucket {bucket}: run C's first step is not "
                                 f"run B's bit for bit (rows {rows} / {brows})")
    # b. tier placement changes nothing.
    if dd["out"] != c["out"]:
        raise AssertionError(f"run D (all HOT) tokens differ from run C")
    # c. identical prompts, identical continuations: bit for bit where the
    # seating is the scheduler's alone; where it follows prefetch workers'
    # timing (E), t0 and t1 may sit in batches of other shapes, which change
    # low bits on the GPU, so their tokens are held by d's margin rule.
    for name, r in runs.items():
        if r["workers"]:
            _hold_margin(f"run {name}: t1 against t0", r["t0_vs_t1"])
        elif r["out"]["t0"] != r["out"]["t1"]:
            raise AssertionError(f"run {name}: t0 and t1 differ: "
                                 f"{r['out']['t0']} vs {r['out']['t1']}")
    # d. batched against interleaved, wherever the margin decides.
    _hold_margin("batched vs interleaved", report["batched_vs_interleaved"])
    # e. the machinery engaged; E with the shipped prefetch threads.
    for name in "BCE":
        r = runs[name]
        if not (r["moves"]["demote"] > 0 and r["moves"]["promote"] > 0
                and r["prefix"]["hits"] > 0 and r["prefix"]["cow"] >= 1
                and r["batch_size_max"] >= 2):
            raise AssertionError(f"run {name}: machinery not engaged: moves "
                                 f"{r['moves']}, prefix {r['prefix']}, batch "
                                 f"{r['batch_size_max']}")
    if runs["E"]["prefetch"]["mode"] != "thread":
        raise AssertionError(f"run E: prefetch not threaded: {runs['E']['prefetch']}")
    # f. every HOT put is one K1 launch, every HOT get one K2 launch.
    if check_launches:
        for name, r in runs.items():
            got = (r["launches"]["write_rows"], r["launches"]["read_rows"])
            want = (r["hot_io"]["put"], r["hot_io"]["get"])
            if got != want or r["launches"]["local_copy"]:
                raise AssertionError(f"run {name}: K1/K2 launches {got} != HOT "
                                     f"puts/gets {want}: {r['launches']}")
        for name in "BCE":
            if not all(runs[name]["launches"][k] for k in ("write_rows", "read_rows")):
                raise AssertionError(f"run {name}: a page kernel never "
                                     f"launched: {runs[name]['launches']}")


# -- phase 6 ----------------------------------------------------------------


def _fabric_cases(row_bytes: int, sizes):
    """(case, size, src row, dst row, src_off, dst_off, force_remote): across
    rows at every size; within a row (local fast path) and as a loopback at
    every size that fits twice in a row. Every case touches a row's last
    block with its source or its destination, and at least one of its
    offsets is off the 32 KiB tile grid."""
    for n in sizes:
        yield "cross_row", n, 0, 1, BLOCK, row_bytes - n, False
        if 2 * n <= row_bytes:
            yield "same_row", n, 2, 2, 0, row_bytes - n, False
            yield "loopback", n, 3, 3, row_bytes - n, 0, True


def _rotated(off: int, n: int, row_bytes: int, k: int) -> list[int]:
    """``k`` disjoint extents of ``n`` bytes from ``off``, moving away from
    the row's end if the extent touches it, else towards it."""
    step = -n if off + n == row_bytes else n
    return [off + i * step for i in range(k)]


def _same_rows(want, got, what: str) -> None:
    for r, (a, b) in enumerate(zip(want.rows, got.rows)):
        if not torch.equal(a, b):
            bad = (a != b).nonzero()
            lo, hi = int(bad[0]), int(bad[-1])
            err = int((a.to(torch.int16) - b.to(torch.int16)).abs().max())
            raise AssertionError(f"{what}: row {r} differs from the plain "
                                 f"version in [{lo}, {hi}] (max byte error {err})")


def phase_fabric(device, row_bytes: int, sizes, rate: float,
                 handle_sizes, ring_bytes: int, bench_kw: dict,
                 timing: bool = True, check_launches: bool = True,
                 mesh=None, with_bench: bool = True, timed=()) -> dict:
    """The fabric: K4 against its plain version on a 4-row plane, then the
    handle-level main path, then (``with_bench``) copy_bench and the copy
    loops on ``device``. The rows lie on ``mesh`` (4 devices), by default
    all on ``device``; rows on different cards make the cross-row cases
    cross-card, bounded by NVLink as well as HBM. Each case at a size of
    ``timed`` is timed as phase 3 times K1-K3."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.benchmarks import copy_bench
    from oncilla_tpu_torch.benchmarks import kernel_times as kt
    from oncilla_tpu_torch.ops import copy_loops, dma, fabric
    from oncilla_tpu_torch.ops.ici import SpmdIciPlane
    from oncilla_tpu_torch.parallel import spmd_arena as sa
    from oncilla_tpu_torch.runtime.cluster import local_cluster

    on_card = device.type == "cuda"
    mesh = [device] * 4 if mesh is None else mesh
    t0 = time.perf_counter()
    # Two ranks of two rows: the daemons of the handle path each book two.
    plane = SpmdIciPlane(ocm.OcmConfig(device_arena_bytes=row_bytes),
                         mesh=mesh, devices_per_rank=2)
    arena = plane.arena
    gen = torch.Generator(device=device).manual_seed(2)
    for row in arena.rows:
        row.copy_(torch.empty_like(row, device=device).random_(0, 256, generator=gen))

    # 1. K4 against its plain version, every byte of every row compared.
    k4 = []
    for case, n, a, b, so, do, force in _fabric_cases(row_bytes, sizes):
        ref = fabric.FabricRows([r.clone() for r in arena.rows])
        fabric.onesided_copy_plain(ref, a, b, so, do, n)
        fabric.onesided_copy(arena, a, b, so, do, n, force_remote=force)
        _same_rows(ref, arena, f"onesided_copy {case} {n} B")
        del ref
        k4.append({"case": case, "nbytes": n, "max_abs_err": 0.0,
                   "devices": f"{mesh[a]}->{mesh[b]}"})
        log(f"[fabric] onesided_copy {case:9s} {mesh[a]}->{mesh[b]} {n:>11d} B "
            f"at {so} -> {do} max_abs_err 0")
    if timing:
        host = kt.host_us(lambda: fabric.onesided_copy(
            arena, 0, 1, BLOCK, row_bytes - BLOCK, BLOCK))
        for case, n, a, b, so, do, force in _fabric_cases(row_bytes, timed):
            k = kt.rotation(n)
            at = list(zip(_rotated(so, n, row_bytes, k), _rotated(do, n, row_bytes, k)))
            src, dst = arena.rows[a], arena.rows[b]
            bound_s = 2 * n / rate
            if mesh[a] != mesh[b]:
                bound_s = max(bound_s, n / NVLINK_RATE)
            kern = [functools.partial(fabric.onesided_copy, arena, a, b, s, d, n,
                                      force_remote=force) for s, d in at]
            plain = [functools.partial(fabric.onesided_copy_plain, arena, a, b, s, d, n)
                     for s, d in at]
            lib = [functools.partial(dst[d:d + n].copy_, src[s:s + n]) for s, d in at]
            names = kt.BULK if case == "same_row" else kt.SEND_BULK
            # Timed on the destination's stream, where a copy completes (a
            # send across cards first waits for that stream's earlier work).
            with torch.cuda.device(mesh[b]):
                rec = {"case": case, "nbytes": n, "extents": k,
                       "devices": f"{mesh[a]}->{mesh[b]}",
                       "ms": kt.cold_ms(kern), **_device(kt.device_ms(kern, names)),
                       "host_us": host if case == "cross_row" else None,
                       "plain_ms": kt.cold_ms(plain), "library_ms": kt.cold_ms(lib),
                       **_device(kt.device_ms(lib, kt.MEMCPY), "library_"),
                       "bound_ms": bound_s * 1e3}
            if mesh[a] != mesh[b]:
                rec["send_body"] = "TMA bulk stores"  # every send's
            k4.append(rec)
            log(f"[fabric] onesided_copy {json.dumps(rec)}")
    if on_card:
        for d in set(mesh):
            torch.cuda.synchronize(d)
        flags = [[int(v) for v in w.cpu()] for w in arena.sync]
        want = [[q, 0] for q in arena.seq]
        if flags != want or not any(arena.seq):
            raise AssertionError(f"recv flags / send counters {flags}, want {want}")
        log(f"[fabric] recv flags after the protocol runs: {flags}")

    # 2. The handle-level main path: REMOTE_DEVICE handles placed by two of
    # the port's daemons (runtime/cluster.py), two rows each, their device
    # arenas the plane's rows. Counts from 0 just before, read after.
    with local_cluster(2, ndevices=2, device_arena_bytes=row_bytes) as cl:
        ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=cl.nodefile, rank=0,
                                         host_arena_bytes=1 << 20,
                                         device_arena_bytes=1 << 20),
                           device=device, ici_plane=plane)
        rng = np.random.default_rng(3)
        dma.reset_launches()
        copies0 = plane.stats["ici_copies"]
        for n in handle_sizes:
            hs = [ctx.alloc(n, OcmKind.REMOTE_DEVICE) for _ in range(5)]
            if not all(h.daemon_owned and h.rank == 1 for h in hs):
                raise AssertionError(f"REMOTE_DEVICE handles not placed on rank 1: {hs}")
            row = (hs[0].rank, hs[0].device_index)
            other = next(h for h in hs[1:] if (h.rank, h.device_index) != row)
            same = next(h for h in hs[1:] if (h.rank, h.device_index) == row)
            third = next(h for h in hs[1:] if h is not other and h is not same)
            data = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(device)
            ctx.put(hs[0], data)
            if not torch.equal(ctx.get(hs[0]).to(device), data):
                raise AssertionError(f"put/get through the plane mismatch at {n} B")
            # across rows through Ocm.copy, on through the plane, and within
            # hs[0]'s row through Ocm.copy again.
            for dst, src, via_ctx in ((other, hs[0], True), (third, other, False),
                                      (same, hs[0], True)):
                gets = plane.stats["gets"]
                if via_ctx:
                    ctx.copy(dst, src)
                else:
                    plane.copy(dst, src, n)
                if plane.stats["gets"] != gets:
                    raise AssertionError("a REMOTE_DEVICE copy went through get")
                if not torch.equal(plane.get(dst, n).to(device), data):
                    raise AssertionError(f"one-sided handle copy mismatch at {n} B")
            for h in hs:
                ctx.free(h)
        ctx.tini()
        if on_card:
            for d in set(mesh):
                torch.cuda.synchronize(d)
        handle_launches = dma.launches()
        if any(cl.status(r)["live_allocs"] for r in range(2)):
            raise AssertionError("the daemons still hold allocations after tini")
    copies = plane.stats["ici_copies"] - copies0
    log(f"[fabric] handle-level (daemon-placed): {copies} ici_copies, "
        f"launches {handle_launches}")
    if copies != 3 * len(handle_sizes):
        raise AssertionError(f"{copies} ici_copies, want {3 * len(handle_sizes)}")
    if check_launches and handle_launches["onesided_copy"] < copies:
        raise AssertionError("a handle copy did not launch the one-sided kernel")

    # ring_shift over the 4 rows, then back.
    off = row_bytes - ring_bytes
    stamps = [torch.full((ring_bytes,), 17 * (i + 1), dtype=torch.uint8,
                         device=device) for i in range(4)]
    for i, st in enumerate(stamps):
        sa.host_put(arena, i, st, off)
    plane.update(lambda a: sa.ring_shift(a, off, ring_bytes))
    for i in range(4):
        got = sa.host_get(arena, (i + 1) % 4, ring_bytes, off).to(device)
        if not torch.equal(got, stamps[i]):
            raise AssertionError(f"ring_shift: row {(i + 1) % 4} lacks row {i}'s bytes")
    plane.update(lambda a: sa.ring_shift(a, off, ring_bytes, reverse=True))
    for i in range(4):
        if not torch.equal(sa.host_get(arena, i, ring_bytes, off).to(device), stamps[i]):
            raise AssertionError(f"ring_shift reverse: row {i} not restored")
    del plane, arena, stamps
    if on_card:
        torch.cuda.empty_cache()
    log(f"[fabric] one-sided copies, handles, ring_shift: "
        f"{time.perf_counter() - t0:.3f} s")
    if not with_bench:
        return {"rows": {"onesided_copy": k4}, "launches_handles": handle_launches}

    # 3. copy_bench (a main path of its own), then K9/K10 against their
    # plain loops at a small odd count.
    dma.reset_launches()
    bench = copy_bench.run(device, timing=timing, **bench_kw)
    if on_card:
        torch.cuda.synchronize(device)
    bench_launches = dma.launches()
    log("[copy_bench] " + json.dumps(bench))
    log(f"[copy_bench] launches {bench_launches}")
    if not bench["ok"]:
        raise AssertionError(f"copy_bench failed: {bench['detail'].get('errors')}")
    if check_launches and not (bench_launches["copy_loop"]
                               and bench_launches["remote_loop"]):
        raise AssertionError("copy_bench did not launch K9 and K10")

    nbytes, total = bench_kw["nbytes"], bench_kw["arena_bytes"]
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    buf.random_(0, 256, generator=gen)
    loops = {"copy_loop": [], "remote_loop": []}
    for name, streams in (("copy_loop", 2), ("copy_loop", 4), ("remote_loop", 2)):
        want, got = buf.clone(), buf.clone()
        if name == "copy_loop":
            copy_loops.copy_loop_plain(want, nbytes, 3, streams)
            copy_loops.copy_loop(got, nbytes, 3, streams)
        else:
            copy_loops.remote_loop_plain(want, nbytes, 3)
            copy_loops.remote_loop(got, nbytes, 3)
        if not torch.equal(want, got):
            raise AssertionError(f"{name} at {streams} streams differs from "
                                 "its plain loop after 3 iterations")
        loops[name].append({"streams": streams, "iters": 3, "max_abs_err": 0.0})
        del want, got
    log("[fabric] copy_loop (2, 4 streams) and remote_loop equal their plain "
        "loops after 3 iterations")
    iters = bench_kw["iters"]
    timed = {"copy_loop": (bench["detail"]["copy_loop_streams"], iters,
                           bench["detail"]["copy_loop_gbps"]),
             "remote_loop": (2, iters // 2, bench["detail"]["remote_loop_gbps"])}
    rows = {"onesided_copy": k4}
    for name, (streams, n_it, gbps) in timed.items():
        traffic = 2 * nbytes * n_it
        rec = {"nbytes": nbytes, "iters": n_it, "streams": streams,
               "max_abs_err": 0.0, "bound_ms": traffic / rate * 1e3,
               "library_ms": None}
        if timing:
            rec["ms"] = traffic / (gbps * 1e9) * 1e3
            rec["plain_ms"] = event_ms(lambda s=streams, k=n_it: copy_loops.copy_loop_plain(
                buf, nbytes, k, s), 1, warmup=1)
        rows[name] = [rec] + loops[name]
    del buf
    if on_card:
        torch.cuda.empty_cache()
    return {"rows": rows, "bench": bench, "launches_handles": handle_launches,
            "launches_copy_bench": bench_launches}


# -- phase 7 ----------------------------------------------------------------


def _random_bytes(n: int, device, gen) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8, device=device).random_(0, 256, generator=gen)


def phase_bench(device, rate: float, read_kw: dict, copy_kw: dict, trip_kw: dict,
                bench_kw: dict, gb_max: int, timing: bool = True,
                check_launches: bool = True) -> dict:
    """bench.py's measurement path: K6-K8 against their plain versions at the
    ceiling probes' sizes, then the main path — ``ceiling_probe`` and the
    port bench's ``run`` — graded by the port's ``check``; every ceiling
    leg must be measured, and the gb_sweep must hold ``gb_max`` with its
    amortized leg."""
    from oncilla_tpu_torch.benchmarks import bench, ceiling, check
    from oncilla_tpu_torch.ops import ceiling_loops as cl
    from oncilla_tpu_torch.ops import dma

    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(4)
    t0 = time.perf_counter()

    # 1. K6: the buffer unchanged, the sum of the landed bytes the buffer's.
    chunk = read_kw["chunk_bytes"]
    rbuf = _random_bytes(read_kw["total_bytes"], device, gen)
    before = rbuf.clone()
    got = cl.read_stream(rbuf, chunk, 3)
    want = cl.read_stream_plain(rbuf, chunk, 1)
    if not torch.equal(rbuf, before):
        raise AssertionError("read_stream changed the buffer it reads")
    if int(got) != int(want):
        raise AssertionError(f"read_stream summed {int(got)}, the buffer holds {int(want)}")
    del before
    checks = {"read_stream": [{"iters": 3, "max_abs_err": 0.0, "sum": int(got)}],
              "copy_stream_loop": [], "vmem_roundtrip": []}

    # 2. K7 at 1/2/4/8 streams, K8 at an even and an odd count.
    nbytes = copy_kw["nbytes"]
    cbuf = _random_bytes(copy_kw["total_bytes"], device, gen)
    cases = [("copy_stream_loop", s, 3) for s in (1, 2, 4, 8)]
    cases += [("vmem_roundtrip", 1, n) for n in (2, 3)]
    for name, streams, n_it in cases:
        want, got = cbuf.clone(), cbuf.clone()
        if name == "copy_stream_loop":
            cl.copy_stream_loop_plain(want, nbytes, n_it, streams)
            cl.copy_stream_loop(got, nbytes, n_it, streams)
        else:
            cl.vmem_roundtrip_plain(want, trip_kw["nbytes"], n_it, trip_kw["chunk_bytes"])
            cl.vmem_roundtrip(got, trip_kw["nbytes"], n_it, trip_kw["chunk_bytes"])
        err = _byte_err(want, got, 0, want.numel())
        if err:
            raise AssertionError(f"{name} ({streams} streams, {n_it} iterations) "
                                 f"differs from its plain version (max byte error {err})")
        checks[name].append({"streams": streams, "iters": n_it, "max_abs_err": 0.0})
        del want, got
    log("[bench] read_stream (buffer unchanged, sum equal), copy_stream_loop at "
        "1/2/4/8 streams and vmem_roundtrip at 2 and 3 iterations equal their "
        "plain versions")

    # 3. The main path: counts from 0 just before, read just after.
    dma.reset_launches()
    ceil = ceiling.ceiling_probe(device=device, timing=timing, read_kw=read_kw,
                                 copy_kw=copy_kw, roundtrip_kw=trip_kw)
    line = bench.run(device, timing=timing, **bench_kw)
    if on_card:
        torch.cuda.synchronize(device)
    launches = dma.launches()
    rows = check.grade(line)
    log("[ceiling] " + json.dumps(ceil))
    log("[bench] " + json.dumps(line))
    for name, verdict, evidence in rows:
        log(f"[check] {verdict:<8} {name}: {evidence}")
    log(f"[bench] launches {launches}")
    if not line["ok"]:
        raise AssertionError(f"bench failed: {line['detail']['errors']}")
    legs = [line["detail"]["ceiling"], ceil]
    flat = [v for c in legs for v in (c["read_only_gbps"], c["vmem_roundtrip_gbps"],
                                      *c["copy_streams_gbps"].values())]
    if timing and not all(v is not None and v > 0 for v in flat):
        raise AssertionError(f"a ceiling leg was not measured: {legs}")
    point = line["detail"]["gb_sweep"].get(str(gb_max))
    if point is None or (timing and point[2] is None):
        raise AssertionError(f"gb_sweep lacks {gb_max} B with its amortized leg: "
                             f"{line['detail']['gb_sweep']}")
    if timing and any(v == "NO DATA" for _, v, _ in rows[:3]):
        raise AssertionError(f"grader rows 1-3 read NO DATA: {rows[:3]}")
    if timing and rows[4][1] not in ("PASS", "FAIL"):
        raise AssertionError(f"grader row 5 is not graded: {rows[4]}")
    detail = line["detail"]
    measured = [v for v in detail["mfu_train_variants"]
                if "error" not in v and "skipped" not in v]
    if not measured:
        raise AssertionError(f"no mfu_train variant was measured: "
                             f"{detail['mfu_train_variants']}")
    if timing and not all((detail.get(k) or 0) > 0 for k in ("mfu", "mfu_train")):
        raise AssertionError(f"mfu {detail.get('mfu')}, mfu_train "
                             f"{detail.get('mfu_train')}: not both measured")
    if timing and rows[3][1] not in ("PASS", "FAIL"):
        raise AssertionError(f"grader row 4 is not graded: {rows[3]}")
    if check_launches and not all(launches.values()):
        raise AssertionError(f"the bench did not launch every kernel: {launches}")
    # The wire, GUPS and serving legs (bench.py's last three stages).
    dcn = detail["dcn"]
    if not (dcn["verified"] and dcn["native_daemons"]):
        raise AssertionError(f"dcn leg not verified on the native daemons: "
                             f"verified {dcn['verified']}, native "
                             f"{dcn['native_daemons']}")
    if rows[5][1] != "PASS":
        raise AssertionError(f"grader row 6 does not pass: {rows[5]}")
    if detail["gups_table_sum"] != detail["gups_updates"]:
        raise AssertionError(f"gups: table sum {detail['gups_table_sum']} != "
                             f"updates {detail['gups_updates']}")
    serving = detail["serving"]
    if not (serving["chaos"]["byte_exact"] and serving["warmboot"]["byte_exact"]):
        raise AssertionError("serving: the chaos or warm-boot leg is not "
                             "byte-exact")

    # 4. The kernels' rows: the probe's timed launch, beside its bound, its
    # plain version and (K6) one torch.sum times the sweeps.
    out = {}
    streams = max((1, 2, 4, 8), key=lambda s: ceil["copy_streams_gbps"][str(s)] or 0.0)
    timed = {
        "read_stream": (read_kw["total_bytes"] * read_kw["iters"], ceil["read_only_gbps"],
                        lambda: cl.read_stream_plain(rbuf, chunk, read_kw["iters"]),
                        lambda: rbuf.sum(dtype=torch.int64), read_kw["iters"]),
        "copy_stream_loop": (2 * nbytes * copy_kw["iters"],
                             ceil["copy_streams_gbps"][str(streams)],
                             lambda: cl.copy_stream_loop_plain(cbuf, nbytes, copy_kw["iters"],
                                                               streams), None, 0),
        "vmem_roundtrip": (2 * trip_kw["nbytes"] * trip_kw["iters"],
                           ceil["vmem_roundtrip_gbps"],
                           lambda: cl.vmem_roundtrip_plain(cbuf, trip_kw["nbytes"],
                                                           trip_kw["iters"],
                                                           trip_kw["chunk_bytes"]), None, 0),
    }
    for name, (traffic, gbps, plain, lib, lib_times) in timed.items():
        rec = {"nbytes": traffic, "max_abs_err": 0.0, "bound_ms": traffic / rate * 1e3,
               "library_ms": None}
        if name == "copy_stream_loop":
            rec["streams"] = streams
        if timing:
            rec["ms"] = traffic / (gbps * 1e9) * 1e3
            rec["plain_ms"] = event_ms(plain, 1, warmup=1)
            if lib is not None:
                rec["library_ms"] = event_ms(lib, 10) * lib_times
        out[name] = [rec, *checks[name]]
        log(f"[bench] {name:16s} " + json.dumps(rec))
    del rbuf, cbuf
    if on_card:
        torch.cuda.empty_cache()
    log(f"[bench] phase {time.perf_counter() - t0:.3f} s")
    return {"rows": out, "ceiling": ceil, "bench": line, "grade": rows,
            "launches": launches, "launches_serving": serving["launches"]}


# -- phase 8 ----------------------------------------------------------------

# The wire's cluster: two daemons of the port's copy, two rows each, their
# device arenas the plane's 256 MiB rows; rank 1's host arena holds a 1 GiB
# REMOTE_HOST allocation with room to spare, rank 0's little, so the
# capacity policy places every REMOTE_HOST allocation of rank 0's app on
# rank 1.
WIRE_ROW = 256 * MiB
WIRE_HOST = (256 * MiB, 2 * GiB + 256 * MiB)
WIRE_SIZES = (4 * KiB, MiB + 4 * KiB, PAGE, 256 * MiB, GiB)
# Runs F and G keep 2 WARM pages, not phase 5b's 8: at 8 HOT + 8 WARM every
# page of its workload stays on the card or in host DRAM, and its COLD tier
# moves nothing (measured on one H100: run F at 8 WARM pages put and got
# no COLD page).
WIRE_WARM = 2
_KINDS = ("LOCAL_HOST", "LOCAL_DEVICE", "REMOTE_HOST", "REMOTE_DEVICE")

# The plane-less second process of check (c): CPU only, it attaches to rank
# 1 through the nodefile and writes, then reads, one daemon-placed
# REMOTE_DEVICE handle; the daemons relay both to the controller's plane.
_PLANELESS = """
import sys
import numpy as np
import oncilla_tpu_torch as ocm
from oncilla_tpu_torch.core.arena import Extent
nodefile, alloc_id, rank, dev, off, n = sys.argv[1], *map(int, sys.argv[2:])
ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=nodefile, rank=1,
                                 host_arena_bytes=1 << 20,
                                 device_arena_bytes=1 << 20), device="cpu")
h = ocm.OcmAlloc(alloc_id=alloc_id, kind=ocm.OcmKind.REMOTE_DEVICE,
                 fabric=ocm.Fabric.ICI, nbytes=n, rank=rank, device_index=dev,
                 extent=Extent(off, n), origin_rank=1)
h.daemon_owned = True
data = (np.arange(n) % 251).astype(np.uint8)
ctx.put(h, data)
assert np.array_equal(ctx.get(h).numpy(), data), "relay read-back differs"
ctx.tini()
print("planeless relay: put and get of", n, "B through the daemons")
"""


def _pattern(n: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) % 251).to(torch.uint8)


def _median_s(fn, reps: int, device) -> float:
    """Median wall time of ``reps`` calls, each ending synchronised."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def wire_context(cl, mesh, row_bytes: int, app_bytes: int):
    """The phase's plane (4 rows of ``row_bytes`` on ``mesh``, two a rank,
    as the daemons book them) and its app context at rank 0, attached
    through the cluster's nodefile."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.ops.ici import SpmdIciPlane

    plane = SpmdIciPlane(ocm.OcmConfig(device_arena_bytes=row_bytes),
                         mesh=mesh, devices_per_rank=2)
    cfg = ocm.OcmConfig(nodefile=cl.nodefile, rank=0, host_arena_bytes=app_bytes,
                        device_arena_bytes=app_bytes)
    return plane, ocm.ocm_init(cfg, device=mesh[0], ici_plane=plane)


def wire_concurrent(ctx, device, gen, n: int, rounds: int) -> dict:
    """Check (a2): two threads of the app at once (a barrier each round),
    each putting a card tensor of ``n`` bytes into a REMOTE_HOST handle of
    its own and reading it back into a card tensor, ``rounds`` times.
    Every get is byte-equal to its put, and the client keeps at most
    ``STAGE_KEEP`` free staging buffers after. Reports the most staging
    buffers out at once (2 when the two threads' wire legs overlapped) and
    a round's wall time beside one thread's put and get."""
    import threading

    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.runtime.client import STAGE_KEEP

    client = ctx._remote
    inner, count_lock = client._staged, threading.Lock()
    held = {"now": 0, "peak": 0}

    @contextlib.contextmanager
    def counted(nbytes):
        with inner(nbytes) as buf:
            with count_lock:
                held["now"] += 1
                held["peak"] = max(held["peak"], held["now"])
            try:
                yield buf
            finally:
                with count_lock:
                    held["now"] -= 1

    hs = [ctx.alloc(n, OcmKind.REMOTE_HOST) for _ in range(2)]
    data = [torch.empty(n, dtype=torch.uint8, device=device).random_(
        0, 256, generator=gen) for _ in range(2)]
    outs = [torch.empty(n, dtype=torch.uint8, device=device) for _ in range(2)]
    barrier = threading.Barrier(2)
    errors = []

    def one(i):
        try:
            for r in range(rounds):
                barrier.wait()
                ctx.put(hs[i], data[i])
                ctx.get(hs[i], out=outs[i])
                if not torch.equal(outs[i], data[i]):
                    raise AssertionError(f"thread {i} round {r}: bytes differ")
                outs[i].zero_()
        except BaseException as e:  # re-raised on the phase's thread
            errors.append(e)
            barrier.abort()

    def serial_s():
        t0 = time.perf_counter()
        ctx.put(hs[0], data[0])
        ctx.get(hs[0], out=outs[0])
        return time.perf_counter() - t0

    serial_s()  # warm: the buffers of this size exist
    one_s = statistics.median(serial_s() for _ in range(rounds))
    client._staged = counted
    try:
        t0 = time.perf_counter()
        ts = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        pair_s = (time.perf_counter() - t0) / rounds
    finally:
        del client._staged
    if errors:
        raise errors[0]
    for h in hs:
        ctx.free(h)
    kept = len(client._stage_free)
    if kept > STAGE_KEEP:
        raise AssertionError(f"staging pool keeps {kept} buffers, past "
                             f"STAGE_KEEP {STAGE_KEEP}")
    return {"nbytes": n, "rounds": rounds, "peak_buffers": held["peak"],
            "kept_buffers": kept, "round_s": pair_s,
            "one_thread_put_get_s": one_s}


def wire_placed(ctx, plane, nodefile: str, n: int, count: int) -> dict:
    """Check (c): ``count`` REMOTE_DEVICE handles of ``n`` bytes placed by
    the daemons on rank 1 read as zeros over rows filled with noise (the
    scrub); a plane-less CPU process writes and reads one of them through
    the daemons' relay, and the controller reads those bytes on its rows."""
    from oncilla_tpu_torch import OcmKind

    gens = {}
    for row in plane.arena.rows:  # noise where the handles will land
        gen = gens.setdefault(row.device, torch.Generator(
            device=row.device).manual_seed(8))
        row.random_(0, 256, generator=gen)
    hs = [ctx.alloc(n, OcmKind.REMOTE_DEVICE) for _ in range(count)]
    where = sorted({(h.rank, h.device_index) for h in hs})
    if not all(h.rank == 1 and h.daemon_owned for h in hs):
        raise AssertionError(f"REMOTE_DEVICE handles not placed on rank 1: {where}")
    for h in hs:
        if int(torch.count_nonzero(ctx.get(h))) != 0:
            raise AssertionError(f"handle {h.alloc_id} did not read as zeros")
    h = hs[-1]
    served = dict(ctx._remote._plane_server.served)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", _PLANELESS, nodefile, str(h.alloc_id), str(h.rank),
         str(h.device_index), str(h.extent.offset), str(n)],
        capture_output=True, text=True, timeout=300, env=env)
    second_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the plane-less process failed:\n{out.stderr[-3000:]}")
    log(f"[wire] second process: {out.stdout.strip()} ({second_s:.3f} s)")
    got = ctx.get(h)  # on the card of the handle's row
    if got.device != plane.device_of(h) or not torch.equal(got, _pattern(n, got.device)):
        raise AssertionError("the controller does not read the relayed bytes")
    relayed = {k: v - served[k] for k, v in ctx._remote._plane_server.served.items()}
    if relayed["PLANE_PUT"] < 1 or relayed["PLANE_GET"] < 1:
        raise AssertionError(f"no relay through the plane server: {relayed}")
    for x in hs:
        ctx.free(x)
    return {"handles": count, "nbytes": n, "rows": where, "relayed": relayed,
            "second_process_s": second_s}


# Check (f)'s sizes: the demo app's journey at the first, the library's
# own put and get at both, the last the handle's size.
WIRE_LIBOCM = (16 * MiB, 128 * MiB)
WIRE_LIBOCM_SEED = 17  # the bytes check (f) puts through the library
_KIND_REMOTE_DEVICE = 2  # ocm_client.h OCMC_KIND_REMOTE_DEVICE


def wire_libocm(cl, device, row_bytes: int, sizes=WIRE_LIBOCM, reps: int = 3,
                check_launches: bool = True) -> dict:
    """Check (f): the C client library's device leg on the card. Builds
    ``libocm_tpu.so`` and ``ocm_c_demo``; a controller at rank 0 serves an
    ``IciDataPlane`` of 4 ``row_bytes`` rows on ``device`` (two a rank, as
    the daemons book them). With the launch counts from 0: the demo app,
    a process of its own holding no card, runs its three journeys on
    REMOTE_DEVICE at ``sizes[0]`` bytes; then the library, through ctypes
    in this process at rank 1, allocates ``sizes[-1]`` bytes of
    REMOTE_DEVICE and puts and gets each size ``reps`` times (timed),
    ending with ``sizes[-1]`` seeded bytes in the handle. K1 and K2 must
    have launched once a relayed PLANE_PUT and PLANE_GET. Then the
    controller's ``ctx.get`` of the handle, on its card row, and the
    library's ``ocmc_get`` must both return those bytes, and a plane-less
    Python client at rank 1 times the same puts and gets beside the
    library's."""
    import ctypes

    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.core.arena import Extent
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.ops.ici import IciDataPlane
    from oncilla_tpu_torch.runtime.cluster import (BUILD_DIR, OcmcHandle, build_lib,
                                                   load_lib)

    t_check = time.perf_counter()
    lib = load_lib(build_lib())
    build_s = time.perf_counter() - t_check
    plane = IciDataPlane(ocm.OcmConfig(device_arena_bytes=row_bytes),
                         devices=[device] * 4, devices_per_rank=2)
    ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=cl.nodefile, rank=0,
                                     host_arena_bytes=MiB, device_arena_bytes=MiB),
                       device=device, ici_plane=plane)
    server = ctx._remote._plane_server
    n = sizes[-1]
    data = np.random.default_rng(WIRE_LIBOCM_SEED).integers(0, 256, n, dtype=np.uint8)
    out = np.zeros(n, dtype=np.uint8)
    vp = ctypes.c_void_p

    def check(rc, what):
        if rc != 0:
            raise AssertionError(f"libocm {what}: {lib.ocmc_last_error(lctx)}")

    lctx = None
    try:
        # The main path: counts from 0 just before, read just after.
        served = dict(server.served)
        dma.reset_launches()
        t0 = time.perf_counter()
        demo = subprocess.run(
            [str(BUILD_DIR / "ocm_c_demo"), cl.nodefile, "1", str(sizes[0]), "2",
             "device"], capture_output=True, text=True, timeout=300,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        demo_s = time.perf_counter() - t0
        if demo.returncode != 0 or demo.stdout.count("pass:") != 3:
            raise AssertionError(f"ocm_c_demo exited {demo.returncode}:\n"
                                 f"{demo.stdout[-3000:]}{demo.stderr[-3000:]}")
        lctx = lib.ocmc_init(cl.nodefile.encode(), 1, 0.0)
        if not lctx:
            raise AssertionError(f"ocmc_init: {lib.ocmc_last_error(None)}")
        h = OcmcHandle()
        check(lib.ocmc_alloc(lctx, n, _KIND_REMOTE_DEVICE, ctypes.byref(h)), "alloc")
        rates = []
        for m in sizes:
            src, dst = vp(data.ctypes.data), vp(out.ctypes.data)
            rec = {"nbytes": m, "reps": reps}
            for name, fn in (("c_put", lambda: check(lib.ocmc_put(
                    lctx, ctypes.byref(h), src, m, 0), "put")),
                             ("c_get", lambda: check(lib.ocmc_get(
                    lctx, ctypes.byref(h), dst, m, 0), "get"))):
                rec[name + "_gbps"] = m / _median_s(fn, reps, device) / 1e9
            if not np.array_equal(out[:m], data[:m]):
                raise AssertionError(f"libocm get of {m} B differs from its put")
            rates.append(rec)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rose = dma.launches()
        relayed = {k: v - served[k] for k, v in server.served.items()}
        if relayed["PLANE_PUT"] < 1 or relayed["PLANE_GET"] < 1:
            raise AssertionError(f"no relay through the plane server: {relayed}")
        if check_launches and (rose["write_rows"] != relayed["PLANE_PUT"]
                               or rose["read_rows"] != relayed["PLANE_GET"]):
            raise AssertionError(f"relayed ops {relayed} but launches {rose}")

        # The controller's view of the library's handle, on the card row.
        view = ocm.OcmAlloc(alloc_id=h.alloc_id, kind=ocm.OcmKind.REMOTE_DEVICE,
                            fabric=ocm.Fabric.ICI, nbytes=n, rank=h.rank,
                            device_index=h.device_index, extent=Extent(h.offset, n),
                            origin_rank=1)
        view.daemon_owned = True
        got = ctx.get(view)
        want = torch.from_numpy(data).to(got.device)
        if got.device != plane.device_of(view) or not torch.equal(got, want):
            raise AssertionError("the controller does not read the library's bytes")
        out[:] = 0
        check(lib.ocmc_get(lctx, ctypes.byref(h), vp(out.ctypes.data), n, 0), "get")
        if not np.array_equal(out, data):
            raise AssertionError("ocmc_get does not return the bytes put")

        # A plane-less Python client on the same handle, for the rates beside.
        py = cl.client(1, heartbeat=False, app_id=os.getpid() + (2 << 32))
        host = torch.from_numpy(data)
        for rec in rates:
            m = rec["nbytes"]
            rec["py_put_gbps"] = m / _median_s(
                lambda: py.put(view, host[:m], 0), reps, device) / 1e9
            rec["py_get_gbps"] = m / _median_s(
                lambda: py.get(view, m, 0), reps, device) / 1e9
        check(lib.ocmc_free(lctx, ctypes.byref(h)), "free")
    finally:
        if lctx:
            lib.ocmc_tini(lctx)
        ctx.tini()
    if any(cl.status(r)["live_allocs"] for r in range(2)):
        raise AssertionError("allocations left after the library's free")
    return {"build_s": build_s, "demo": {"nbytes": sizes[0], "seconds": demo_s,
                                         "passes": demo.stdout.count("pass:")},
            "nbytes": n, "rows": [h.rank, h.device_index], "rates": rates,
            "relayed": relayed, "launches": rose,
            "seconds": time.perf_counter() - t_check}


def phase_wire(device, *, row_bytes: int = WIRE_ROW, host_bytes=WIRE_HOST,
               sizes=WIRE_SIZES, matrix_bytes: int = PAGE, timed=(PAGE, GiB),
               reps: int = 5, alloc_iters: int = 200, placed=(PAGE, 4),
               libocm=WIRE_LIBOCM, concurrent=(16 * MiB, 4), engine=None,
               check_launches: bool = True) -> dict:
    """Phase 8, the wire: two daemons of the port's copy
    (``runtime/cluster.local_cluster(2)``), a 4-row ``SpmdIciPlane`` of
    ``row_bytes`` rows on the card, and the app ``ocm_init(OcmConfig(
    nodefile=..., rank=0), ici_plane=plane)``. Checks (a) REMOTE_HOST at
    ``sizes``, (a2) two threads' card-tensor transfers at once of
    ``concurrent`` = (bytes, rounds) (:func:`wire_concurrent`), (b) the copy matrix at ``matrix_bytes``, (c) daemon-placed
    REMOTE_DEVICE handles with a plane-less second process, (d) the typed
    errors, and, given ``engine`` (``dict(cfg=, params=, page_tokens=,
    runs=<phase 5b's runs, C and E among them>)``, optionally ``kw=``
    further ``phase_engine`` arguments), (e) serving runs F and G, E and C
    with their COLD tier on rank 1 behind a client that declares PRIO_LOW
    (:func:`check_remote_cold`), and (f) the C client library at
    ``libocm`` sizes (:func:`wire_libocm`). Raises on the first check that
    fails."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.qos.policy import PRIO_LOW
    from oncilla_tpu_torch.runtime.cluster import build_daemon, local_cluster
    from oncilla_tpu_torch.runtime.protocol import ErrCode

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    build_s = time.perf_counter()
    build_daemon()
    build_s = time.perf_counter() - build_s
    gen = torch.Generator(device=device).manual_seed(7)
    report = {"build_s": build_s}
    with local_cluster(2, ndevices=2, device_arena_bytes=row_bytes,
                       host_arena_bytes=list(host_bytes)) as cl:
        plane, ctx = wire_context(cl, [device] * 4, row_bytes,
                                  4 * matrix_bytes + MiB)
        if ctx.status()["nnodes"] != 2:
            raise AssertionError(f"rank 0 sees {ctx.status()['nnodes']} nodes")
        log(f"[wire] daemons up, daemon build {build_s:.3f} s; rows "
            f"{row_bytes} B, host arenas {list(host_bytes)} B")
        # The main path: counts from 0 just before, read just after.
        dma.reset_launches()

        # (a) REMOTE_HOST: every size lands on rank 1 and comes back.
        for n in sizes:
            h = ctx.alloc(n, OcmKind.REMOTE_HOST)
            if h.rank != 1 or not h.is_remote:
                raise AssertionError(f"REMOTE_HOST {n} B placed on rank {h.rank}")
            live = ctx.status(1)
            if live["live_allocs"] != 1 or live["host_bytes_live"] < n:
                raise AssertionError(f"rank 1 STATUS misses the allocation: {live}")
            data = torch.empty(n, dtype=torch.uint8, device=device).random_(
                0, 256, generator=gen)
            ctx.put(h, data)
            if not torch.equal(ctx.get(h).to(device), data):
                raise AssertionError(f"REMOTE_HOST {n} B: get differs from put")
            off = min(4096 + 100, n // 2)
            m = n - off
            into = torch.empty(m, dtype=torch.uint8, device=device)
            if not torch.equal(ctx.get(h, offset=off, out=into), data[off:]):
                raise AssertionError(f"REMOTE_HOST {n} B: get(out=card) at {off}")
            pinned = torch.empty(m, dtype=torch.uint8, pin_memory=on_card)
            ctx.get(h, offset=off, out=pinned)
            if not torch.equal(pinned.to(device), data[off:]):
                raise AssertionError(f"REMOTE_HOST {n} B: get(out=pinned) at {off}")
            ctx.put(h, data[:m // 2], offset=off)
            if not torch.equal(ctx.get(h, m // 2, offset=off).to(device), data[:m // 2]):
                raise AssertionError(f"REMOTE_HOST {n} B: put at offset {off}")
            ctx.free(h)
            if ctx.status(1)["live_allocs"] != 0:
                raise AssertionError(f"REMOTE_HOST {n} B still live after free")
            del data, into, pinned
        log(f"[wire] (a) REMOTE_HOST at {list(sizes)} B: on rank 1, byte-equal "
            "(whole, at offsets, into card and pinned buffers), STATUS live "
            "then gone")
        report["concurrent"] = wire_concurrent(ctx, device, gen, *concurrent)
        log(f"[wire] (a2) two threads, card-tensor put and get at once, "
            f"byte-equal: {json.dumps(report['concurrent'])}")

        # (b) the copy matrix, every pair of the four kinds.
        n = matrix_bytes
        data = torch.empty(n, dtype=torch.uint8, device=device).random_(
            0, 256, generator=gen)
        matrix = {}
        for sk in _KINDS:
            for dk in _KINDS:
                src = ctx.alloc(n, OcmKind[sk])
                dst = ctx.alloc(n, OcmKind[dk])
                ctx.put(src, data)
                before, gets = dma.launches(), plane.stats["gets"]
                ctx.copy(dst, src)
                if on_card:
                    torch.cuda.synchronize(device)
                after, got_gets = dma.launches(), plane.stats["gets"]
                rose = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                if not torch.equal(ctx.get(dst).to(device), data):
                    raise AssertionError(f"copy {sk} -> {dk}: bytes differ")
                want = set()
                if sk == dk == "LOCAL_DEVICE":
                    want = {"local_copy"}
                elif sk == dk == "REMOTE_DEVICE":
                    want = {"onesided_copy"}
                    if got_gets != gets:
                        raise AssertionError("REMOTE_DEVICE -> REMOTE_DEVICE went through get")
                else:
                    if sk == "LOCAL_DEVICE":
                        want.add("read_rows")
                    if dk == "LOCAL_DEVICE":
                        want.add("write_rows")
                if check_launches and not want <= set(rose):
                    raise AssertionError(f"copy {sk} -> {dk}: launches {rose}, "
                                         f"want {sorted(want)}")
                matrix[f"{sk}->{dk}"] = rose
                ctx.free(src)
                ctx.free(dst)
        del data
        log(f"[wire] (b) copy matrix at {n} B, 16 pairs byte-equal; launches "
            f"by pair: {json.dumps(matrix)}")

        # (c) REMOTE_DEVICE placed by the daemons, and the relay.
        report["placed"] = wire_placed(ctx, plane, cl.nodefile, *placed)
        log(f"[wire] (c) {json.dumps(report['placed'])}")

        # (d) the typed errors.
        h = ctx.alloc(4096, OcmKind.REMOTE_HOST)
        d = ctx.alloc(4096, OcmKind.REMOTE_DEVICE)
        big = torch.zeros(8192, dtype=torch.uint8, device=device)
        errs = {
            "remote_host_past_end": _expect_code(
                ocm.OcmRemoteError, ErrCode.BOUNDS, lambda: ctx.put(h, big)),
            "remote_device_past_end": _expect_code(
                ocm.OcmBoundsError, None, lambda: ctx.put(d, big)),
            "alloc_past_rank1_arena": _expect_code(
                ocm.OcmRemoteError, ErrCode.PLACEMENT,
                lambda: ctx.alloc(host_bytes[1] + MiB, OcmKind.REMOTE_HOST)),
        }
        ctx.free(d)
        errs["double_free"] = _expect_code(ocm.OcmInvalidHandle, None,
                                           lambda: ctx.free(d))
        log(f"[wire] (d) typed errors: {json.dumps(errs)}")

        # Latency and rates of the REMOTE_HOST arm.
        lat = {"alloc": [], "free": []}
        for _ in range(alloc_iters):
            t0 = time.perf_counter()
            x = ctx.alloc(4096, OcmKind.REMOTE_HOST)
            t1 = time.perf_counter()
            ctx.free(x)
            lat["alloc"].append(t1 - t0)
            lat["free"].append(time.perf_counter() - t1)
        report["alloc_p50_us"] = statistics.median(lat["alloc"]) * 1e6
        report["free_p50_us"] = statistics.median(lat["free"]) * 1e6
        rates = []
        for n in timed:
            r = ctx.alloc(n, OcmKind.REMOTE_HOST)
            card = torch.empty(n, dtype=torch.uint8, device=device).random_(
                0, 256, generator=gen)
            host = torch.empty(n, dtype=torch.uint8, pin_memory=on_card)
            host.copy_(card)
            dev_out = torch.empty(n, dtype=torch.uint8, device=device)
            rec = {"nbytes": n, "reps": reps}
            for name, fn in (
                ("put_from_card", lambda: ctx.put(r, card)),
                ("put_from_pinned", lambda: ctx.put(r, host)),
                ("get_to_card", lambda: ctx.get(r, out=dev_out)),
                ("get_to_pinned", lambda: ctx.get(r, out=host)),
                ("yardstick_pinned_to_card_copy", lambda: dev_out.copy_(host)),
            ):
                rec[name + "_gbps"] = n / _median_s(fn, reps, device) / 1e9
            if not torch.equal(dev_out, card):
                raise AssertionError(f"timed REMOTE_HOST {n} B: bytes differ")
            rates.append(rec)
            log(f"[wire] REMOTE_HOST rates (median of {reps}): {json.dumps(rec)}")
            ctx.free(r)
            del card, host, dev_out
        report["rates"] = rates
        log(f"[wire] alloc p50 {report['alloc_p50_us']:.3f} us, free p50 "
            f"{report['free_p50_us']:.3f} us through the daemons "
            f"({alloc_iters} of each)")

        # Use after tini: the handle is freed with the context.
        h2 = ctx.alloc(4096, OcmKind.REMOTE_HOST)
        ctx.free(h)
        ctx.tini()
        errs["use_after_tini"] = _expect_code(ocm.OcmInvalidHandle, None,
                                              lambda: ctx.get(h2))
        if on_card:
            torch.cuda.synchronize(device)
        report["launches"] = dma.launches()
        report["errors"] = errs
        report["matrix_launches"] = matrix
        if any(cl.status(r)["live_allocs"] for r in range(2)):
            raise AssertionError("allocations left after tini")

        # (e) the engine with its COLD tier on rank 1 and 2 WARM pages: run
        # F as E (the engine as shipped), run G as C (synchronous faults, so
        # its seating is C's and its tokens must be C's bit for bit).
        if engine is not None:
            cold = CheckedCold(cl.client(0, config=dataclasses.replace(
                ocm.OcmConfig(), priority=PRIO_LOW), app_id=os.getpid() + (1 << 32)))
            ref = engine["runs"]
            fg = phase_engine(device, engine["cfg"], engine["params"],
                              page_tokens=engine["page_tokens"],
                              runs=(("F", *ref["E"]["settings"]),
                                    ("G", *ref["C"]["settings"])),
                              cold_backend=cold,
                              **{"warm": WIRE_WARM, **engine.get("kw", {})})["runs"]
            report["engine"] = check_remote_cold(ref, fg, cold, [
                cl.status(r)["live_allocs"] for r in range(2)], check_launches)
            log(f"[wire] (e) runs F and G: {json.dumps(report['engine'])}")
            report["launches"] = {k: v + fg["F"]["launches"][k] + fg["G"]["launches"][k]
                                  for k, v in report["launches"].items()}

        # (f) the C client library's device leg, on the same daemons.
        report["libocm"] = lib = wire_libocm(cl, device, row_bytes, libocm,
                                             check_launches=check_launches)
        report["build_s"] += lib["build_s"]
        log(f"[wire] (f) libocm in {lib['seconds']:.3f} s: build "
            f"{lib['build_s']:.3f} s, ocm_c_demo on "
            f"REMOTE_DEVICE at {lib['demo']['nbytes']} B {lib['demo']['passes']} "
            f"passes in {lib['demo']['seconds']:.3f} s; {lib['nbytes']} B put by C "
            f"read back bit for bit by the controller on row {lib['rows']} and by "
            f"ocmc_get; relayed {json.dumps(lib['relayed'])}, launches "
            f"{json.dumps(lib['launches'])}; GB/s (median of 3) "
            f"{json.dumps(lib['rates'])} beside check (c)'s plane-less Python "
            f"process ({report['placed']['nbytes']} B, "
            f"{report['placed']['second_process_s']:.3f} s)")
    if on_card:
        torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[wire] phase {report['seconds']:.3f} s; launches {report['launches']}")
    return report


class CheckedCold:
    """The COLD tier's daemon client with every page it serves checked: a
    host copy of the bytes put under each handle, against which each get is
    compared on whatever thread it comes (the engine's or a prefetch
    worker's). ``checked`` counts the gets compared, ``mismatched`` those
    that did not return the bytes put. Runs behind it carry the copy's and
    the comparison's cost in their tokens/s."""

    def __init__(self, client):
        self.client = client
        self.checked = self.mismatched = self.async_checked = 0
        self._shadow: dict = {}
        self._mu = threading.Lock()

    def __getattr__(self, name):
        # What else the engine reads of its cold client (a mux client's
        # runtime, rows, rank and config, for the AsyncOcm prefetch leg).
        return getattr(self.client, name)

    @property
    def transfers(self) -> dict:
        return self.client.transfers

    def wrap_prefetcher(self, prefetcher) -> None:
        """Check the pages of a prefetcher's AsyncOcm leg too: they come
        through the mux runtime's own AsyncOcm, not through this client,
        and are compared on the event loop as each lands (``async_checked``
        counts them)."""
        if prefetcher._aocm is not None:
            prefetcher._aocm = _CheckedAsync(prefetcher._aocm, self)

    def _page(self, handle) -> torch.Tensor:
        with self._mu:
            return self._shadow[(handle.rank, handle.alloc_id)]

    def alloc(self, nbytes: int, kind):
        h = self.client.alloc(nbytes, kind)
        with self._mu:
            self._shadow[(h.rank, h.alloc_id)] = torch.empty(nbytes, dtype=torch.uint8)
        return h

    def free(self, handle) -> None:
        self.client.free(handle)
        with self._mu:
            del self._shadow[(handle.rank, handle.alloc_id)]

    def put(self, handle, data, offset: int = 0) -> None:
        from oncilla_tpu_torch.core.hostmem import as_byte_tensor

        self.client.put(handle, data, offset)
        raw = as_byte_tensor(data)
        self._page(handle)[offset:offset + raw.numel()].copy_(raw)

    def get(self, handle, nbytes: int, offset: int = 0):
        return self._check(handle, self.client.get(handle, nbytes, offset), offset)

    def get_into(self, handle, out, offset: int = 0):
        return self._check(handle, self.client.get_into(handle, out, offset), offset)

    def _check(self, handle, got: torch.Tensor, offset: int,
               leg: str = "checked") -> torch.Tensor:
        flat = got.reshape(-1).cpu()
        same = torch.equal(flat, self._page(handle)[offset:offset + flat.numel()])
        with self._mu:
            setattr(self, leg, getattr(self, leg) + 1)
            self.mismatched += not same
        return got


class _CheckedAsync:
    """An ``AsyncOcm`` whose every get is compared, host bytes only, with
    the bytes :class:`CheckedCold` kept for the handle."""

    def __init__(self, inner, cold: CheckedCold):
        self.inner, self.cold = inner, cold

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def get(self, handle, nbytes=None, offset: int = 0, out=None, **kw):
        got = await self.inner.get(handle, nbytes, offset, out=out, **kw)
        flat = torch.from_numpy(np.asarray(got)) if not isinstance(
            got, torch.Tensor) else got
        self.cold._check(handle, flat, offset, leg="async_checked")
        return got


def check_remote_cold(ref: dict, runs: dict, cold, drained: list,
                      check_launches: bool = True, names=("F", "G"),
                      mode: str = "thread") -> dict:
    """Check (e) of phase 8: runs F (E's settings) and G (C's) with the COLD
    tier behind ``cold``, against phase 5b's E and C (``ref``). G's tokens
    equal C's bit for bit (its seating is C's: tier placement changes no
    bit); F's, seated by its workers' timing, equal E's and t1's equal t0's
    by check d's margin rule (:func:`_hold_margin`); every page ``cold``
    (a :class:`CheckedCold`) served is the bytes put; the COLD tier is
    remote in both, its puts and gets the client's wire transfers; every
    HOT put and get one K1/K2 launch; no allocation left (``drained``).
    Phase 8c's runs H and I (``names``) are held the same way, H's
    prefetcher in ``mode`` "async" with every page its AsyncOcm leg read
    checked too. Returns the report."""
    fn, gn = names
    f, g = runs[fn], runs[gn]
    emitted = sum(len(v) for v in ref["C"]["out"].values())
    wire = {op: f["io"]["remote"][op] + g["io"]["remote"][op] for op in ("put", "get")}
    f_vs_e = _margin_check(ref["E"]["rows"], f["rows"])
    fl, gl = fn.lower(), gn.lower()
    out = {
        "tok_s": {"C": ref["C"]["tok_s"], "E": ref["E"]["tok_s"],
                  fn: f["tok_s"], gn: g["tok_s"]},
        f"{gl}_vs_c_tokens_equal": sum(
            x == y for t in ref["C"]["out"]
            for x, y in zip(ref["C"]["out"][t], g["out"].get(t, []))),
        f"{fl}_vs_e_tokens_equal": sum(
            x == y for t in ref["E"]["out"]
            for x, y in zip(ref["E"]["out"][t], f["out"].get(t, []))),
        "tokens": emitted, f"{fl}_vs_e": f_vs_e, f"{fl}_t0_vs_t1": f["t0_vs_t1"],
        "cold_sim": [f["cold_sim"], g["cold_sim"]],
        "cold_io": {fn: f["io"]["remote"], gn: g["io"]["remote"]},
        "client_transfers": dict(cold.transfers),
        "cold_pages_checked": cold.checked,
        "cold_pages_checked_async": cold.async_checked,
        "cold_pages_mismatched": cold.mismatched,
        "hot_io": {fn: f["hot_io"], gn: g["hot_io"]},
        "launches": {n: {k: r["launches"][k] for k in ("write_rows", "read_rows")}
                     for n, r in ((fn, f), (gn, g))},
        "moves": {fn: f["moves"], gn: g["moves"]},
        "prefetch": f["prefetch"], "drained": drained,
    }
    if g["out"] != ref["C"]["out"]:
        raise AssertionError(f"run {gn}'s tokens differ from run C's: "
                             f"{out[f'{gl}_vs_c_tokens_equal']} of {emitted}")
    for name, d in ((f"{fn} against E", f_vs_e),
                    (f"{fn}'s t1 against t0", f["t0_vs_t1"])):
        _hold_margin(name, d)
    if cold.mismatched or cold.checked != wire["get"]:
        raise AssertionError(f"COLD pages read back over the wire: "
                             f"{cold.checked} checked of {wire['get']}, "
                             f"{cold.async_checked} on the AsyncOcm leg, "
                             f"{cold.mismatched} not the bytes put")
    if mode == "async" and not 0 < cold.async_checked <= f["prefetch"]["issued"]:
        raise AssertionError(f"run {fn}'s AsyncOcm leg: {cold.async_checked} pages "
                             f"checked of {f['prefetch']['issued']} prefetches")
    if f["emitted"] != emitted or f["prefetch"]["mode"] != mode:
        raise AssertionError(f"run {fn}: {f['emitted']} tokens, prefetch "
                             f"{f['prefetch']}, want mode {mode}")
    for name, r in ((fn, f), (gn, g)):
        io = r["io"]["remote"]
        # An async run may read every COLD page on its AsyncOcm leg.
        gets = io["get"] + (cold.async_checked if name == fn else 0)
        if r["cold_sim"] or not (io["put"] > 0 and gets > 0):
            raise AssertionError(f"run {name}'s COLD tier is not remote: {io}, "
                                 f"{gets} COLD reads in all")
        if check_launches and (r["launches"]["write_rows"], r["launches"]["read_rows"]) \
                != (r["hot_io"]["put"], r["hot_io"]["get"]):
            raise AssertionError(f"run {name}: K1/K2 launches {r['launches']} != "
                                 f"HOT puts/gets {r['hot_io']}")
    if (wire["put"], wire["get"]) != (cold.transfers["put"], cold.transfers["get"]):
        raise AssertionError(f"COLD puts/gets {wire} != the client's wire "
                             f"transfers {cold.transfers}")
    if any(drained):
        raise AssertionError(f"the daemons hold allocations after the stores "
                             f"closed: {drained}")
    return out


def _expect_code(exc, code, fn) -> str:
    """Run ``fn``, which must raise ``exc`` (with wire ``code`` when given);
    returns what was raised, for the log."""
    try:
        fn()
    except exc as e:
        got = getattr(e, "code", None)
        if code is not None and got != int(code):
            raise AssertionError(f"{exc.__name__} with code {got}, want {int(code)}") from e
        return type(e).__name__ + (f" {code.name}" if code is not None else "")
    raise AssertionError(f"{exc.__name__} was not raised")


# -- phase 8b ---------------------------------------------------------------

# The Python daemons of the port (``python -m oncilla_tpu_torch.runtime.
# daemon``), run by ``local_cluster(..., daemon="python")``. (a)-(c) on two
# of them, sized as phase 8's native pair; (d) on three with the resilient
# control plane armed and a fast detector (the reaper ticks every
# ``PY_HEARTBEAT_S``; a rank is DEAD after two failed probes 100 ms apart).
# A killed daemon refuses a probe at once; the probe's timeout stays the
# default 1 s, so a live peer slowed by a loaded host has a second to
# answer.
PY_SIZES = (4 * KiB, PAGE, 256 * MiB, GiB)
PY_KV = (256, 32)  # (c): teacher-forced prompt tokens, then greedy tokens
PY_HANDLES = (16, 2 * MiB)  # (d): REMOTE_HOST handles put before the kill
PY_HEARTBEAT_S = 0.2
PY_RESILIENT_ENV = {
    "OCM_STANDBY_MASTERS": "2", "OCM_PLACEMENT": "hash", "OCM_REPLICAS": "2",
    "OCM_DETECT_INTERVAL_MS": "100", "OCM_SUSPECT_AFTER": "1",
    "OCM_DEAD_AFTER": "2",
}
# (d)'s budget from the SIGKILL of the leader to ranks 1 and 2 agreeing on
# its successor: dead_after probes at the detector's interval, a reaper
# tick or two to act on the verdict, the election's broadcast; two orders
# of magnitude of slack for a loaded host.
PY_ELECTION_BUDGET_S = 15.0


def _card_fds(pid: int) -> list[str]:
    """The card's device nodes a process holds open (``/dev/nvidia<N>``,
    ``/dev/nvidia-uvm``): a CUDA context opens them, importing torch does
    not."""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            path = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if path.startswith("/dev/nvidia") and path != "/dev/nvidiactl":
            out.add(path)
    return sorted(out)


def _holds_no_card(pids: list[int]) -> dict:
    """Check (f): no daemon process holds a CUDA context. None of ``pids``
    is among ``nvidia-smi``'s compute apps, and none holds the card's
    device nodes open. This process, which holds a context on the card,
    is the positive control of both where it runs on one."""
    out = {"pids": pids, "self_pid": os.getpid()}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        apps = {int(x) for x in smi.stdout.split() if x.strip().isdigit()}
        out["compute_apps"] = sorted(apps)
        out["self_listed"] = os.getpid() in apps
        if apps & set(pids):
            raise AssertionError(f"daemon pids hold the card: {sorted(apps & set(pids))}")
    except FileNotFoundError:
        out["compute_apps"] = "nvidia-smi absent"
    out["self_card_fds"] = _card_fds(os.getpid())
    held = {pid: _card_fds(pid) for pid in pids}
    if any(held.values()):
        raise AssertionError(f"daemon processes hold the card open: {held}")
    out["daemon_card_fds"] = []
    return out


def phase_daemons_py(device, *, wire=None, engine=None, row_bytes: int = WIRE_ROW,
                     host_bytes=WIRE_HOST, sizes=PY_SIZES, timed=(PAGE, GiB),
                     reps: int = 5, alloc_iters: int = 200, kv=PY_KV,
                     handles=PY_HANDLES, heartbeat_s: float = PY_HEARTBEAT_S,
                     election_budget_s: float = PY_ELECTION_BUDGET_S,
                     check_launches: bool = True) -> dict:
    """Phase 8b, the Python daemons. (a) REMOTE_HOST through two port
    Python daemons at ``sizes``, byte for byte, GB/s at ``timed`` (median
    of ``reps``) and alloc/free p50 over ``alloc_iters``, beside phase 8's
    native figures (``wire``); (b) a daemon-placed REMOTE_DEVICE page
    through the app's ``IciDataPlane`` (per-device arenas, where a put is a
    K1 launch and a get a K2 launch) and a plane-less second process whose
    put and get the daemons relay, K1/K2 rising by exactly the relayed ops,
    then one copy between two such handles on a ``SpmdIciPlane``, one K4
    launch; (c) given ``engine`` (``dict(cfg=, params=, page_tokens=)``),
    one request of ``kv`` tokens through ``BucketedPagedDecoder`` with
    REMOTE_DEVICE pages and with REMOTE_HOST pages, logits and tokens equal
    the unpaged ``decode_step`` bit for bit, one K1 a page stored and one
    K2 a page fetched; (d) three daemons with ``PY_RESILIENT_ENV``: the
    leader SIGKILLed, ranks 1 and 2 agree on its successor within
    ``election_budget_s``, allocations land, every handle's bytes read
    back through ``ctx.get`` (those whose primary died by the client's
    failover to its promoted replica); (e) a PRIO_LOW client's CONNECT granted FLAG_CAP_QOS, its
    profile in the daemon's STATUS, where the native daemon declines; (f)
    no daemon holds the card (:func:`_holds_no_card`). Raises on the first
    check that fails."""
    import dataclasses as dc

    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.ops.ici import IciDataPlane, SpmdIciPlane
    from oncilla_tpu_torch.qos.policy import PRIO_LOW
    from oncilla_tpu_torch.runtime.cluster import local_cluster
    from oncilla_tpu_torch.runtime.protocol import FLAG_CAP_QOS

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(81)
    report = {}
    launches = {k: 0 for k in dma.launches()}

    def counted(fn):
        """Run ``fn`` with the launch counts zeroed just before and read
        just after; the phase's counts add them up."""
        dma.reset_launches()
        out = fn()
        sync()
        got = dma.launches()
        for k, v in got.items():
            launches[k] += v
        return out, got

    t0 = time.perf_counter()
    with local_cluster(2, daemon="python", ndevices=2, device_arena_bytes=row_bytes,
                       host_arena_bytes=list(host_bytes)) as cl:
        start_s = time.perf_counter() - t0
        plane = IciDataPlane(ocm.OcmConfig(device_arena_bytes=row_bytes),
                             devices=[device] * 4, devices_per_rank=2)
        ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=cl.nodefile, rank=0,
                                         host_arena_bytes=64 * MiB,
                                         device_arena_bytes=64 * MiB),
                           device=device, ici_plane=plane)
        if ctx.status()["nnodes"] != 2:
            raise AssertionError(f"rank 0 sees {ctx.status()['nnodes']} nodes")
        log(f"[daemons_py] two Python daemons up in {start_s:.3f} s (pids "
            f"{cl.pids()})")

        # (a) REMOTE_HOST, byte for byte; GB/s and alloc/free p50.
        counted(lambda: _remote_host_legs(ctx, device, gen, sizes,
                                          "the Python daemons", rank=1))
        report["remote_host"] = {
            "sizes": list(sizes), "start_s": start_s,
            **_rates(ctx, device, gen, timed, reps, alloc_iters)}
        if wire is not None:
            report["remote_host"]["native"] = {
                "rates": [{k: r[k] for k in ("nbytes", "put_from_card_gbps",
                                             "get_to_card_gbps")} for r in wire["rates"]],
                "alloc_p50_us": wire["alloc_p50_us"],
                "free_p50_us": wire["free_p50_us"]}
        log(f"[daemons_py] (a) REMOTE_HOST at {list(sizes)} B byte-equal; "
            f"{json.dumps(report['remote_host'])}")

        # (b) a daemon-placed REMOTE_DEVICE page through the relay.
        n = min(PAGE, row_bytes // 4)
        hs = [ctx.alloc(n, OcmKind.REMOTE_DEVICE) for _ in range(2)]
        if not all(h.daemon_owned for h in hs):
            raise AssertionError("REMOTE_DEVICE handles not placed by the daemons")
        for h in hs:
            if int(torch.count_nonzero(ctx.get(h))) != 0:
                raise AssertionError(f"handle {h.alloc_id} did not read as zeros")
        h = hs[0]
        server = ctx._remote._plane_server
        served = dict(server.served)
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}

        def relay():
            return subprocess.run(
                [sys.executable, "-c", _PLANELESS, cl.nodefile, str(h.alloc_id),
                 str(h.rank), str(h.device_index), str(h.extent.offset), str(n)],
                capture_output=True, text=True, timeout=300, env=env)
        out, rose = counted(relay)
        if out.returncode != 0:
            raise AssertionError(f"the plane-less process failed:\n{out.stderr[-3000:]}")
        relayed = {k: v - served[k] for k, v in server.served.items()}
        if relayed["PLANE_PUT"] < 1 or relayed["PLANE_GET"] < 1:
            raise AssertionError(f"no relay through the plane server: {relayed}")
        if check_launches and (rose["write_rows"] != relayed["PLANE_PUT"]
                               or rose["read_rows"] != relayed["PLANE_GET"]):
            raise AssertionError(f"relayed ops {relayed} but launches {rose}")
        if not torch.equal(ctx.get(h).to(device), _pattern(n, device)):
            raise AssertionError("the controller does not read the relayed bytes")
        for x in hs:
            ctx.free(x)
        report["placed"] = {"nbytes": n, "rows": sorted({(x.rank, x.device_index)
                                                         for x in hs}),
                            "relayed": relayed, "launches": rose}
        log(f"[daemons_py] (b) {json.dumps(report['placed'])}")

        # (c) KV pages through the daemons, REMOTE_DEVICE then REMOTE_HOST.
        if engine is not None:
            report["kv"] = _kv_through_daemons(
                device, engine, ctx, kv, counted, check_launches)
        ctx.tini()
        del plane
        report["no_card"] = _holds_no_card(cl.pids())

        # (b), the copy: K4 between two daemon-placed REMOTE_DEVICE handles
        # on a SpmdIciPlane, whose plane server the daemons now relay to.
        spmd = SpmdIciPlane(ocm.OcmConfig(device_arena_bytes=row_bytes),
                            mesh=[device] * 4, devices_per_rank=2)
        ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=cl.nodefile, rank=0,
                                         host_arena_bytes=64 * MiB,
                                         device_arena_bytes=64 * MiB),
                           device=device, ici_plane=spmd)
        src, dst = (ctx.alloc(n, OcmKind.REMOTE_DEVICE) for _ in range(2))
        data = torch.empty(n, dtype=torch.uint8, device=device).random_(
            0, 256, generator=gen)
        ctx.put(src, data)
        _, rose = counted(lambda: ctx.copy(dst, src))
        if check_launches and (rose["onesided_copy"] != 1
                               or sum(rose.values()) != 1):
            raise AssertionError(f"REMOTE_DEVICE copy launched {rose}, want one K4")
        if not torch.equal(ctx.get(dst).to(device), data):
            raise AssertionError("REMOTE_DEVICE copy: bytes differ")
        report["placed"]["copy"] = {"rows": [(src.rank, src.device_index),
                                             (dst.rank, dst.device_index)],
                                    "launches": rose}
        ctx.free(src)
        ctx.free(dst)
        ctx.tini()
        del spmd, data
        log(f"[daemons_py] (b) copy {json.dumps(report['placed']['copy'])}")

    # (d) the resilient control plane, and (e) QoS, on three daemons.
    report["resilient"] = _resilient_plane(device, gen, handles, heartbeat_s,
                                           election_budget_s, counted)
    report["qos"] = report["resilient"].pop("qos")
    report["no_card"]["pids"] += report["resilient"].pop("no_card")["pids"]
    report["resilient"].pop("pids")
    log(f"[daemons_py] (f) no daemon holds the card: {json.dumps(report['no_card'])}")
    with local_cluster(1) as cl:  # the native daemon declines QoS
        c = cl.client(0, config=dc.replace(ocm.OcmConfig(), priority=PRIO_LOW))
        native_caps = c._ctrl_caps
    if native_caps & FLAG_CAP_QOS:
        raise AssertionError("the native daemon granted FLAG_CAP_QOS")
    report["qos"]["native_caps"] = native_caps
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[daemons_py] phase {report['seconds']:.3f} s; launches {launches}")
    return report


def _kv_through_daemons(device, engine, ctx, kv, counted, check_launches) -> dict:
    """Check (c) of phase 8b: one request of ``kv`` = (prompt, greedy)
    tokens through ``BucketedPagedDecoder`` (refetch) with its pages
    REMOTE_DEVICE, then REMOTE_HOST, on the daemons; logits and tokens equal
    the unpaged ``decode_step`` bit for bit; each REMOTE_DEVICE page stored
    is one K1 launch and each fetched one K2 launch (the plane's ``ici_put``
    and ``ici_get`` spans count the page moves); REMOTE_HOST pages ride the
    wire and launch neither."""
    from oncilla_tpu_torch.models import llama
    from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER

    cfg, params, page_tokens = engine["cfg"], engine["params"], engine["page_tokens"]
    prompt_len, n_gen = kv
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, prompt_len)).to(device)
    npages = (prompt_len + n_gen) // page_tokens
    out, ref_ids, ref = {}, None, None
    for kind in ("REMOTE_DEVICE", "REMOTE_HOST"):
        moves0 = [GLOBAL_TRACER.stats(s).count for s in ("ici_put", "ici_get")]
        t = time.perf_counter()
        (ids, logits, shipped), rose = counted(lambda: serve_request(
            params, cfg, ctx, prompt, n_gen, page_tokens, kind))
        seconds = time.perf_counter() - t
        stored, fetched = (GLOBAL_TRACER.stats(s).count - m
                           for s, m in zip(("ici_put", "ici_get"), moves0))
        if shipped != npages:
            raise AssertionError(f"{kind}: {shipped} pages shipped, want {npages}")
        want = ((npages, npages * (npages + 1) // 2) if kind == "REMOTE_DEVICE"
                else (0, 0))
        if (stored, fetched) != want:
            raise AssertionError(f"{kind}: {stored} page stores and {fetched} "
                                 f"fetches on the plane, want {want}")
        if check_launches and (rose["write_rows"], rose["read_rows"]) != want:
            raise AssertionError(f"{kind}: launches {rose}, want write_rows, "
                                 f"read_rows = {want}")
        if ref is None:
            ref_ids, ref = ids, reference_logits(params, cfg, ids)
        if not torch.equal(ids, ref_ids):
            raise AssertionError(f"{kind}: greedy tokens differ")
        if not torch.equal(logits, ref):
            err = float((logits.float() - ref.float()).abs().max())
            raise AssertionError(f"{kind}: logits differ from the unpaged "
                                 f"decode (max |d| {err})")
        greedy = llama.greedy(ref[prompt_len - 1:-1])
        if not torch.equal(greedy, ids[prompt_len:]):
            raise AssertionError(f"{kind}: tokens are not the reference's greedy")
        out[kind] = {"tok_s": (prompt_len + n_gen) / seconds, "seconds": seconds,
                     "pages": shipped, "page_stores": stored,
                     "page_fetches": fetched, "launches": rose}
        log(f"[daemons_py] (c) {kind}: {json.dumps(out[kind])}")
    return out


def _healthy_cluster(n: int, *, host_arena_bytes: int, heartbeat_s: float,
                     out: dict, attempts: int = 3):
    """``n`` Python daemons with ``PY_RESILIENT_ENV`` whose members all
    stand: rank 0 leads at epoch 0, nobody is fenced and every probe
    answers. A daemon that starts listening later than two of the leader's
    probe intervals after the leader's first probe (importing torch takes
    seconds) is declared DEAD and then recovers, and the epoch has moved:
    the fast detector cannot tell a peer still starting from one that was
    killed (the JAX package's daemon does the same). Such a start is not
    the clean cluster check (d) assumes; it is thrown away and the cluster
    started again. The starts taken stand in ``out["starts"]``."""
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient
    from oncilla_tpu_torch.runtime.cluster import LocalCluster

    for attempt in range(1, attempts + 1):
        cl = LocalCluster(n, daemon="python", host_arena_bytes=host_arena_bytes,
                          device_arena_bytes=64 * MiB, heartbeat_s=heartbeat_s,
                          lease_s=300.0, env=PY_RESILIENT_ENV)
        time.sleep(10 * heartbeat_s)  # several probe rounds after the join
        c = ControlPlaneClient(cl.entries, 0, heartbeat=False)
        try:
            res = {r: c.status(r)["resilience"] for r in range(n)}
        finally:
            c.close()
        healthy = all(x["leader"] == 0 and x["epoch"] == 0 and not x["fenced"]
                      and set(x["peers"].values()) <= {"ALIVE"}
                      for x in res.values())
        out["starts"] = attempt
        if healthy:
            return cl
        log(f"[daemons_py] start {attempt} of {n} daemons came up with a "
            f"rank declared dead while starting; starting again: {res}")
        cl.stop()
    raise AssertionError(f"{attempts} starts of {n} daemons, none healthy")


def _resilient_plane(device, gen, handles, heartbeat_s: float,
                     budget_s: float, counted) -> dict:
    """Checks (d) and (e) of phase 8b, on three Python daemons with
    ``PY_RESILIENT_ENV``, the app on rank 1."""
    import dataclasses as dc

    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.qos.policy import PRIO_LOW
    from oncilla_tpu_torch.runtime.protocol import FLAG_CAP_QOS

    count, nb = handles
    out = {}
    cl = _healthy_cluster(3, host_arena_bytes=64 * MiB + 4 * count * nb,
                          heartbeat_s=heartbeat_s, out=out)
    with cl:
        out["pids"] = cl.pids()
        no_card = _holds_no_card(cl.pids())
        ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=cl.nodefile, rank=1,
                                         host_arena_bytes=64 * MiB,
                                         device_arena_bytes=64 * MiB,
                                         replicas=2),
                           device=device)
        pid = ctx._remote.pid
        # 16 replicated REMOTE_HOST handles (the client asks for k = 2 with
        # REQ_ALLOC's FLAG_REPLICAS tail), bytes put from the card.
        hs, datas = [], []
        for _ in range(count):
            h = ctx.alloc(nb, OcmKind.REMOTE_HOST)
            if not h.replica_ranks:
                raise AssertionError(f"handle {h.alloc_id} is not replicated")
            data = torch.empty(nb, dtype=torch.uint8, device=device).random_(
                0, 256, generator=gen)
            ctx.put(h, data)
            hs.append(h)
            datas.append(data.cpu())
        by_rank = {r: sum(h.rank == r for h in hs) for r in range(3)}
        if not by_rank[0]:
            raise AssertionError(f"no primary on rank 0 to fail over: {by_rank}")
        # SIGKILL the leader; ranks 1 and 2 must agree on its successor.
        t_kill = time.perf_counter()
        cl.kill(0)
        seen = None
        while True:
            try:
                res = {r: ctx.status(r)["resilience"] for r in (1, 2)}
                lead = res[1]["leader"]
                if (lead in (1, 2) and res[2]["leader"] == lead
                        and res[lead]["is_leader"]
                        and min(x["leader_epoch"] for x in res.values()) >= 1):
                    seen = res
                    break
            except (OSError, ocm.OcmError):
                pass
            if time.perf_counter() - t_kill > budget_s:
                raise AssertionError(f"no agreed leader {budget_s} s after the "
                                     f"kill: {res}")
            time.sleep(0.01)
        election_s = time.perf_counter() - t_kill
        lead = seen[1]["leader"]
        log(f"[daemons_py] (d) rank 0 SIGKILLed; ranks 1 and 2 agree on leader "
            f"{lead} at epoch {seen[1]['leader_epoch']} after {election_s:.3f} s")
        # New allocations land on the survivors.
        for _ in range(4):
            x = ctx.alloc(nb, OcmKind.REMOTE_HOST)
            if x.rank == 0:
                raise AssertionError("an allocation placed on the dead rank")
            data = torch.empty(nb, dtype=torch.uint8, device=device).random_(
                0, 256, generator=gen)
            ctx.put(x, data)
            if not torch.equal(ctx.get(x).to(device), data):
                raise AssertionError("a new allocation after the election differs")
            ctx.free(x)
        # Every handle's bytes through the client: a dead primary's by the
        # client's failover ladder, which reaches the replica the leader
        # promoted and repoints the handle at it.
        located = {}
        for h, data in zip(hs, datas):
            dead = h.rank == 0
            if not torch.equal(ctx.get(h).cpu(), data):
                raise AssertionError(f"handle {h.alloc_id} (primary rank "
                                     f"{0 if dead else h.rank}) differs")
            if dead:
                if h.rank == 0:
                    raise AssertionError(f"handle {h.alloc_id} still names the "
                                         "dead rank 0")
                located[h.alloc_id] = h.rank
        counters = {r: ctx.status(r)["resilience"]["failover"] for r in (1, 2)}
        out.update({"election_s": election_s, "leader": lead,
                    "leader_epoch": seen[1]["leader_epoch"], "primaries": by_rank,
                    "located": sorted(set(located.values())),
                    "failover": counters, "budget_s": budget_s,
                    "no_card": no_card})
        log(f"[daemons_py] (d) {count} handles byte-equal: {by_rank[1] + by_rank[2]} "
            f"through their primaries, {by_rank[0]} through the client's "
            f"failover to the promoted replicas on {out['located']}; failover "
            f"{json.dumps(counters)}")

        # (e) QoS granted: a PRIO_LOW client's CONNECT and its profile.
        c = cl.client(1, config=dc.replace(ocm.OcmConfig(), priority=PRIO_LOW),
                      app_id=pid + (1 << 32))
        if not c._ctrl_caps & FLAG_CAP_QOS:
            raise AssertionError("the Python daemon did not grant FLAG_CAP_QOS")
        apps = c.status()["qos"]["apps"]
        app = apps.get(f"{c.pid}@r1")
        if app is None or app["priority"] != PRIO_LOW:
            raise AssertionError(f"the PRIO_LOW profile is not in STATUS: {apps}")
        out["qos"] = {"caps": c._ctrl_caps, "app": {k: app[k] for k in (
            "priority", "quota_bytes", "quota_handles")}}
        log(f"[daemons_py] (e) PRIO_LOW granted FLAG_CAP_QOS; STATUS profile "
            f"{json.dumps(out['qos']['app'])}")
        ctx.tini()
    return out


# -- phase 8c ---------------------------------------------------------------

# The client halves of the daemons' features, on the port's Python daemons:
# (a) the mux runtime and AsyncOcm, (b) the shm fabric, (e) the engine over
# a mux cold client, on a pair sized as phase 8b's with OCM_FABRIC=shm; (d)
# hedges and deadlines and (c) replication through the client on a trio
# with phase 8b (d)'s resilient control plane.
CLIENT_TENANTS = 64
CLIENT_ASYNC = (32, 2 * MiB)  # (a): AsyncOcm's concurrent gets, their size
CLIENT_HEDGE_MS = 25
# (d): the budget of a put to a stopped primary, and what it may run past
# it: the ladder's last attempt, a locate, the typed raise. The JAX
# package's own test allows 1.6 s past a 0.4 s budget.
CLIENT_DEADLINE_MS = 400
CLIENT_DEADLINE_SLACK_S = 1.6


def _remote_host_legs(ctx, device, gen, sizes, what: str,
                      rank: int | None = None) -> None:
    """REMOTE_HOST of card tensors at ``sizes`` (placed on ``rank`` when
    given): put and got back whole, at an offset into a card tensor, and
    put at an offset; byte for byte."""
    from oncilla_tpu_torch import OcmKind

    for n in sizes:
        h = ctx.alloc(n, OcmKind.REMOTE_HOST)
        if rank is not None and h.rank != rank:
            raise AssertionError(f"{what}: REMOTE_HOST {n} B placed on rank "
                                 f"{h.rank}, not {rank}")
        data = torch.empty(n, dtype=torch.uint8, device=device).random_(
            0, 256, generator=gen)
        ctx.put(h, data)
        if not torch.equal(ctx.get(h).to(device), data):
            raise AssertionError(f"{what}: REMOTE_HOST {n} B get differs from put")
        off = min(4096 + 100, n // 2)
        into = torch.empty(n - off, dtype=torch.uint8, device=device)
        if not torch.equal(ctx.get(h, offset=off, out=into), data[off:]):
            raise AssertionError(f"{what}: REMOTE_HOST {n} B get(out=card) at {off}")
        half = (n - off) // 2
        ctx.put(h, data[:half], offset=off)
        if not torch.equal(ctx.get(h, half, offset=off).to(device), data[:half]):
            raise AssertionError(f"{what}: REMOTE_HOST {n} B put at offset {off}")
        ctx.free(h)
        del data, into


def _rates(ctx, device, gen, timed, reps: int, alloc_iters: int) -> dict:
    """Put from / get to a card tensor at ``timed`` (median of ``reps``) and
    alloc/free p50 over ``alloc_iters``, through ``ctx``."""
    from oncilla_tpu_torch import OcmKind

    out = {"rates": []}
    lat = {"alloc": [], "free": []}
    for _ in range(alloc_iters):
        t1 = time.perf_counter()
        x = ctx.alloc(4096, OcmKind.REMOTE_HOST)
        t2 = time.perf_counter()
        ctx.free(x)
        lat["alloc"].append(t2 - t1)
        lat["free"].append(time.perf_counter() - t2)
    out["alloc_p50_us"] = statistics.median(lat["alloc"]) * 1e6
    out["free_p50_us"] = statistics.median(lat["free"]) * 1e6
    for n in timed:
        r = ctx.alloc(n, OcmKind.REMOTE_HOST)
        card = torch.empty(n, dtype=torch.uint8, device=device).random_(
            0, 256, generator=gen)
        back = torch.empty(n, dtype=torch.uint8, device=device)
        out["rates"].append({
            "nbytes": n, "reps": reps,
            "put_from_card_gbps": n / _median_s(lambda: ctx.put(r, card),
                                                reps, device) / 1e9,
            "get_to_card_gbps": n / _median_s(lambda: ctx.get(r, out=back),
                                              reps, device) / 1e9})
        if not torch.equal(back, card):
            raise AssertionError(f"timed REMOTE_HOST {n} B: bytes differ")
        ctx.free(r)
        del card, back
    return out


def _client_ctx(cl, device, app_id: int, **cfg):
    """A context at rank 0 of ``cl`` whose client is configured by ``cfg``
    and has an app identity of its own; closed by the caller."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient

    config = ocm.OcmConfig(host_arena_bytes=64 * MiB, device_arena_bytes=64 * MiB,
                           **cfg)
    client = ControlPlaneClient(cl.entries, 0, config=config, app_id=app_id)
    return ocm.Ocm(config=config, remote=client, device=device), client


def _mux_checks(cl, device, gen, *, sizes, timed, reps, alloc_iters, tenants,
                async_gets) -> tuple:
    """Check (a) of phase 8c on ``cl``: the mux app's REMOTE_HOST legs and
    figures beside a blocking client's, ``tenants`` tenants on one channel
    a peer, AsyncOcm's concurrent gets. Returns (report, the blocking
    context and client, kept open for (b))."""
    import asyncio

    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.runtime import mux
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient

    pid = os.getpid()
    ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=cl.nodefile, rank=0, mux=True,
                                     host_arena_bytes=64 * MiB,
                                     device_arena_bytes=64 * MiB), device=device)
    client = ctx._remote
    if client._mux is None:
        raise AssertionError("OCM_MUX=1 did not give a mux client")
    _remote_host_legs(ctx, device, gen, sizes, "mux", rank=1)
    blk, blk_client = _client_ctx(cl, device, pid + (2 << 32))
    _remote_host_legs(blk, device, gen, sizes[:2], "blocking", rank=1)
    out = {"sizes": list(sizes),
           "mux": _rates(ctx, device, gen, timed, reps, alloc_iters),
           "blocking": _rates(blk, device, gen, timed, reps, alloc_iters)}
    log(f"[client] (a) mux REMOTE_HOST at {list(sizes)} B byte-equal; mux "
        f"{json.dumps(out['mux'])}; blocking {json.dumps(out['blocking'])}")

    # Many tenants, one channel per peer.
    many = [ControlPlaneClient(cl.entries, 0, config=client.config,
                               heartbeat=False, app_id=pid + (3 << 32) + i)
            for i in range(tenants)]
    try:
        hs = [t.alloc(64 * KiB, OcmKind.REMOTE_HOST) for t in many]
        for i, (t, h) in enumerate(zip(many, hs)):
            t.put(h, torch.full((64 * KiB,), i % 251, dtype=torch.uint8,
                                device=device))
        for i, (t, h) in enumerate(zip(many, hs)):
            got = t.get(h, 64 * KiB)
            if int(got.min()) != i % 251 or int(got.max()) != i % 251:
                raise AssertionError(f"tenant {i} read another tenant's bytes")
        stats = mux.runtime_stats()
        if stats["fds"] != len(cl.entries):
            raise AssertionError(f"{tenants} tenants hold {stats['fds']} "
                                 f"channels, want one a peer ({len(cl.entries)})")
        for t, h in zip(many, hs):
            t.free(h)
    finally:
        for t in many:
            t.close()
    out["tenants"] = {"tenants": tenants, "fds": stats["fds"],
                      "peers": len(cl.entries), "ops": stats["ops"],
                      "peak_inflight": stats["peak_inflight"]}
    log(f"[client] (a) {tenants} tenants: {json.dumps(out['tenants'])}")

    # AsyncOcm: concurrent gets on the runtime's loop, into pinned buffers.
    count, nb = async_gets
    rt = client._mux
    hs = [ctx.alloc(nb, OcmKind.REMOTE_HOST) for _ in range(count)]
    pages = [torch.empty(nb, dtype=torch.uint8, device=device).random_(
        0, 256, generator=gen) for _ in hs]
    for h, p in zip(hs, pages):
        ctx.put(h, p)
    outs = [torch.empty(nb, dtype=torch.uint8,
                        pin_memory=device.type == "cuda") for _ in hs]
    dests = [o.numpy() for o in outs]
    aocm = rt.run(mux.AsyncOcm.open(client.entries, client.rank,
                                    config=client.config, channels=rt.channels,
                                    app_id=pid + (4 << 32), heartbeat=False))

    async def gets():
        await asyncio.gather(*(aocm.get(h, nb, 0, out=d)
                               for h, d in zip(hs, dests)))

    try:
        secs = _median_s(lambda: rt.run(gets()), reps, torch.device("cpu"))
    finally:
        rt.run(aocm.aclose(detach=True))
    for i, (o, p) in enumerate(zip(outs, pages)):
        if not torch.equal(o.to(device), p):
            raise AssertionError(f"AsyncOcm get {i} of {count} differs")
    for h in hs:
        ctx.free(h)
    out["async"] = {"gets": count, "nbytes": nb, "reps": reps,
                    "aggregate_gbps": count * nb / secs / 1e9}
    log(f"[client] (a) AsyncOcm: {json.dumps(out['async'])}")
    ctx.tini()
    del pages, outs, dests
    return out, blk, blk_client


def _native_lockstep(device, gen) -> dict:
    """Check (a)'s last part: a mux client against two native daemons, which
    decline FLAG_CAP_MUX by silence, runs lockstep over its one connection
    a peer, byte for byte."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient
    from oncilla_tpu_torch.runtime.cluster import local_cluster

    with local_cluster(2) as nl:
        c = ControlPlaneClient(nl.entries, 0, config=ocm.OcmConfig(mux=True),
                               heartbeat=False, app_id=os.getpid() + (5 << 32))
        try:
            ch = c._mux.open_sync(c._ctrl_addr)
            h = c.alloc(PAGE, OcmKind.REMOTE_HOST)
            data = torch.empty(PAGE, dtype=torch.uint8, device=device).random_(
                0, 256, generator=gen)
            c.put(h, data)
            same = torch.equal(c.get(h, PAGE).to(device), data)
            c.free(h)
            out = {"muxed": ch.muxed, "lockstep": ch.counters["lockstep"],
                   "bytes_equal": same, "rank": h.rank}
        finally:
            c.close()
    if out["muxed"] or not same:
        raise AssertionError(f"mux client against the native pair: {out}")
    log(f"[client] (a) native pair: {json.dumps(out)}")
    return out


def _fabric_checks(cl, device, gen, blk_client, *, nbytes: int, reps: int) -> dict:
    """Check (b): an ``OCM_FABRIC=shm`` app selects shm against the pair
    (its fabric map and the daemon's STATUS counters), moves card tensors
    of ``nbytes`` byte for byte and times them; the blocking tcp client of
    (a) was granted ACK coalescing, and its tuner's plan is printed."""
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.runtime.protocol import FLAG_CAP_COALESCE

    fctx, fclient = _client_ctx(cl, device, os.getpid() + (6 << 32), fabric="shm")
    try:
        h = fctx.alloc(nbytes, OcmKind.REMOTE_HOST)
        data = torch.empty(nbytes, dtype=torch.uint8, device=device).random_(
            0, 256, generator=gen)
        fctx.put(h, data)
        back = torch.empty(nbytes, dtype=torch.uint8, device=device)
        if not torch.equal(fctx.get(h, out=back), data):
            raise AssertionError("shm fabric: get differs from put")
        addr = tuple(h.owner_addr)
        fab = fclient._dcn_fabrics.get(addr)
        counters = fclient.status(h.rank)["fabric"]
        rec = {
            "nbytes": nbytes, "reps": reps,
            "selected": getattr(fab, "name", "tcp"),
            "served": counters["served"],
            "daemon_counters": {k: counters["counters"][k] for k in (
                "selected_shm", "shm_puts", "shm_gets")},
            "put_from_card_gbps": nbytes / _median_s(
                lambda: fctx.put(h, data), reps, device) / 1e9,
            "get_to_card_gbps": nbytes / _median_s(
                lambda: fctx.get(h, out=back), reps, device) / 1e9,
        }
        if not torch.equal(back, data):
            raise AssertionError("shm fabric: timed get differs")
        fctx.free(h)
    finally:
        fctx.tini()
        fclient.close()
    if rec["selected"] != "shm" or rec["daemon_counters"]["selected_shm"] < 1 \
            or rec["daemon_counters"]["shm_puts"] < 1:
        raise AssertionError(f"OCM_FABRIC=shm did not select shm: {rec}")
    owner = (cl.entries[1].connect_host, cl.entries[1].port)
    caps = blk_client._dcn_caps.get(owner, 0)
    if not caps & FLAG_CAP_COALESCE:
        raise AssertionError(f"ACK coalescing not granted on tcp: caps {caps}")
    chunk, window = blk_client._dcn_tuners[owner].plan()
    rec["tcp"] = {"caps": caps, "coalesce_granted": True,
                  "tuner_plan": {"chunk_bytes": chunk, "window": window}}
    log(f"[client] (b) {json.dumps(rec)}")
    del data, back
    return rec


def _hedge_and_failover(device, gen, *, handles, hedge_ms: int, deadline_ms: int,
                        slack_s: float, heartbeat_s: float) -> dict:
    """Checks (d) and (c) of phase 8c on three Python daemons with phase 8b
    (d)'s resilient control plane, the app at rank 0 with ``replicas=2`` and
    ``hedge_ms``. (d): SIGSTOP the primary of a handle (not rank 0): a get
    returns byte for byte from the replica and leaves the handle as it was;
    a put with ``deadline_ms`` raises ``OcmDeadlineExceeded`` within its
    budget and ``slack_s``; SIGCONT. (c): SIGKILL that primary; a put and a
    get on the handle work and its rank moves to the promoted replica; every
    handle reads back through ``ctx.get``."""
    import signal

    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind

    count, nb = handles
    out = {}
    cl = _healthy_cluster(3, host_arena_bytes=64 * MiB + 4 * count * nb,
                          heartbeat_s=heartbeat_s, out=out)
    with cl:
        ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=cl.nodefile, rank=0,
                                         host_arena_bytes=64 * MiB,
                                         device_arena_bytes=64 * MiB,
                                         replicas=2, hedge_ms=hedge_ms),
                           device=device)
        hs, datas = [], []
        for _ in range(count):
            h = ctx.alloc(nb, OcmKind.REMOTE_HOST)
            data = torch.empty(nb, dtype=torch.uint8, device=device).random_(
                0, 256, generator=gen)
            ctx.put(h, data)
            hs.append(h)
            datas.append(data)
        if not all(h.replica_ranks for h in hs):
            raise AssertionError("a handle without replica_ranks")
        out["replica_chains"] = sorted({(h.rank, *h.replica_ranks) for h in hs})
        hd = next((h for h in hs if h.rank != 0 and 0 in h.replica_ranks),
                  next(h for h in hs if h.rank != 0))
        i = hs.index(hd)
        victim, chain = hd.rank, tuple(hd.replica_ranks)
        pid = cl.pids()[victim]

        # (d) a stopped primary: the hedge escapes, the budget expires.
        os.kill(pid, signal.SIGSTOP)
        try:
            t0 = time.perf_counter()
            got = ctx.get(hd)
            hedge_s = time.perf_counter() - t0
            if not torch.equal(got.to(device), datas[i]):
                raise AssertionError("hedged get differs")
            if (hd.rank, tuple(hd.replica_ranks)) != (victim, chain):
                raise AssertionError(f"the hedge repointed the handle: "
                                     f"{hd.rank} {hd.replica_ranks}")
            t0 = time.perf_counter()
            try:
                ctx.put(hd, datas[i], deadline_ms=deadline_ms)
            except ocm.OcmDeadlineExceeded:
                put_s = time.perf_counter() - t0
            else:
                raise AssertionError("a put to a stopped primary did not expire")
        finally:
            os.kill(pid, signal.SIGCONT)
        if put_s > deadline_ms / 1e3 + slack_s:
            raise AssertionError(f"the {deadline_ms} ms put expired after "
                                 f"{put_s:.3f} s")
        out["hedge"] = {"hedge_ms": hedge_ms, "get_s": hedge_s, "rank": victim,
                        "replica_ranks": list(chain), "repointed": False}
        out["deadline"] = {"deadline_ms": deadline_ms, "raised_after_s": put_s,
                           "slack_s": slack_s,
                           "error": "OcmDeadlineExceeded"}
        log(f"[client] (d) primary rank {victim} stopped: hedged get "
            f"{hedge_s * 1e3:.3f} ms byte-equal, handle unchanged; a "
            f"{deadline_ms} ms put raised OcmDeadlineExceeded after "
            f"{put_s:.3f} s; SIGCONT")

        # (c) the primary killed: the client's failover.
        cl.kill(victim)
        new = torch.empty(nb, dtype=torch.uint8, device=device).random_(
            0, 256, generator=gen)
        t0 = time.perf_counter()
        ctx.put(hd, new)
        failover_s = time.perf_counter() - t0
        if not torch.equal(ctx.get(hd).to(device), new):
            raise AssertionError("after the kill: get differs from the put")
        if hd.rank == victim or hd.rank not in chain:
            raise AssertionError(f"the handle names rank {hd.rank}, not a "
                                 f"promoted replica of {chain}")
        datas[i] = new
        moved = 0
        for h, data in zip(hs, datas):
            was = h.rank
            if not torch.equal(ctx.get(h).to(device), data):
                raise AssertionError(f"handle {h.alloc_id} (rank {was}) differs")
            moved += was == victim
        out["replicas"] = {"handles": count, "nbytes": nb, "killed": victim,
                           "promoted": hd.rank, "put_after_kill_s": failover_s,
                           "handles_on_killed_rank": moved + 1}
        log(f"[client] (c) rank {victim} SIGKILLed: put and get through the "
            f"client byte-equal, handle now on rank {hd.rank} "
            f"({failover_s:.3f} s for the first put); {count} handles read back")
        ctx.tini()
    return out


def phase_client(device, *, engine=None, host_bytes=WIRE_HOST, sizes=PY_SIZES,
                 timed=(PAGE, GiB), reps: int = 5, alloc_iters: int = 200,
                 tenants: int = CLIENT_TENANTS, async_gets=CLIENT_ASYNC,
                 fabric_bytes: int = GiB, handles=PY_HANDLES,
                 hedge_ms: int = CLIENT_HEDGE_MS,
                 deadline_ms: int = CLIENT_DEADLINE_MS,
                 slack_s: float = CLIENT_DEADLINE_SLACK_S,
                 heartbeat_s: float = PY_HEARTBEAT_S,
                 check_launches: bool = True) -> dict:
    """Phase 8c, the client: the client halves of the daemons' features.
    On two Python daemons sized as phase 8b's pair (``OCM_FABRIC=shm``):
    (a) an ``OCM_MUX=1`` app's REMOTE_HOST card tensors at ``sizes``, GB/s
    at ``timed`` and alloc/free p50 beside a blocking client's, ``tenants``
    tenants on one channel a peer, AsyncOcm's concurrent gets
    (``async_gets``), and a mux client against two native daemons running
    lockstep; (b) the shm fabric selected, ``fabric_bytes`` of card tensors
    byte for byte and timed, ACK coalescing granted on tcp and the tuner's
    plan; given ``engine`` (``dict(cfg=, params=, page_tokens=, runs=<phase
    5b's runs, C and E among them>)``), (e) runs H (E's settings) and I
    (C's) with the COLD tier on rank 1 behind a PRIO_LOW mux client: H's
    prefetcher async, every COLD page of both legs the bytes put, I's
    tokens C's bit for bit, H's E's by the margin rule, HOT puts/gets the
    K1/K2 launches. On three with the resilient control plane: (d) hedges
    and deadlines, (c) replication through the client
    (:func:`_hedge_and_failover`). Raises on the first check that fails."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.qos.policy import PRIO_LOW
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient
    from oncilla_tpu_torch.runtime.cluster import local_cluster

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(83)
    report = {"launches": {k: 0 for k in dma.launches()}}
    t0 = time.perf_counter()
    with local_cluster(2, daemon="python", host_arena_bytes=list(host_bytes),
                       device_arena_bytes=64 * MiB,
                       env={"OCM_FABRIC": "shm"}) as cl:
        log(f"[client] two Python daemons up in {time.perf_counter() - t0:.3f} s")
        report["mux"], blk, blk_client = _mux_checks(
            cl, device, gen, sizes=sizes, timed=timed, reps=reps,
            alloc_iters=alloc_iters, tenants=tenants, async_gets=async_gets)
        try:
            report["fabric"] = _fabric_checks(cl, device, gen, blk_client,
                                              nbytes=fabric_bytes, reps=reps)
        finally:
            blk.tini()
            blk_client.close()
        if engine is not None:
            cold = CheckedCold(ControlPlaneClient(
                cl.entries, 0, config=dataclasses.replace(
                    ocm.OcmConfig(), priority=PRIO_LOW, mux=True),
                app_id=os.getpid() + (1 << 32)))
            try:
                ref = engine["runs"]
                hi = phase_engine(device, engine["cfg"], engine["params"],
                                  page_tokens=engine["page_tokens"],
                                  runs=(("H", *ref["E"]["settings"]),
                                        ("I", *ref["C"]["settings"])),
                                  cold_backend=cold,
                                  **{"warm": WIRE_WARM, **engine.get("kw", {})})["runs"]
                report["serving"] = check_remote_cold(
                    ref, hi, cold, [cl.status(r)["live_allocs"] for r in range(2)],
                    check_launches, names=("H", "I"), mode="async")
            finally:
                cold.client.close()
            report["serving"]["mode"] = hi["H"]["prefetch"]["mode"]
            if "wire" in engine:
                report["serving"]["tok_s"].update(
                    {k: engine["wire"]["tok_s"][k] for k in ("F", "G")})
            report["launches"] = {k: v + hi["H"]["launches"][k] + hi["I"]["launches"][k]
                                  for k, v in report["launches"].items()}
            log(f"[client] (e) runs H and I: {json.dumps(report['serving'])}")
    report["mux"]["native"] = _native_lockstep(device, gen)
    report.update(_hedge_and_failover(
        device, gen, handles=handles, hedge_ms=hedge_ms, deadline_ms=deadline_ms,
        slack_s=slack_s, heartbeat_s=heartbeat_s))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[client] phase {report['seconds']:.3f} s; launches {report['launches']}")
    return report


# -- phase 8d ---------------------------------------------------------------

# The FROZEN tier and the engine's warm boot, at the width of phase 5b:
# six requests sharing a 256-token prefix (16 pages of 16 tokens), run C's
# engine settings (batched, graphed, no prefetch workers, so the seating is
# the scheduler's alone) over a store of 8 HOT and 4 WARM pages. With a
# frozen backend attached, COLD (the host stand-in) is bounded at 8 pages
# and the overflow reaches the disk.
WARMBOOT_PROMPTS = {"n": 6, "shared": 256, "suffix": 12}
WARMBOOT_NEW = 32
WARMBOOT_TIERS = (8, 4)  # HOT, WARM pages
# The arms, as the JAX package's run_warmboot (serving/__main__.py:496):
# (name, frozen dir, held to ref by). ref has no frozen backend; seeded's
# close persists the trie; cold is a fresh context without a backend; warm
# a fresh context over the seeded dir, whose __init__ restores the trie.
# warm0 is the reference's discarded warm-up pass: the arms share one graph
# cache (the counterpart of XLA's process-wide compile cache), ref and
# seeded capture cold's shapes and warm0 warm's, so that TTFT measures the
# skipped prefill, not a graph capture.
WARMBOOT_ARMS = (("ref", False, "bits"), ("seeded", True, "bits"),
                 ("cold", False, "bits"), ("warm0", True, "margin"),
                 ("warm", True, "margin"))


class CheckedFrozen:
    """A ``FrozenStore`` whose every read is held to the bytes last written
    under its key in this phase (a digest a key, shared by the arms), with
    the bytes and files moved each way."""

    def __init__(self, inner, digests: dict):
        self.inner = inner
        self.digests = digests
        self.io = {"writes": 0, "written": 0, "reads": 0, "read": 0,
                   "write_s": 0.0, "read_s": 0.0}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def write(self, key: str, data: bytes, meta=None) -> None:
        t0 = time.perf_counter()
        self.inner.write(key, data, meta=meta)
        self.io["write_s"] += time.perf_counter() - t0
        self.digests[key] = hashlib.sha1(data).hexdigest()
        self.io["writes"] += 1
        self.io["written"] += len(data)

    def read_bytes(self, key: str) -> bytes:
        t0 = time.perf_counter()
        got = self.inner.read_bytes(key)
        self.io["read_s"] += time.perf_counter() - t0
        if hashlib.sha1(got).hexdigest() != self.digests.get(key):
            raise AssertionError(f"frozen {key}: read back other bytes than "
                                 f"this phase wrote")
        self.io["reads"] += 1
        self.io["read"] += len(got)
        return got

    def delete(self, key: str) -> None:
        self.inner.delete(key)
        self.digests.pop(key, None)


def phase_warmboot(device, cfg, params, *, page_tokens: int,
                   prompts=WARMBOOT_PROMPTS, new_tokens: int = WARMBOOT_NEW,
                   tiers=WARMBOOT_TIERS, max_active: int = 4,
                   max_batch: int = 8, hold_ttft: bool = True,
                   check_launches: bool = True) -> dict:
    """Phase 8d, the warm boot: :data:`WARMBOOT_ARMS` over ``seeded_prompts``
    on fresh contexts, the seeded and warm arms under the port's flight
    recorder and auditor (``obs/audit.recorded``). Checks, each raising:
    (a) seeded's and cold's tokens ref's bit for bit, warm's (and warm0's)
    by the margin rule; (b) the extents restored equal the ``prefix-`` keys
    persisted, both > 0, each restored page read back (K2 where HOT) equal
    to its file's bytes; (c) pages reached FROZEN in the seeded arm and every
    disk read is the bytes written (:class:`CheckedFrozen`); (d) in every
    arm the K1/K2 launches equal its HOT puts/gets; (e) warm's prefix hit
    ratio above cold's and, with ``hold_ttft``, its mean TTFT below cold's;
    (f) both audits find nothing. Then ``python -m oncilla_tpu_torch.persist
    --smoke`` in a subprocess must exit 0."""
    import shutil
    import tempfile

    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.models.graphs import StepGraphs
    from oncilla_tpu_torch.obs import audit
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.persist import FrozenStore
    from oncilla_tpu_torch.serving.engine import Request, ServingEngine
    from oncilla_tpu_torch.serving.metrics import ServingStats
    from oncilla_tpu_torch.serving.prefix import PrefixCache
    from oncilla_tpu_torch.serving.tiers import TieredPageStore

    t_phase = time.perf_counter()
    Engine = _recording_engine()
    page = ServingEngine.page_nbytes(cfg, page_tokens, cfg.dtype)
    reqs = seeded_prompts(cfg.vocab, 11, **prompts)
    prompt_tokens = sum(len(p) for p in reqs)
    hot, warm = tiers
    on_card = device.type == "cuda"
    graphs = StepGraphs(params, cfg) if on_card else None
    digests: dict = {}
    report = {"arms": {}, "page_bytes": page, "prompt_tokens": prompt_tokens}
    log(f"[warmboot] {len(reqs)} requests of {len(reqs[0])} prompt tokens + "
        f"{new_tokens}, pages of {page_tokens} tokens ({page} B), HOT {hot}, "
        f"WARM {warm}, max_active {max_active}, max_batch {max_batch}")

    def arm(name: str, frozen_dir) -> dict:
        ctx = ocm.ocm_init(ocm.OcmConfig(
            device_arena_bytes=max(64 * MiB, hot * page),
            host_arena_bytes=256 * MiB), device=device)
        frozen = (CheckedFrozen(FrozenStore(frozen_dir), digests)
                  if frozen_dir else None)
        persisted = (sum(k.startswith("prefix-") for k in frozen.keys())
                     if frozen else 0)
        store = TieredPageStore(ctx, page, hot_capacity=hot,
                                warm_capacity=warm, frozen_backend=frozen,
                                stats=ServingStats(f"warmboot {name}"))
        if on_card:
            torch.cuda.synchronize(device)
        # The main path: counts from 0 just before the arm, read after it.
        dma.reset_launches()
        t_boot = time.perf_counter()
        eng = Engine(params, cfg, store, PrefixCache(store, page_tokens),
                     graphs=graphs, timed=False, page_tokens=page_tokens,
                     max_active=max_active, prefetch_workers=0,
                     store_dtype=cfg.dtype, name=f"warmboot {name}",
                     batched=True, max_batch=max_batch)
        boot_s = time.perf_counter() - t_boot
        # (b): read each restored page back in its LRU order (which the
        # reads' touches keep), HOT ones through K2, against its file.
        restored = sorted(eng.prefix.extents(), key=lambda e: e.page.last_use)
        restored_tiers = dict(collections.Counter(
            e.page.tier.value for e in restored))
        for ext in restored:
            got = store.read_host(ext.page).numpy().tobytes()
            if got != frozen.read_bytes(f"prefix-{ext.key}"):
                raise AssertionError(f"warmboot {name}: restored extent "
                                     f"{ext.key[:12]} is not its file's bytes")
        captured = graphs.captured if graphs is not None else 0
        t0 = time.perf_counter()
        for i, p in enumerate(reqs):
            eng.submit(Request(tenant=f"t{i}", tokens=p,
                               max_new_tokens=new_tokens))
        results = eng.run()
        if on_card:
            torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        meta = eng.metrics_meta()
        occupancy = {k: v["pages"] for k, v in store.occupancy().items()}
        eng.graphs = None  # the shared cache outlives this engine
        t_close = time.perf_counter()
        eng.close()
        close_s = time.perf_counter() - t_close
        launches = dma.launches()
        out = {r.tenant: list(r.out_tokens) for r in results}
        emitted = sum(len(v) for v in out.values())
        ttft = meta["ttft"]
        rec = {
            "seconds": secs, "boot_s": boot_s, "close_s": close_s,
            "tok_s": emitted / secs, "emitted": emitted,
            "ttft_mean_s": ttft["sum_s"] / ttft["count"],
            "prefix_tokens_reused": sum(r.prefix_tokens_reused for r in results),
            "prefill_tokens": meta["tokens"]["prefill"],
            "prefill_chunks": meta["batch"]["prefill_chunks"],
            "steps": meta["batch"]["steps"], "moves": meta["moves"],
            "prefix": meta["prefix"], "occupancy_end": occupancy,
            "persisted_before": persisted, "restored": len(restored),
            "restored_tiers": restored_tiers,
            "graphs_captured": (graphs.captured - captured
                                if graphs is not None else 0),
            "io": {t: dict(v) for t, v in store.io.items()},
            "disk": dict(frozen.io) if frozen else None,
            "launches": launches, "out": out, "rows": eng.rows,
        }
        rec["prefix_hit_ratio"] = rec["prefix_tokens_reused"] / prompt_tokens
        store.close()
        ctx.tini()
        log(f"[warmboot] arm {name}: {emitted} tokens in {secs:.3f} s, "
            f"{rec['tok_s']:.3f} tokens/s, mean TTFT {rec['ttft_mean_s']:.6f} s, "
            f"prefix hit ratio {rec['prefix_hit_ratio']:.4f} "
            f"({rec['prefix_tokens_reused']} of {prompt_tokens} prompt tokens), "
            f"{rec['prefill_chunks']} prefill chunks, boot {boot_s:.3f} s "
            f"(restored {len(restored)} of {persisted} persisted extents, "
            f"tiers {restored_tiers}), close {close_s:.3f} s, graphs "
            f"captured {rec['graphs_captured']}, pages at end {occupancy}, "
            f"moves {rec['moves']}, io {json.dumps(rec['io'])}, disk "
            f"{json.dumps(rec['disk'])}, launches "
            f"write_rows={launches['write_rows']} "
            f"read_rows={launches['read_rows']}")
        return rec

    tmp = tempfile.mkdtemp(prefix="ocm-warmboot-")
    recordings = []
    try:
        seed_dir = os.path.join(tmp, "seeded")
        for name, frozen, _held in WARMBOOT_ARMS:
            if name in ("seeded", "warm"):
                with audit.recorded(f"warmboot-{name}") as rec:
                    report["arms"][name] = arm(name, seed_dir)
                recordings.append(rec.path)
                report["arms"][name]["audit"] = rec.summary()
                log(f"[warmboot] arm {name} (f): {rec.summary()}")
            else:
                report["arms"][name] = arm(name, seed_dir if frozen else None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for path in recordings:
            shutil.rmtree(path, ignore_errors=True)
        if graphs is not None:
            graphs.close()
    arms = report["arms"]
    ref = arms["ref"]
    # (a) tokens.
    for name, _frozen, held in WARMBOOT_ARMS[1:]:
        if held == "bits":
            if arms[name]["out"] != ref["out"]:
                raise AssertionError(f"warmboot {name}: tokens differ from ref: "
                                     f"{arms[name]['out']} vs {ref['out']}")
        else:
            d = _margin_check(ref["rows"], arms[name]["rows"])
            arms[name]["vs_ref"] = d
            _hold_margin(f"warmboot {name} against ref", d)
    # (b) the trie round trip.
    for name in ("warm0", "warm"):
        a = arms[name]
        if not 0 < a["restored"] == a["persisted_before"]:
            raise AssertionError(f"warmboot {name}: restored {a['restored']} "
                                 f"of {a['persisted_before']} persisted extents")
    # (c) the disk tier engaged and read back what it was given.
    s = arms["seeded"]
    if not (s["io"]["frozen"]["put"] > 0 and s["io"]["frozen"]["get"] > 0
            and s["disk"]["reads"] >= s["io"]["frozen"]["get"]):
        raise AssertionError(f"warmboot seeded: no page went to FROZEN and "
                             f"came back: io {s['io']['frozen']}, disk {s['disk']}")
    # (d) every HOT put is one K1 launch, every HOT get one K2.
    if check_launches:
        for name, a in arms.items():
            got = (a["launches"]["write_rows"], a["launches"]["read_rows"])
            want = (a["io"]["hbm"]["put"], a["io"]["hbm"]["get"])
            if got != want or a["launches"]["local_copy"] or not all(got):
                raise AssertionError(f"warmboot {name}: K1/K2 launches {got} != "
                                     f"HOT puts/gets {want}: {a['launches']}")
    # (e) the warm boot pays: more prefix reused, a shorter TTFT.
    w, c = arms["warm"], arms["cold"]
    report["warm_vs_cold"] = {
        "prefix_hit_ratio": [w["prefix_hit_ratio"], c["prefix_hit_ratio"]],
        "ttft_mean_s": [w["ttft_mean_s"], c["ttft_mean_s"]],
        "tok_s": [w["tok_s"], c["tok_s"]]}
    log(f"[warmboot] warm vs cold (e): {json.dumps(report['warm_vs_cold'])}")
    if not w["prefix_hit_ratio"] > c["prefix_hit_ratio"]:
        raise AssertionError(f"warmboot: warm prefix hit ratio "
                             f"{w['prefix_hit_ratio']} not above cold's "
                             f"{c['prefix_hit_ratio']}")
    if hold_ttft and not w["ttft_mean_s"] < c["ttft_mean_s"]:
        raise AssertionError(f"warmboot: warm boot did not cut mean TTFT "
                             f"({w['ttft_mean_s']} s vs cold {c['ttft_mean_s']} s)")
    # The JAX package's FROZEN-tier smoke, on the port, as its users run it.
    t0 = time.perf_counter()
    smoke = subprocess.run(
        [sys.executable, "-m", "oncilla_tpu_torch.persist", "--smoke"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    report["persist_smoke"] = {"rc": smoke.returncode,
                               "seconds": time.perf_counter() - t0,
                               "tail": smoke.stdout.strip().splitlines()[-1:]}
    log(f"[warmboot] persist --smoke: {json.dumps(report['persist_smoke'])}")
    if smoke.returncode != 0:
        raise AssertionError(f"python -m oncilla_tpu_torch.persist --smoke "
                             f"exited {smoke.returncode}: {smoke.stdout[-2000:]}"
                             f"{smoke.stderr[-2000:]}")
    report["launches"] = {k: sum(a["launches"][k] for a in arms.values())
                          for k in ref["launches"]}
    for a in arms.values():
        del a["rows"]
    if on_card:
        torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[warmboot] checks a-f passed; launches {report['launches']}; phase "
        f"{report['seconds']:.3f} s")
    return report


# -- phase 8e ---------------------------------------------------------------

# The harness's paired cells at full width: the fleet of its measured cell
# (serving/__main__.py run_bench: a page-aligned 32-token prompt, so the
# identical t0/t1 pair takes the whole-page CoW adoption) on the card's
# model. Prefetch workers stay off, so both cells seat the same batches (a run with workers
# seats by their timing, phase 5b's run E) and t0's continuation can be held
# to t1's bit for bit.
HARNESS_SEED = 1234
HARNESS_FLEET = {"tenants": 6, "shared_tokens": 28, "suffix_tokens": 4}
HARNESS_NEW = 16
HARNESS_PAGE_TOKENS = 8
HARNESS_TIERS = (4, 6)  # HOT, WARM pages
# GUPS over a handle's extent at the bench's size (a 16 MiB table, inside
# the card's 50 MB L2) and at a 1 GiB table, 20 times the L2.
HARNESS_GUPS_WORDS = (1 << 22, 1 << 28)
HARNESS_GUPS = {"batch": 1 << 20, "steps": 32}
_SMOKE_LAUNCHES = "serving smoke: launches "


def phase_harness(device, cfg, params, *, seed: int = HARNESS_SEED,
                  fleet=HARNESS_FLEET, new_tokens: int = HARNESS_NEW,
                  page_tokens: int = HARNESS_PAGE_TOKENS, tiers=HARNESS_TIERS,
                  gups_words=HARNESS_GUPS_WORDS, gups_kw=HARNESS_GUPS,
                  check_launches: bool = True) -> dict:
    """Phase 8e, the serving harness (``oncilla_tpu_torch.serving``'s
    ``__main__``). (a) Its paired cells, ``_run_cell`` without and then with
    prefix sharing, on ``params`` over ``inprocess_cluster(3)`` with the
    harness's cluster settings (2 replicas, a fast detector) and host arenas
    sized for every page twice: prefix hits and a CoW adoption in the shared
    cell, fewer remote bytes than without sharing, pages demoted and
    promoted, t0's tokens t1's bit for bit, the shared cell's tokens the
    unshared one's bit for bit or by the margin rule, every rank drained,
    and in each cell the K1/K2 launches equal its HOT puts/gets. (b) ``python
    -m oncilla_tpu_torch.serving --smoke`` in a subprocess on the same
    device must exit 0; its own K1/K2 launches come back on its output. (c)
    ``gups_handle_best`` at each of ``gups_words``: updates conserved."""
    import math

    from oncilla_tpu_torch.benchmarks.gups import gups_handle_best
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
    from oncilla_tpu_torch.serving import __main__ as harness
    from oncilla_tpu_torch.serving import engine as engine_mod

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    hot, warm = tiers
    prompts = harness._prompts(seed, vocab=cfg.vocab, **fleet)
    page = engine_mod.ServingEngine.page_nbytes(cfg, page_tokens)
    pages = sum(math.ceil((len(p) + new_tokens) / page_tokens) for p in prompts)
    host_arena = max(32 * MiB, 2 * pages * page)
    report = {"page_bytes": page, "pages": pages, "host_arena_bytes": host_arena,
              "cells": {}}
    log(f"[harness] (a) {len(prompts)} tenants of {len(prompts[0])} prompt "
        f"tokens + {new_tokens}, pages of {page_tokens} tokens ({page} B), "
        f"HOT {hot}, WARM {warm}, COLD on 3 in-process daemons of "
        f"{host_arena} B host arena, 2 replicas")

    # The harness builds its engines itself: a recording subclass in the
    # engine module's place keeps each emitted token's logits row.
    Recording = _recording_engine()
    made = []

    class HarnessEngine(Recording):
        def __init__(self, *args, **kw):
            super().__init__(*args, graphs="engine", timed=False, **kw)
            made.append(self)

    launches = {}
    real = engine_mod.ServingEngine
    engine_mod.ServingEngine = HarnessEngine
    try:
        with inprocess_cluster(
                3, config=harness._cluster_cfg(host_arena_bytes=host_arena)) as cl:
            for name, share in (("noshare", False), ("shared", True)):
                if on_card:
                    torch.cuda.synchronize(device)
                # The main path: counts from 0 just before the cell.
                dma.reset_launches()
                cell = harness._run_cell(
                    cl, cfg, params, share=share, prompts=prompts,
                    new_tokens=new_tokens, page_tokens=page_tokens, hot=hot,
                    warm=warm, prefetch_workers=0, name=f"harness-{name}")
                if on_card:
                    torch.cuda.synchronize(device)
                got = dma.launches()
                eng = made[-1]
                cell["hot_io"] = dict(eng.store.io["hbm"])
                cell["rows"] = eng.rows
                cell["launches"] = got
                report["cells"][name] = cell
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
                log(f"[harness] (a) {name}: {cell['decode_tokens']} tokens in "
                    f"{cell['wall_s']} s, {cell['tok_s']} tokens/s, hit ratio "
                    f"{cell['hit_ratio']}, remote bytes {cell['remote_bytes']}, "
                    f"prefix {cell['prefix']}, moves {cell['moves']}, HOT io "
                    f"{cell['hot_io']}, launches write_rows={got['write_rows']} "
                    f"read_rows={got['read_rows']}")
            report["drained_ranks"] = harness._assert_drained(cl)
    finally:
        engine_mod.ServingEngine = real
    sh, ns = report["cells"]["shared"], report["cells"]["noshare"]
    remote = [sum(c["remote_bytes"].values()) for c in (sh, ns)]
    report["remote_bytes_shared_noshare"] = remote
    if sh["prefix"]["hits"] == 0 or sh["prefix"]["cow"] == 0:
        raise AssertionError(f"harness: the shared cell took no prefix hit or "
                             f"no CoW adoption: {sh['prefix']}")
    if not remote[0] < remote[1]:
        raise AssertionError(f"harness: sharing did not cut remote bytes "
                             f"({remote[0]} vs {remote[1]})")
    if sh["moves"]["demote"] == 0 or sh["moves"]["promote"] == 0:
        raise AssertionError(f"harness: tiering never moved a page: {sh['moves']}")
    if sh["outputs"]["t0"] != sh["outputs"]["t1"]:
        raise AssertionError(f"harness: identical prompts decoded apart: "
                             f"{sh['outputs']['t0']} vs {sh['outputs']['t1']}")
    report["shared_vs_noshare"] = (
        "bits" if sh["outputs"] == ns["outputs"] else _margin_check(ns["rows"], sh["rows"]))
    if report["shared_vs_noshare"] != "bits":
        _hold_margin("harness shared against noshare", report["shared_vs_noshare"])
    log(f"[harness] (a) shared vs noshare: {json.dumps(report['shared_vs_noshare'])}; "
        f"drained ranks {report['drained_ranks']}")
    if check_launches:
        for name, c in report["cells"].items():
            got = (c["launches"]["write_rows"], c["launches"]["read_rows"])
            want = (c["hot_io"]["put"], c["hot_io"]["get"])
            if got != want or not all(got):
                raise AssertionError(f"harness {name}: K1/K2 launches {got} != "
                                     f"HOT puts/gets {want}")
    # Phase 8f decodes both cells again, observed: their references.
    report["observe_ref"] = {"host_arena_bytes": host_arena, "cells": {
        name: {k: c[k] for k in ("outputs", "rows", "tok_s", "launches", "hot_io")}
        for name, c in report["cells"].items()}}
    for c in report["cells"].values():
        del c["rows"], c["outputs"]
    del made
    if on_card:
        torch.cuda.empty_cache()

    # (b) The harness's smoke as its users run it, on the same device.
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "oncilla_tpu_torch.serving", "--smoke"]
    if not on_card:
        cmd += ["--device", "cpu"]
    smoke = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                           capture_output=True, text=True, timeout=600)
    lines = smoke.stdout.strip().splitlines()
    report["smoke"] = {"rc": smoke.returncode, "seconds": time.perf_counter() - t0,
                       "tail": lines[-1:]}
    log(f"[harness] (b) serving --smoke: {json.dumps(report['smoke'])}")
    if smoke.returncode != 0:
        raise AssertionError(f"python -m oncilla_tpu_torch.serving --smoke exited "
                             f"{smoke.returncode}: {smoke.stdout[-3000:]}"
                             f"{smoke.stderr[-3000:]}")
    sub = json.loads(next(ln for ln in lines if ln.startswith(_SMOKE_LAUNCHES))
                     [len(_SMOKE_LAUNCHES):])
    report["smoke"]["launches"] = sub
    for k, v in sub.items():
        launches[k] = launches.get(k, 0) + v
    log("[harness] (b) " + "\n".join(lines[-12:]))

    # (c) GUPS over a handle's extent, L2-resident and HBM-sized.
    report["gups"] = {}
    for words in gups_words:
        g = gups_handle_best(words=words, seed=seed, device=device, **gups_kw)
        if g["table_sum"] != g["updates"]:
            raise AssertionError(f"gups at {words} words: table sum "
                                 f"{g['table_sum']} != updates {g['updates']}")
        report["gups"][str(words)] = g
        log(f"[harness] (c) gups at {words} words ({4 * words} B): "
            f"{json.dumps(g)}")
    if on_card:
        torch.cuda.empty_cache()
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[harness] checks passed; launches {launches}; phase "
        f"{report['seconds']:.3f} s")
    return report


# -- phase 8f ---------------------------------------------------------------

# The operator's CLIs as their users run them: each CLI's ``main`` must
# return 0 with its OK line. They hold host memory only (in-process daemons,
# REMOTE_HOST) and run one after another in one process of their own (one
# torch import for all), once the cluster is gone, reniced ahead of other
# work where the host allows it: their chaos legs time 50 ms failure
# detectors and soak deadlines that a loaded host can starve into false
# verdicts (ROADMAP Queue C; on the card, four or five smokes at once failed
# the QoS soak's back-pressure and the leader smoke's audit). The resilience
# smokes go first, before any other smoke's threads.
OBSERVE_CLIS = (("resilience", "--smoke"), ("resilience", "--leader-smoke"),
                ("resilience", "--deadline-smoke"), ("obs", "--smoke"),
                ("obs", "slo", "--selftest"), ("elastic", "--smoke"),
                ("qos", "--smoke"), ("fabric", "--smoke"))
OBSERVE_SLO_INTERVAL_S = 0.5
_BULK_KERNEL = "bulk_copy_kernel"  # K1's, K2's and K3's one kernel name


def _start(argv, nice: int = 0) -> tuple:
    """``python <argv...>`` started (each process imports torch: seconds
    apiece), its priority raised to ``nice`` right after where the host
    allows it (threads it starts later inherit it)."""
    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen(
        [sys.executable, *argv], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    if nice:
        try:
            os.setpriority(os.PRIO_PROCESS, p.pid, nice)
        except OSError:
            pass  # no privilege: the host schedules it as it is
    return time.perf_counter(), p


def _operator_clis() -> int:
    """Phase 8f (h)'s process: each CLI named in ``sys.argv[1]`` (JSON, as
    ``OBSERVE_CLIS``) through its ``main``, in turn, its output captured;
    one JSON line each on stdout. Stops at the first that fails. Each
    starts on the journal a fresh process would hold: empty, switched as
    the environment says."""
    import importlib
    import io

    from oncilla_tpu_torch.obs import journal

    at_start = journal.enabled()
    for cmd in json.loads(sys.argv[1]):
        journal.clear()
        journal.set_enabled(at_start)
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = importlib.import_module(
                    f"oncilla_tpu_torch.{cmd[0]}.__main__").main(list(cmd[1:]))
        except BaseException:  # noqa: BLE001 — reported to the parent, which fails
            err.write(traceback.format_exc())
            rc = -1
        print(json.dumps({"cmd": cmd, "rc": rc, "seconds": time.perf_counter() - t0,
                          "out": out.getvalue()[-3000:],
                          "err": err.getvalue()[-3000:]}), flush=True)
        if rc != 0:
            return 1
    return 0


def _finish(started, timeout: float = 300.0) -> list:
    """Each of ``started``'s (returncode, stdout, stderr, seconds), in
    order."""
    out = []
    for t0, p in started:
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out.append((p.returncode, so, se, time.perf_counter() - t0))
    return out


def _profiled_kernels(trace_dir: str) -> dict:
    """The ``capture_trace`` output: its ``bulk_copy_kernel`` events, and how
    many of them were launched inside each ``ocm:`` range, the innermost
    around the launch on the launching thread (a kernel event names its
    launch by ``correlation``)."""
    import glob

    (path,) = glob.glob(os.path.join(trace_dir, "*.trace.json"))
    with open(path, encoding="utf-8") as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    ranges = collections.defaultdict(list)
    launch = {}
    for e in events:
        name = str(e.get("name", ""))
        if name.startswith("ocm:"):
            ranges[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e.get("dur", 0), name))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    kernels = [e for e in events if e.get("cat") == "kernel"
               and _BULK_KERNEL in str(e.get("name", ""))]
    inside = collections.Counter()
    for k in kernels:
        ln = launch.get(k.get("args", {}).get("correlation"))
        if ln is None:
            continue
        around = [(t0, name) for t0, t1, name in ranges[(ln.get("pid"), ln.get("tid"))]
                  if t0 <= ln["ts"] <= t1]
        if around:
            inside[max(around)[1]] += 1  # the innermost range
    return {"file": os.path.basename(path), "bulk_kernels": len(kernels),
            "in_ocm_ranges": dict(inside),
            "ocm_ranges": dict(collections.Counter(
                n for rs in ranges.values() for _, _, n in rs))}


def phase_observed(device, cfg, params, *, ref: dict, seed: int = HARNESS_SEED,
                   fleet=HARNESS_FLEET, new_tokens: int = HARNESS_NEW,
                   page_tokens: int = HARNESS_PAGE_TOKENS, tiers=HARNESS_TIERS,
                   host_us_ref: float | None = None, clis=OBSERVE_CLIS,
                   slo_interval_s: float = OBSERVE_SLO_INTERVAL_S,
                   check_launches: bool = True) -> dict:
    """Phase 8f, the serving path observed: 8e (a)'s two cells again, in its
    order (its settings, ``_run_cell``, a fresh ``inprocess_cluster(3)``
    with the harness's cluster settings), with the journal and the flight
    recorder on (a temporary directory), the SLO watcher on the app's
    control plane (``Ocm.start_slo``, a scrape each ``slo_interval_s``) and
    the shared cell, the one 8e measured, inside ``capture_trace``. The
    noshare cell is the one whose COLD pages cross the wire (the shared
    cell's fit HOT and WARM: no byte reaches a daemon), so it is what the
    cross-rank checks read. (a) Each cell's
    tokens 8e's bit for bit or by the margin rule, t0's t1's, K1/K2
    launches its HOT puts/gets. (b) The SLO block: 3 evaluations at least,
    no fetch error, the serving objectives saw traffic; every verdict
    printed, not held green. (c) ``export_trace``: 3 tracks, a cross-track
    flow, spans of the page path. (d) ``obs critpath <flight-recorder dir>
    --require-cross-rank`` as a process exits 0. (e) The profiler trace:
    one ``bulk_copy_kernel`` event per K1/K2/K3 launch of the shared cell,
    each launched inside an ``ocm:put``/``ocm:get`` range. (f) The CLI on
    the live cluster
    through a nodefile, the shared cell's engine still published: the table
    with its serving row, ``--prom 0`` with ``ocm_serving_ttft_seconds``,
    ``slo --json`` parsed, its exit code its verdict's. (g) Observed against
    8e's unobserved tokens/s, and K1's host issue time at 4 KiB with
    recording off against phase 3's. (h) Each of ``clis`` through its
    ``main``, in turn, in one reniced process beside (d)'s."""
    import tempfile

    from oncilla_tpu_torch.benchmarks import kernel_times as kt
    from oncilla_tpu_torch.obs import flightrec, journal
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
    from oncilla_tpu_torch.serving import __main__ as harness
    from oncilla_tpu_torch.serving import engine as engine_mod
    from oncilla_tpu_torch.utils.debug import capture_trace

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    hot, warm = tiers
    prompts = harness._prompts(seed, vocab=cfg.vocab, **fleet)
    report = {"slo_interval_s": slo_interval_s, "cells": {}, "seconds_by": {}}
    Recording = _recording_engine()
    made, live = [], {}

    def live_checks(eng, cl, ctx, tmp):
        """(b) and (f), while the engine is still published to the daemons."""
        deadline = time.monotonic() + 15.0
        while ctx.status()["slo"].get("evaluations", 0) < 3:
            if time.monotonic() > deadline:
                raise AssertionError(f"observed: the SLO watcher did not tick "
                                     f"3 times: {ctx.status()['slo']}")
            time.sleep(0.05)
        live["slo"] = ctx.status()["slo"]
        nodefile = os.path.join(tmp, "nodefile")
        with open(nodefile, "w") as fh:
            fh.writelines(f"{e.rank} {e.host} {e.port}\n" for e in cl.entries)
        obs = ("-m", "oncilla_tpu_torch.obs")
        t0 = time.perf_counter()
        started = [_start((*obs, *a)) for a in (
            ("--nodefile", nodefile), ("--nodefile", nodefile, "--prom", "0"),
            ("slo", "--nodefile", nodefile, "--json", "--interval", "0.2"))]
        table, prom, slo = _finish(started)
        report["seconds_by"]["live_cli"] = time.perf_counter() - t0
        live["cli"] = {"table": table, "prom": prom, "slo": slo,
                       "engine": eng.stats.engine}

    class ObservedEngine(Recording):
        def __init__(self, *args, **kw):
            super().__init__(*args, graphs="engine", timed=False, **kw)
            made.append(self)

        def metrics_meta(self):
            # The cell has finished and timed itself; the engine is still
            # published, so the operator's view of it is taken now.
            if self.stats.engine.endswith("-shared"):
                live_checks(self, *live_args)
            return super().metrics_meta()

    got = {}
    real = engine_mod.ServingEngine
    engine_mod.ServingEngine = ObservedEngine
    try:
        with tempfile.TemporaryDirectory(prefix="ocm-observed-") as tmp:
            fr_dir = os.path.join(tmp, "flightrec")
            trace_dir = os.path.join(tmp, "trace")
            with flightrec.recording(fr_dir), inprocess_cluster(
                    3, config=harness._cluster_cfg(
                        host_arena_bytes=ref["host_arena_bytes"])) as cl:
                # The operator's handle on the cluster: host memory only,
                # its device arm a CPU buffer nothing here touches.
                ctx = cl.context(0, device="cpu", heartbeat=False)
                live_args = (cl, ctx, tmp)
                try:
                    runner = ctx.start_slo(interval_s=slo_interval_s)
                    if runner is None:
                        raise AssertionError("observed: OCM_SLO disabled the watcher")
                    runner.tick()  # the baseline: every counter before the cells
                    for name, share in (("noshare", False), ("shared", True)):
                        if on_card:
                            torch.cuda.synchronize(device)
                        # The main path: counts from 0 just before the cell.
                        dma.reset_launches()
                        t0 = time.perf_counter()
                        with (capture_trace(trace_dir) if share
                              else contextlib.nullcontext()):
                            cell = harness._run_cell(
                                cl, cfg, params, share=share, prompts=prompts,
                                new_tokens=new_tokens, page_tokens=page_tokens,
                                hot=hot, warm=warm, prefetch_workers=0,
                                name=f"harness-observed-{name}")
                            if on_card:
                                torch.cuda.synchronize(device)
                        # The cell with its setup, capture and close, but not
                        # the live CLIs its engine ran before closing.
                        report["seconds_by"][f"cell_{name}"] = (
                            time.perf_counter() - t0
                            - report["seconds_by"].get("live_cli", 0.0) * share)
                        cell["launches"] = dma.launches()
                        cell["hot_io"] = dict(made[-1].store.io["hbm"])
                        cell["rows"] = made[-1].rows
                        report["cells"][name] = cell
                        for k, v in cell["launches"].items():
                            got[k] = got.get(k, 0) + v
                    path = os.path.join(tmp, "cluster.trace.json")
                    summary = ctx.export_trace(path)
                    with open(path, encoding="utf-8") as fh:
                        exported = json.load(fh)
                finally:
                    ctx.stop_slo()
                    ctx.tini()
                report["drained_ranks"] = harness._assert_drained(cl)
            report["journal_on_after"] = journal.enabled()
            t0 = time.perf_counter()
            report["profiler"] = _profiled_kernels(trace_dir)
            report["seconds_by"]["profiler_read"] = time.perf_counter() - t0
            # (d) and (h), side by side.
            t0 = time.perf_counter()
            procs = _finish([
                _start(("-m", "oncilla_tpu_torch.obs", "critpath", fr_dir,
                        "--require-cross-rank")),
                _start(("-c", "import chip_smoke, sys; "
                              "sys.exit(chip_smoke._operator_clis())",
                        json.dumps(clis)), nice=-10)])
            report["seconds_by"]["clis"] = time.perf_counter() - t0
    finally:
        engine_mod.ServingEngine = real
    report["launches"] = got

    # (a) Observing changes no result.
    for name, cell in report["cells"].items():
        want = ref["cells"][name]
        outputs = cell.pop("outputs")
        rows = cell.pop("rows")
        if outputs["t0"] != outputs["t1"]:
            raise AssertionError(f"observed {name}: identical prompts decoded "
                                 f"apart: {outputs['t0']} vs {outputs['t1']}")
        cell["vs_unobserved"] = (
            "bits" if outputs == want["outputs"] else _margin_check(want["rows"], rows))
        if cell["vs_unobserved"] != "bits":
            _hold_margin(f"observed {name} against 8e's", cell["vs_unobserved"])
        pair = (cell["launches"]["write_rows"], cell["launches"]["read_rows"])
        io = (cell["hot_io"]["put"], cell["hot_io"]["get"])
        if check_launches and (pair != io or not all(pair)):
            raise AssertionError(f"observed {name}: K1/K2 launches {pair} != HOT "
                                 f"puts/gets {io}")
        log(f"[observed] (a) {name}: {cell['decode_tokens']} tokens in "
            f"{cell['wall_s']} s, {cell['tok_s']} tokens/s (8e {want['tok_s']}), "
            f"remote bytes {cell['remote_bytes']}, K1/K2 {pair[0]}/{pair[1]} (8e "
            f"{want['launches']['write_rows']}/{want['launches']['read_rows']}), "
            f"HOT io {io}; tokens against 8e's: "
            f"{json.dumps(cell['vs_unobserved'])}")
    del made

    # (b) The SLO watcher's verdicts, printed, not held green.
    slo = live["slo"]
    verdicts = {v["objective"]: v for v in slo.get("objectives", [])}
    report["slo"] = {
        "ok": slo.get("ok"), "evaluations": slo["evaluations"],
        "history": slo["history"],
        "verdicts": {n: {k: v[k] for k in ("active", "ok", "burn_fast", "burn_slow")}
                     for n, v in verdicts.items()}}
    for name, v in report["slo"]["verdicts"].items():
        log(f"[observed] (b) slo {name}: {json.dumps(v)}")
    if slo["history"]["errors"] != 0 or slo["history"]["scrapes"] < 3:
        raise AssertionError(f"observed: SLO scrapes {slo['history']}")
    idle = [n for n in ("serving_ttft", "serving_tokens")
            if not verdicts.get(n, {}).get("active")]
    if idle:
        raise AssertionError(f"observed: the serving objectives {idle} saw no "
                             f"traffic: {report['slo']}")

    # (c) The exported cluster trace.
    spans = {e["name"] for e in exported["traceEvents"] if e.get("ph") == "X"}
    report["export"] = {**summary, "span_names": sorted(spans)}
    log(f"[observed] (c) export: {json.dumps(report['export'])}")
    page_path = ({"put", "get"} <= spans or {"dcn_put", "dcn_get"} <= spans)
    if summary["tracks"] < 3 or summary["flows"] < 1 or not page_path \
            or "serve_batch_step" not in spans:
        raise AssertionError(f"observed: the export lacks tracks, flows or the "
                             f"page path's spans: {report['export']}")

    # (d) The critical path over the flight recorder's segments.
    rc, so, se, _ = procs[0]
    report["critpath"] = {"rc": rc, "head": so.strip().splitlines()[:14]}
    log("[observed] (d) critpath --require-cross-rank:\n"
        + "\n".join(report["critpath"]["head"]))
    if rc != 0:
        raise AssertionError(f"observed: obs critpath exited {rc}: "
                             f"{so[-3000:]}{se[-3000:]}")

    # (e) The profiler's timeline: the shared cell's kernels, inside the
    # ops' ranges.
    prof = report["profiler"]
    log(f"[observed] (e) capture_trace: {json.dumps(prof)}")
    sl = report["cells"]["shared"]["launches"]
    launched = sl["write_rows"] + sl["read_rows"] + sl["local_copy"]
    in_ops = sum(prof["in_ocm_ranges"].get(n, 0) for n in ("ocm:put", "ocm:get"))
    if not any(n in prof["ocm_ranges"] for n in ("ocm:put", "ocm:get")):
        raise AssertionError(f"observed: no ocm:put/ocm:get range on the "
                             f"timeline: {prof}")
    if on_card and not prof["bulk_kernels"] == in_ops == launched:
        raise AssertionError(f"observed: {prof['bulk_kernels']} {_BULK_KERNEL} "
                             f"events ({prof['in_ocm_ranges']} by innermost "
                             f"ocm: range) for {launched} K1/K2/K3 launches")

    # (f) The CLI against the live cluster.
    cli = live["cli"]
    (table_rc, table, table_err, _), (prom_rc, prom, prom_err, _), \
        (slo_rc, slo_out, _, _) = cli["table"], cli["prom"], cli["slo"]
    if table_rc != 0 or cli["engine"] not in table:
        raise AssertionError(f"observed: obs table exited {table_rc} without the "
                             f"engine's serving row: {table[-3000:]}{table_err[-2000:]}")
    if prom_rc != 0 or "ocm_serving_ttft_seconds" not in prom:
        raise AssertionError(f"observed: obs --prom 0 exited {prom_rc} without "
                             f"ocm_serving_ttft_seconds: {prom_err[-2000:]}")
    slo_doc = json.loads(slo_out)
    if slo_rc != (0 if slo_doc["ok"] else 1):
        raise AssertionError(f"observed: obs slo exited {slo_rc} with "
                             f"ok={slo_doc['ok']}")
    report["cli"] = {"table_rc": table_rc, "prom_rc": prom_rc, "slo_rc": slo_rc,
                     "slo_ok": slo_doc["ok"]}
    log("[observed] (f) obs --nodefile:\n" + table.rstrip())
    log(f"[observed] (f) {json.dumps(report['cli'])}")

    # (g) What observing costs.
    report["tok_s"] = {n: c["tok_s"] for n, c in report["cells"].items()}
    report["tok_s_unobserved"] = {n: c["tok_s"] for n, c in ref["cells"].items()}
    if on_card:
        arena = torch.zeros(64 * MiB, dtype=torch.uint8, device=device)
        small = torch.randint(0, 256, (BLOCK,), dtype=torch.uint8, device=device)
        report["host_us_k1"] = kt.host_us(lambda: dma.write_rows(arena, small, 12 * KiB))
        report["host_us_k1_phase3"] = host_us_ref
        del arena, small
        torch.cuda.empty_cache()
    log(f"[observed] (g) tokens/s observed {report['tok_s']} against unobserved "
        f"{report['tok_s_unobserved']}; K1 host_us at 4 KiB, recording off, "
        f"{report.get('host_us_k1')} against phase 3's {host_us_ref}")
    if report["journal_on_after"]:
        raise AssertionError("observed: the journal stayed on after the phase")

    # (h) The operator's CLIs, each ending on its OK line.
    rc, so, se, sec = procs[1]
    ran = [json.loads(line) for line in so.splitlines() if line.startswith("{")]
    report["clis"] = {"rc": rc, "seconds": round(sec, 3)}
    for r in ran:
        name = " ".join(r["cmd"])
        last = (r["out"].strip().splitlines() or [""])[-1]
        report["clis"][name] = {"rc": r["rc"], "seconds": round(r["seconds"], 3),
                                "last": last[:160]}
        log(f"[observed] (h) {name}: {json.dumps(report['clis'][name])}")
        if r["rc"] != 0 or " OK" not in last:
            raise AssertionError(f"python -m oncilla_tpu_torch.{name} returned "
                                 f"{r['rc']}: {r['out']}{r['err']}")
    if rc != 0 or [r["cmd"] for r in ran] != [list(c) for c in clis]:
        raise AssertionError(f"observed: the CLIs' process exited {rc} after "
                             f"{len(ran)} of {len(clis)}: {so[-3000:]}{se[-3000:]}")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[observed] checks passed; phase {report['seconds']:.3f} s; by part "
        f"{json.dumps(report['seconds_by'])}")
    return report


# -- phase D ----------------------------------------------------------------


def phase_demo(device, expect=DEMO_LAUNCHES) -> dict:
    """Phase D (module docstring): the walkthrough's ``main`` on ``device``
    with every kernel's count zeroed before it; its printed lines, its
    seconds and the launches, which must equal ``expect`` (every kernel
    not named there at 0)."""
    from oncilla_tpu_torch.examples import demo
    from oncilla_tpu_torch.ops import dma

    out = io.StringIO()
    dma.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = demo.main(["--device", device.type])
    seconds = time.perf_counter() - t0
    launches = dma.launches()
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[demo] {line}")
    if rc != 0 or lines[-1:] != ["demo complete"] or len(lines) != 11:
        raise AssertionError(f"demo: rc {rc}, lines {lines}")
    want = {k: expect.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"demo: launches {launches}, predicted {want}")
    log(f"[demo] launches {launches}; phase {seconds:.3f} s")
    return {"seconds": seconds, "launches": launches, "lines": lines}


# -- phase 5m ---------------------------------------------------------------

# Mixtral-8x7B at its published widths, its depth cut to 8 of 32 layers:
# the 32 layers' bf16 weights (93.4 GB) exceed the card's 80 GB, 8 hold
# 23.75 GB (2.90 GB a layer, 2.82 of it the experts, plus 0.52 GB of
# embedding and head). One request: a 256-token seeded prompt, then 128
# greedy tokens, all consumed, over 128-token pages of 4 MiB (at or above
# the 1 MiB at which an arena move is K1/K2; a 16-token page, 512 KiB,
# would miss the kernels), REMOTE_DEVICE on two in-process daemons' rows.
MOE_LAYERS = 8
MOE_PROMPT, MOE_GEN = 256, 128
MOE_PAGE_TOKENS = 128
MOE_ROW = 64 * MiB
MOE_SEED = 14


def moe_token_bytes(cfg) -> dict:
    """Weight bytes one MoE decode token must read (the KV history, at
    most 12.6 MB here, left out): the dense dispatch reads every expert of
    every layer, a sparse gather of the top-k experts only k of them; both
    read attention, router, norms, an embedding row and the head."""
    from oncilla_tpu_torch.models.llama import torch_dtype

    b = torch_dtype(cfg.dtype).itemsize
    L, D, Hd = cfg.n_layers, cfg.dim, cfg.head_dim
    shared = (L * D * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * Hd * b
              + L * D * cfg.n_experts * b + (2 * L + 1) * D * 4
              + D * b + D * cfg.vocab * b)
    expert = 3 * D * cfg.ffn_hidden * b
    return {"dense": shared + L * cfg.n_experts * expert,
            "sparse": shared + L * cfg.top_k * expert}


def _buckets(npages: int) -> int:
    """Context shapes a decoder meets over ``npages`` page boundaries
    (``kv_paging.bucket_context``): one graph each."""
    return len({p if p <= 1 else 1 << (p - 1).bit_length()
                for p in range(npages)})


# The masked fixed-shape step (``paged_token_step``, what a graph captures)
# attends over the padded tail and context where the unpaged decode slices
# the valid keys, so its bf16 activations part from (a)'s in low bits; an
# expert whose router score sits within those bits of the next one's then
# flips, and that moves the token's logits by far more than the dense
# family's margin rule allows. A wrong page moves every row after it; a
# flip moves the rows of one token's routing. So the masked step is held
# to (a) by the share of rows whose tokens agree and by the median row's
# largest logit difference.
MOE_TOKENS_AGREE = 0.9


def _moe_rows_check(ref: torch.Tensor, got: torch.Tensor, prompt_len: int) -> dict:
    """Every generated row (teacher-forced on (a)'s ids, so each row has
    (a)'s context): the share whose greedy tokens agree, the median and
    largest of the rows' largest logit difference, and where they part
    (with the reference's top-2 margin there)."""
    a, b = ref[prompt_len - 1:], got[prompt_len - 1:]
    diff = (a - b).abs().amax(dim=-1)
    agree = a.argmax(-1) == b.argmax(-1)
    top2 = torch.topk(a, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    part = (~agree).nonzero().flatten().tolist()
    return {"rows": a.shape[0], "tokens_agree": int(agree.sum()),
            "median_row_diff": float(diff.median()),
            "max_abs_logit_diff": float(diff.max()),
            "rows_differ": int((diff > 0).sum()),
            "splits": [{"pos": prompt_len - 1 + i, "top2_margin": float(margin[i]),
                        "logit_diff": float(diff[i])} for i in part]}


def _hold_moe_rows(what: str, d: dict) -> None:
    """Raise unless at least :data:`MOE_TOKENS_AGREE` of the rows' tokens
    agree and the median row differs by at most :data:`MARGIN_MAX_DIFF`."""
    if (d["tokens_agree"] < MOE_TOKENS_AGREE * d["rows"]
            or d["median_row_diff"] > MARGIN_MAX_DIFF):
        raise AssertionError(f"{what}: tokens or logits part from the unpaged "
                             f"decode past the rule's limits: {d}")


def phase_moe(device, cfg, params, *, prompt_len: int = MOE_PROMPT,
              n_gen: int = MOE_GEN, page_tokens: int = MOE_PAGE_TOKENS,
              row_bytes: int = MOE_ROW, rate: float | None = None,
              check_launches: bool = True) -> dict:
    """Phase 5m: MoE decode at Mixtral width through the paged decoders.

    (a) the references: unpaged ``moe.generate`` (prompt, then ``n_gen``
    greedy tokens) and the teacher-forced ``decode_loop(step_fn=
    moe.decode_step)`` over the consumed ids, whose greedy tokens must be
    generate's; then, with ``moe.paged_hooks(cfg)`` and REMOTE_DEVICE pages
    placed by two in-process daemons on an ``IciDataPlane`` of four rows on
    the card, (b) ``PagedDecoder`` and (c) ``BucketedPagedDecoder(refetch=
    True)`` stepped a token at a time (greedy after the prompt): logits at
    every position and tokens equal (a)'s bit for bit; (d) the same
    decoder's ``step_page``, teacher-forced on (a)'s ids, first with its
    token steps eager (``bucketed_pages``: the masked fixed-shape step,
    held to (a) by :func:`_hold_moe_rows`), then through a ``StepGraphs``
    (``bucketed_graphs``: one captured step a context bucket, at most the
    buckets, its logits the eager run's bit for bit). In every mode the
    pages stored and fetched are the plane's puts and gets, each one
    K1/K2 launch. Prints tokens/s and ms a token for each mode beside the
    bounds of the dense dispatch's and a sparse top-k gather's weight
    bytes at ``rate``."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.core.hbm import _PALLAS_IO_MIN
    from oncilla_tpu_torch.models import kv_paging, llama, moe
    from oncilla_tpu_torch.models.graphs import StepGraphs
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.ops.ici import IciDataPlane
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
    from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    n = prompt_len + n_gen
    npages = n // page_tokens
    page = kv_paging.page_bytes(cfg, page_tokens, cfg.dtype)
    if on_card and page < _PALLAS_IO_MIN:
        raise AssertionError(f"a {page} B page is below the kernels' "
                             f"{_PALLAS_IO_MIN} B threshold")
    hooks = moe.paged_hooks(cfg)
    prompt = torch.from_numpy(np.random.default_rng(MOE_SEED).integers(
        0, cfg.vocab, prompt_len)).to(device)
    tb = moe_token_bytes(cfg)
    bounds = ({k: v / rate * 1e3 for k, v in tb.items()} if rate else {})
    report = {"layers": cfg.n_layers, "page_bytes": page, "pages": npages,
              "token_bytes": tb, "bound_ms": bounds, "modes": {}}
    launches = {k: 0 for k in dma.launches()}
    log(f"[moe] {cfg.n_layers} layers dim {cfg.dim}, {cfg.n_experts} experts "
        f"top-{cfg.top_k}, page {page} B; weight bytes a token: dense "
        f"{tb['dense']}, sparse {tb['sparse']}; bounds {bounds}")

    # (a) the unpaged references.
    rcfg = dataclasses.replace(cfg, max_seq=n)
    t = time.perf_counter()
    gen, _ = moe.generate(params, prompt[None], llama.make_kv_cache(
        rcfg, 1, device=device), cfg, n_gen)
    sync()
    gen_s = time.perf_counter() - t
    ids = torch.cat([prompt, gen[0]])
    t = time.perf_counter()
    with torch.no_grad():
        ref, _ = llama.decode_loop(params, ids[None], llama.make_kv_cache(
            rcfg, 1, device=device), cfg, step_fn=moe.decode_step)
    sync()
    loop_s = time.perf_counter() - t
    ref = ref[0]
    if ref.shape != (n, cfg.vocab) or not torch.isfinite(ref).all():
        raise AssertionError(f"reference logits malformed: {tuple(ref.shape)}")
    if not torch.equal(llama.greedy(ref[prompt_len - 1:n - 1]), gen[0]):
        raise AssertionError("generate's tokens are not the teacher-forced "
                             "decode's greedy tokens")
    for name, s in (("generate", gen_s), ("decode_loop", loop_s)):
        report["modes"][name] = {"seconds": s, "tok_s": n / s,
                                 "ms_per_token": s / n * 1e3}
    log(f"[moe] (a) generate {gen_s:.3f} s, decode_loop {loop_s:.3f} s over "
        f"{n} tokens")

    def stepped(dec):
        """Prompt teacher-forced, then greedy: (consumed ids, logits)."""
        got, rows = list(prompt.view(-1, 1)), []
        for t in range(n):
            lg = dec.step(got[t])
            rows.append(lg)
            if t + 1 >= prompt_len and len(got) < n:
                got.append(llama.greedy(lg))
        return torch.cat(got), torch.cat(rows)

    def paged(dec):
        """(d): every page through ``step_page``, teacher-forced on (a)."""
        return ids, torch.cat([dec.step_page(ids[None, p * page_tokens:
                                                 (p + 1) * page_tokens])[0]
                               for p in range(npages)])

    cl_cfg = ocm.OcmConfig(device_arena_bytes=row_bytes,
                           host_arena_bytes=16 * MiB)
    with inprocess_cluster(2, config=cl_cfg, ndevices=2) as cl:
        plane = IciDataPlane(ocm.OcmConfig(device_arena_bytes=row_bytes),
                             devices=[device] * 4, devices_per_rank=2)
        ctx = cl.context(0, ici_plane=plane, device=device)
        kw = dict(batch=1, page_tokens=page_tokens, kind=OcmKind.REMOTE_DEVICE,
                  dtype=cfg.dtype, **hooks)
        outs = {}
        fetched_all = npages * (npages + 1) // 2

        def bucketed(graphs=None):
            return kv_paging.BucketedPagedDecoder(params, cfg, ctx, refetch=True,
                                                  graphs=graphs, **kw)

        def eager(dec):
            dec.graphs = None  # step_page's token steps run eagerly
            return dec

        modes = (  # name, decoder, drive, pages fetched, held against
            ("paged", lambda g: kv_paging.PagedDecoder(params, cfg, ctx, **kw),
             stepped, 0, "a"),
            ("bucketed", lambda g: bucketed(), stepped, fetched_all, "a"),
            ("bucketed_pages", lambda g: eager(bucketed()), paged, fetched_all,
             "a_moe"),
            ("bucketed_graphs", bucketed, paged, fetched_all, "bucketed_pages"),
        )
        for name, make, drive, want_fetched, against in modes:
            graphs = StepGraphs(params, cfg) if name == "bucketed_graphs" else None
            moves0 = [GLOBAL_TRACER.stats(s).count for s in ("ici_put", "ici_get")]
            dma.reset_launches()
            t = time.perf_counter()
            with torch.no_grad():
                dec = make(graphs)
                got_ids, got = drive(dec)
                shipped = len(dec.cache.pages)
                dec.close()
            sync()
            seconds = time.perf_counter() - t
            rose = dma.launches()
            for k, v in rose.items():
                launches[k] += v
            stored, fetched = (GLOBAL_TRACER.stats(s).count - m
                               for s, m in zip(("ici_put", "ici_get"), moves0))
            r = {"seconds": seconds, "tok_s": n / seconds,
                 "ms_per_token": seconds / n * 1e3, "pages": shipped,
                 "page_stores": stored, "page_fetches": fetched,
                 "launches": {k: v for k, v in rose.items() if v}}
            if shipped != npages or (stored, fetched) != (npages, want_fetched):
                raise AssertionError(
                    f"{name}: {shipped} pages shipped, {stored} stored and "
                    f"{fetched} fetched on the plane, want {npages}, {npages} "
                    f"and {want_fetched}")
            if check_launches and (rose["write_rows"], rose["read_rows"]) != (
                    stored, fetched):
                raise AssertionError(f"{name}: launches {rose}, want "
                                     f"write_rows, read_rows = {stored}, {fetched}")
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name}: logits malformed")
            if against == "a_moe":
                r["vs_unpaged"] = _moe_rows_check(ref, got, prompt_len)
                _hold_moe_rows(name, r["vs_unpaged"])
            else:
                want = ref if against == "a" else outs[against]
                if not torch.equal(got_ids, ids):
                    raise AssertionError(f"{name}: tokens differ from {against}'s")
                if not torch.equal(got, want):
                    err = float((got - want).abs().max())
                    raise AssertionError(f"{name}: logits differ from {against}'s "
                                         f"(max |d| {err})")
                r["vs_" + ("unpaged" if against == "a" else against)] = "bits"
            outs[name] = got
            if graphs is not None:
                g = r["graphs"] = {"keys": len(graphs.steps),
                                   "captured": graphs.captured,
                                   "capture_s": graphs.capture_s,
                                   "buckets": _buckets(npages)}
                graphs.close()
                if g["keys"] > g["buckets"] or (on_card and g["captured"]
                                                != g["keys"]):
                    raise AssertionError(f"{name}: graphs {g}, want one "
                                         "captured graph a context bucket")
            if bounds:
                r["bound_share"] = {k: v / r["ms_per_token"]
                                    for k, v in bounds.items()}
            report["modes"][name] = r
            log(f"[moe] {name}: {json.dumps(r)}")
        ctx.tini()
        if any(d.registry.live_count() for d in cl.daemons):
            raise AssertionError("pages left on the daemons after close")
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[moe] launches {launches}; phase {report['seconds']:.3f} s")
    return report


# -- main -------------------------------------------------------------------


# -- phase 9 ----------------------------------------------------------------

# Phase 9's workload: the JAX package's training flagship
# (benchmarks/mfu.train_sized_config: 1.1B parameters, bf16, all 16 layers,
# batch 4 of 1024 tokens) with the production optimizer.
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
TRAIN_ARENA = 16 * GiB
# Token ids drawn from a Zipf law over the vocabulary (s = 1.1), as word
# frequencies in text fall: uniform ids would leave the model nothing to
# learn in 8 steps but the scale of its logits.
ZIPF_S = 1.1


def zipf_batches(vocab: int, batch: int, seq: int, n: int, seed: int):
    """``n`` int32 (batch, seq) numpy batches of Zipf-distributed ids."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** ZIPF_S
    p /= p.sum()
    for _ in range(n):
        yield rng.choice(vocab, size=(batch, seq), p=p).astype(np.int32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


def _same_tree(a, b, what: str) -> None:
    """Every leaf of two train states equal bit for bit."""
    from oncilla_tpu_torch.models.checkpoint import _walk

    la, lb = list(_walk(a)), list(_walk(b))
    if [k for k, _ in la] != [k for k, _ in lb]:
        raise AssertionError(f"{what}: the trees differ in structure")
    for (key, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                _bits(x), _bits(y).to(x.device)):
            raise AssertionError(f"{what}: leaf {key} differs")


def _region_against_plain(ctx, h, tree, back) -> None:
    """K1 and K2 each held against its plain version at a LOCAL_DEVICE
    checkpoint's size, which is larger than any extent the kernel phases
    copy: after the save's write_rows, the (fresh, zeroed) arena holds the
    packed region at the handle's extent and zeros everywhere else, as
    write_rows_plain leaves it; the buffer the load's read_rows filled (the
    one the loaded leaves are views of) equals read_rows_plain of the same
    extent. Bit for bit."""
    from oncilla_tpu_torch.models import checkpoint as ck
    from oncilla_tpu_torch.ops import dma

    arena = ctx.device_arenas[h.device_index].buffer
    off, n = h.extent.offset, h.nbytes
    if not torch.equal(arena[off:off + n], ck._pack(tree)):
        raise AssertionError(f"write_rows left other bytes than write_rows_plain "
                             f"in the {n} B checkpoint's extent")
    if arena[:off].any() or arena[off + n:].any():
        raise AssertionError("write_rows wrote outside the checkpoint's extent")
    leaves = [t for _, t in ck._walk(back)]
    storage = leaves[0].untyped_storage()
    if any(t.untyped_storage().data_ptr() != storage.data_ptr() for t in leaves):
        raise AssertionError("the loaded leaves are not views of one buffer")
    loaded = torch.empty(0, dtype=torch.uint8, device=leaves[0].device).set_(storage)
    if loaded.numel() != n or not torch.equal(loaded, dma.read_rows_plain(arena, off, n)):
        raise AssertionError(f"read_rows read other bytes than read_rows_plain from "
                             f"the {n} B checkpoint's extent")


def _clone_state(params, opt, host_moments: bool = False):
    """A copy of (params, opt_state); ``host_moments`` puts Adam's µ and ν in
    pinned host memory (the ``offload_opt`` placement)."""
    from oncilla_tpu_torch.models.optim import ScaleByAdamState

    def moment(t):
        if not host_moments:
            return t.clone()
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda).copy_(t)

    adam = opt[0]
    return ({k: v.clone() for k, v in params.items()},
            (ScaleByAdamState(adam.count.clone(),
                              {k: moment(v) for k, v in adam.mu.items()},
                              {k: moment(v) for k, v in adam.nu.items()}), *opt[1:]))


def _timed_steps(step, params, opt, batch, n: int, device) -> tuple:
    """``n`` steps on ``batch``, each synchronised: (params, opt, loss, ms)."""
    ms = []
    for _ in range(n):
        t = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t) * 1e3)
    return params, opt, loss, ms


def profile_train_step(step, params, opt, batch, device) -> dict:
    """One train step under ``torch.profiler``: the device's busy share
    (the kernels' summed time over the window's wall time; one stream, so
    kernels do not overlap; the profiler's cost is in the wall time, so the
    share is a lower bound) and the kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) * 1e-6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {
        "wall_ms": wall * 1e3, "device_busy_ms": busy_s * 1e3,
        "device_busy_share": busy_s / wall if kernels else None,
        "launches": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:70]: e.self_device_time_total * 1e-3 for e in top},
    }


def phase_train(device, cfg, batch: int, seq: int, *, steps: int = TRAIN_STEPS,
                arena_bytes: int = TRAIN_ARENA, timing: bool = True,
                check_launches: bool = True) -> dict:
    """Phase 9: dense Llama training on the card. (a) ``steps`` steps of
    ``make_train_step`` with ``adamw(3e-4, 0.01)`` on batches from
    ``prefetch_to_device``: finite losses, the last below the first; (b)
    the whole train state (params, µ, ν, count) through
    ``checkpoint.save`` to LOCAL_DEVICE on an ``arena_bytes`` arena (one
    write_rows launch a save, read_rows on load, each kernel's bytes equal
    its plain version's at that size, the loaded state equal bit for bit),
    then to LOCAL_HOST, and the params alone to REMOTE_HOST on
    two of the port's daemons, each loaded back bit for bit; (c) one step
    from the restored state against one from the live state and (d) 2
    steps with ``offload_opt`` against 2 plain steps, under
    ``torch.use_deterministic_algorithms``, equal bit for bit; (e) step ms,
    tokens/s and MFU, and one profiled step."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.benchmarks.mfu import train_flops
    from oncilla_tpu_torch.models import checkpoint as ck
    from oncilla_tpu_torch.models import train
    from oncilla_tpu_torch.ops import dma
    from oncilla_tpu_torch.runtime.cluster import local_cluster
    from oncilla_tpu_torch.utils.data import prefetch_to_device
    from oncilla_tpu_torch.utils.platform import peak_flops

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    params, opt, tx = train.make_train_state(cfg, lr=TRAIN_LR, device=device, seed=0)
    step = train.make_train_step(cfg, tx)
    data = list(zipf_batches(cfg.vocab, batch, seq, steps + 4, seed=9))
    report: dict = {"batch": batch, "seq": seq, "steps": steps}
    # The main path: counts from 0 just before, read just after.
    dma.reset_launches()

    # (a) Training on prefetched batches.
    losses, step_ms = [], []
    for tokens in prefetch_to_device(iter(data[:steps]), device):
        t = time.perf_counter()
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))  # synchronises
        step_ms.append((time.perf_counter() - t) * 1e3)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite, or not falling")
    report.update(losses=losses, step_ms=step_ms)
    log(f"[train] (a) {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"step ms {[round(m, 2) for m in step_ms]}")

    # (b) The whole train state through the checkpoint.
    state = {"params": params, "opt": opt}
    nbytes = ck.checkpoint_nbytes(state)
    p_bytes = ck.checkpoint_nbytes(params)
    rates = report["checkpoint"] = {"state_bytes": nbytes, "params_bytes": p_bytes}

    def round_trip(ctx, tree, kind, nbytes, what):
        w0, r0 = dma.write_rows.launches, dma.read_rows.launches
        sync()
        t = time.perf_counter()
        h = ck.save(ctx, tree, kind)
        sync()
        put_s = time.perf_counter() - t
        k1 = dma.write_rows.launches - w0
        t = time.perf_counter()
        back = ck.load(ctx, h, like=tree)
        sync()
        get_s = time.perf_counter() - t
        k2 = dma.read_rows.launches - r0
        _same_tree(tree, back, f"{what} checkpoint")
        rates[what] = {"save_gbps": nbytes / put_s / 1e9, "load_gbps": nbytes / get_s / 1e9,
                       "save_s": put_s, "load_s": get_s, "K1": k1, "K2": k2}
        log(f"[train] (b) {what}: {nbytes} B, save {rates[what]['save_gbps']:.3f} GB/s, "
            f"load {rates[what]['load_gbps']:.3f} GB/s; K1 {k1}, K2 {k2}; bit for bit")
        return h, back

    cfg_ctx = ocm.OcmConfig(host_arena_bytes=nbytes + MiB, device_arena_bytes=arena_bytes)
    with ocm.ocm_init(cfg_ctx, device=device) as ctx:
        h, restored = round_trip(ctx, state, OcmKind.LOCAL_DEVICE, nbytes, "LOCAL_DEVICE")
        _region_against_plain(ctx, h, state, restored)
        log(f"[train] (b) LOCAL_DEVICE: write_rows = write_rows_plain and read_rows = "
            f"read_rows_plain on the {nbytes} B region, bit for bit")
        if check_launches and (rates["LOCAL_DEVICE"]["K1"] != 1
                               or rates["LOCAL_DEVICE"]["K2"] < 1):
            raise AssertionError(f"a LOCAL_DEVICE save is not one write_rows launch, or "
                                 f"its load no read_rows launch: {rates['LOCAL_DEVICE']}")
        ctx.free(h)
        h, _ = round_trip(ctx, state, OcmKind.LOCAL_HOST, nbytes, "LOCAL_HOST")
        ctx.free(h)
    with local_cluster(2, host_arena_bytes=[MiB, p_bytes + 64 * MiB],
                       device_arena_bytes=MiB) as cl:
        ctx = cl.context(0, device=device)
        h, _ = round_trip(ctx, params, OcmKind.REMOTE_HOST, p_bytes, "REMOTE_HOST")
        if h.rank != 1 or not h.is_remote:
            raise AssertionError(f"the REMOTE_HOST checkpoint landed on rank {h.rank}")
        ctx.free(h)
        ctx.tini()
    if on_card:
        torch.cuda.empty_cache()

    # (c), (d) under deterministic algorithms (the embedding's backward
    # accumulates with atomics otherwise).
    torch.use_deterministic_algorithms(True)
    try:
        tokens = torch.from_numpy(data[steps]).to(device)
        # (c) resumed step against live step.
        *live, loss_live = step(params, opt, tokens)
        *resumed, loss_resumed = step(restored["params"], restored["opt"], tokens)
        _same_tree(live, resumed, "(c) the resumed step")
        if not torch.equal(_bits(loss_live), _bits(loss_resumed)):
            raise AssertionError("(c) the resumed step's loss differs")
        del restored, resumed
        log("[train] (c) one step from the restored state = one from the live state, "
            "bit for bit")
        # (d) offloaded moments against plain, from the same state.
        plain_state = _clone_state(params, opt)
        off_state = _clone_state(params, opt, host_moments=True)
        off_step = train.make_train_step(cfg, tx, offload_opt=True, opt_state=off_state[1])
        d_batch = torch.from_numpy(data[steps + 1]).to(device)
        *plain_state, _, plain_ms = _timed_steps(step, *plain_state, d_batch, 2, device)
        *off_state, _, off_ms = _timed_steps(off_step, *off_state, d_batch, 2, device)
        _same_tree(plain_state, off_state, "(d) the offloaded steps")
        report["offload"] = {"plain_ms": plain_ms, "offload_ms": off_ms}
        log(f"[train] (d) 2 offload_opt steps = 2 plain steps, bit for bit; step ms "
            f"plain {[round(m, 2) for m in plain_ms]}, offload {[round(m, 2) for m in off_ms]}")
        del plain_state, off_state
    finally:
        torch.use_deterministic_algorithms(False)

    # (e) Step time, tokens/s, MFU; one profiled step.
    steady = step_ms[1:]  # the first step warms cuBLAS and the allocator
    med = statistics.median(steady)
    report["step_ms_median"] = med
    report["tokens_per_s"] = batch * seq / med * 1e3
    flops = train_flops(cfg, batch, seq)
    report["train_flops"] = flops
    if timing:
        peak = peak_flops(torch.cuda.get_device_name(device))
        report["mfu"] = flops / (med * 1e-3) / peak
        report["peak_tflops"] = peak / 1e12
    report["profile"] = profile_train_step(step, params, opt,
                                           torch.from_numpy(data[steps + 2]).to(device),
                                           device)
    report["launches"] = dma.launches()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[train] (e) step {med:.2f} ms median of {len(steady)}, "
        f"{report['tokens_per_s']:.1f} tokens/s, MFU {report.get('mfu')} "
        f"(peak {report.get('peak_tflops')} TFLOP/s); profile "
        + json.dumps(report["profile"]))
    log(f"[train] launches {report['launches']}; phase {report['seconds']:.3f} s")
    del params, opt, state
    if on_card:
        torch.cuda.empty_cache()
    return report


# Phase 9 (f): the MoE train step at Mixtral-8x7B widths, 2 of 32 layers
# (3.17 B parameters, 25 GB with gradients and moments in bf16), batch 4 x
# 1024.
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_BATCH = (4, 1024)


def phase_train_sharded(device, *, moe_cfg=None, moe_batch=MOE_TRAIN_BATCH,
                        dense=None, timing: bool = True,
                        check_launches: bool = True) -> dict:
    """Phase 9 (f) and (g) (module docstring), after phase 9 (a)-(e) in its
    process. ``moe_cfg`` (Mixtral-8x7B widths at ``MOE_TRAIN_LAYERS`` by
    default), ``dense`` ((cfg, batch, seq), phase 9's by default)."""
    from oncilla_tpu_torch.benchmarks import train_mesh
    from oncilla_tpu_torch.benchmarks.mfu import train_sized_config
    from oncilla_tpu_torch.models import moe

    t = time.perf_counter()
    mcfg = moe_cfg or dataclasses.replace(moe.MoeConfig.mixtral_8x7b(),
                                          n_layers=MOE_TRAIN_LAYERS)
    f = train_mesh.moe_train_card(device, mcfg, *moe_batch, timing=timing,
                                  check_launches=check_launches)
    log(f"[train] (f) MoE {mcfg.n_layers} layers, batch {moe_batch}: loss "
        f"{f['losses'][0]:.4f} -> {f['losses'][-1]:.4f}, step {f['step_ms_median']:.2f} "
        f"ms, {f['tokens_per_s']:.1f} tokens/s, MFU {f['mfu']} (dense dispatch, "
        f"{f['train_flops']:.4g} FLOP a step; active top-2 "
        f"{f['flops_active_top_k']:.4g}); trades {json.dumps(f['trades'])}; "
        f"checkpoint {json.dumps(f['checkpoint'])}; profile "
        f"{json.dumps(f.get('profile'))}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    try:
        cfg, batch, seq = dense or train_sized_config()
        g = train_mesh.mesh_of_one_card(device, cfg, batch, seq)
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train] (g) 2 steps on make_mesh(1) = 2 one-device steps, bit for bit "
        f"(losses {g['losses']})")
    return {"moe_train": f, "mesh_of_one": g, "seconds": time.perf_counter() - t}


def _train_child(queue, device, cfg, batch: int, seq: int, kw: dict,
                 sharded: dict | None) -> None:
    try:
        report = phase_train(device, cfg, batch, seq, **kw)
        if sharded is not None:
            report["sharded"] = phase_train_sharded(device, **sharded)
        queue.put(("ok", report))
    except BaseException:
        queue.put(("error", traceback.format_exc()))
        raise


def phase_train_isolated(cfg, batch: int, seq: int, device=None, sharded=None,
                         **kw) -> dict:
    """Phase 9 in a process of its own, with ``CUBLAS_WORKSPACE_CONFIG``
    set for that process only. Its bit-equal steps need cuBLAS's fixed
    workspace, which cuBLAS reads when a process makes its first handle;
    set in this process it would double the host's cost of every product
    (H100, 700 W: 2000 64x64 products 42-45 µs each without it, 98-102 µs
    with it; eager decode tokens/s 32-40 % lower;
    ``scripts/cublas_workspace_ab.py``)
    and slow the host-bound phases before it. ``device`` (cuda:0 by
    default) and ``kw`` go to :func:`phase_train`; with ``sharded`` (a dict
    of :func:`phase_train_sharded`'s arguments) phase 9 (f) and (g) follow
    in the same process."""
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        device = torch.device("cuda", 0) if device is None else device
        proc = mp.Process(target=_train_child,
                          args=(queue, device, cfg, batch, seq, kw, sharded))
        proc.start()
    finally:
        if before is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = before
    try:
        status, payload = queue.get(timeout=600)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if status != "ok":
        raise AssertionError(f"phase 9 failed in its process:\n{payload}")
    return payload


def phase_train_mesh(count: int, device: str = "cuda", timeout: float = 900.0) -> dict:
    """Phase T (module docstring): ``count`` processes, one a card (NCCL),
    or gloo processes at ``train_mesh.phase_t_sizes(False)``'s tiny sizes
    on the CPU when ``device`` is "cpu"; any child's failure fails the
    phase with its traceback. Returns the first process's report."""
    from oncilla_tpu_torch.benchmarks import train_mesh
    from oncilla_tpu_torch.parallel.launch import spawn

    sizes = train_mesh.phase_t_sizes(device == "cuda")
    rep = spawn("oncilla_tpu_torch.benchmarks.train_mesh:phase_t", count,
                args=(sizes, device), device=device, timeout=timeout)[0]
    for name in train_mesh.FAMILIES:
        r = rep[name]
        log(f"[train mesh] ({'abcd'[train_mesh.FAMILIES.index(name)]}) {name} "
            f"mesh {r['mesh']}, {r['layers']} layers, batch {r['batch']} x "
            f"{r['seq']}: loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, step "
            f"{r['step_ms_median']:.2f} ms, {r['tokens_per_s']:.1f} tokens/s, MFU "
            f"{r['mfu']} ({r['train_flops']:.4g} FLOP a step), collective bytes a "
            f"step {json.dumps(r['collective_bytes_per_step'])}, peak "
            f"{r.get('peak_memory_gb')} GB; profile {json.dumps(r.get('profile'))}")
    for name, r in rep["one_card"].items():
        log(f"[train mesh] (e) {name} mesh {r['mesh']}: losses {r['losses']} "
            f"against one card's {r['one_card_losses']} (rel {r['loss_rel']:.3g}), "
            f"updates within {r['update_rel']:.3g} (elementwise "
            f"{r['max_elementwise_rel']:.3g} of each leaf's scale)")
    log(f"[train mesh] (f) {json.dumps(rep['resume'])}")
    log(f"[train mesh] (g) {json.dumps(rep['multihost'])}")
    log(f"[train mesh] seconds {json.dumps(rep['seconds_by'])}")
    return rep


def across_cards() -> int:
    """``python3 chip_smoke.py --across-cards``: phase 6's one-sided copies
    and handle path with the 4 rows on 4 cards (cuda:0..3, or the cards
    there are, in turn), so every cross-row copy is a send storing into
    another card's memory over NVLink. Needs two or more cards."""
    count = torch.cuda.device_count()
    if count < 2:
        print("chip_smoke --across-cards: needs two or more cards",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    from oncilla_tpu_torch.benchmarks import sweep

    card = phase_device()
    phase_build()
    # Phase T first, while the cards hold nothing of this process's phases.
    t = time.perf_counter()
    trn = phase_train_mesh(count)
    print(json.dumps({"train_mesh": trn}))
    log(f"[train mesh] phase T with its processes {time.perf_counter() - t:.3f} s")
    mesh = [torch.device("cuda", i % count) for i in range(4)]
    fab = phase_fabric(
        mesh[0], row_bytes=2 * GiB - BLOCK, sizes=FABRIC_SIZES,
        rate=card["hbm_rate"], handle_sizes=(4 * KiB, PAGE, 256 * MiB),
        ring_bytes=64 * MiB, bench_kw={}, mesh=mesh, with_bench=False,
        timed=(PAGE, GiB),
    )
    print(json.dumps({"onesided_copy_across_cards": fab["rows"]["onesided_copy"],
                      "launches": fab["launches_handles"]}))
    # Phase 8's check (c) with the plane's rows on the cards: rank 1's rows,
    # where the daemons place, are the third and fourth cards.
    from oncilla_tpu_torch.runtime.cluster import local_cluster

    with local_cluster(2, ndevices=2, device_arena_bytes=WIRE_ROW) as cl:
        plane, ctx = wire_context(cl, mesh, WIRE_ROW, 4 * MiB)
        placed = wire_placed(ctx, plane, cl.nodefile, PAGE, 4)
        ctx.tini()
    log(f"[wire] (c) across cards: {json.dumps(placed)}")
    print(json.dumps({"wire_placed_across_cards": placed}))
    # The ring sweep with every row sending to the next card at once.
    ring = sweep.spmd_ring_sweep(mesh, min_bytes=1 * MiB, max_bytes=256 * MiB, iters=16)
    print(json.dumps({"spmd_ring_sweep": ring.as_dict(),
                      "bound_gbps_per_row": NVLINK_RATE / 1e9}))
    # GUPS across the cards: index rows exchanged card to card each step.
    from oncilla_tpu_torch.benchmarks.gups import gups_mesh

    g = gups_mesh([torch.device("cuda", i) for i in range(count)],
                  words_per_dev=1 << 22, batch=1 << 20, steps=32)
    log(f"[gups_mesh] {json.dumps(g)}")
    if g["table_sum"] != g["updates"]:
        raise AssertionError(f"gups_mesh: table sum {g['table_sum']} != "
                             f"updates {g['updates']}")
    print(json.dumps({"gups_mesh": g}))
    for i, smi in enumerate(card["cards"]):
        print(f"card {i}: {smi}")
    log(f"[across cards] {time.perf_counter() - t_all:.3f} s")
    print(card["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    if argv == ["--across-cards"]:
        return across_cards()
    if argv:
        print("usage: python3 chip_smoke.py [--across-cards]", file=sys.stderr)
        return 2
    from oncilla_tpu_torch.benchmarks.mfu import train_sized_config
    from oncilla_tpu_torch.models import llama, moe
    from oncilla_tpu_torch.models.kv_paging import page_bytes
    from oncilla_tpu_torch.ops import dma

    device = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = phase_device()
    build_s = phase_build()

    t = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    page = page_bytes(cfg, PAGE_TOKENS, cfg.dtype)  # the size every page move has
    if page != PAGE:
        raise AssertionError(f"a Llama-3-8B page is {page} B, not {PAGE}")
    # Offsets off the 32 KiB tile grid (5 GiB + 12 KiB, 9 GiB + 16 KiB).
    kern = phase_kernels(device, 16 * GiB, CHECK_SIZES, base=5 * GiB + 12 * KiB,
                         copy_gap=4 * GiB + 4096, rate=card["hbm_rate"],
                         timed=(page, GiB))
    log(f"[kernels] phase {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    attn_r = phase_attn(device, card["hbm_rate"])
    log(f"[attn] phase {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    dma.reset_launches()
    loop = phase_ocm_test(
        device, 16 * GiB, 4 * GiB,
        sizes=(4 * KiB, 64 * KiB, 1 * MiB, 32 * MiB, 256 * MiB, 1 * GiB),
        copy_sizes=(64 * KiB, 32 * MiB, 1 * GiB),
    )
    loop_launches = dma.launches()
    log(f"[ocm_test] launches: {loop_launches}; phase "
        f"{time.perf_counter() - t:.3f} s")
    if not all(loop_launches[k] for k in _DMA_KERNELS):
        raise AssertionError(f"a kernel was not launched by the ocm_test "
                             f"loop: {loop_launches}")

    t = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    # 256 + 128 tokens a request (3 pages) and 256 kv_decode tokens: at
    # 512 + 128 and 384 the phase took 312-355 s and the script 1040-1063 s
    # of its 1200 once phase 5m came in.
    serving = phase_serving(
        device, cfg, params, n_requests=N_REQUESTS,
        prompt_len=256, n_gen=128, page_tokens=PAGE_TOKENS, bench_tokens=256,
    )
    log(f"[serving] phase {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    engine = phase_engine(device, cfg, params, page_tokens=ENGINE_PAGE_TOKENS)
    check_engine(engine)
    engine_launches = {k: sum(r["launches"][k] for r in engine["runs"].values())
                       for k in loop_launches}
    log(f"[engine] checks a-f passed; launches {engine_launches}; phase "
        f"{time.perf_counter() - t:.3f} s")

    # Phase 8 runs here, while the weights are on the card for its run F,
    # and phase 8b for its check (c).
    wire = phase_wire(device, engine={"cfg": cfg, "params": params,
                                      "page_tokens": ENGINE_PAGE_TOKENS,
                                      "runs": engine["runs"]})
    daemons_py = phase_daemons_py(device, wire=wire, engine={
        "cfg": cfg, "params": params, "page_tokens": PAGE_TOKENS})
    client = phase_client(device, engine={
        "cfg": cfg, "params": params, "page_tokens": ENGINE_PAGE_TOKENS,
        "runs": engine["runs"], "wire": wire["engine"]})
    warmboot = phase_warmboot(device, cfg, params, page_tokens=ENGINE_PAGE_TOKENS)
    harness = phase_harness(device, cfg, params)
    observed = phase_observed(
        device, cfg, params, ref=harness.pop("observe_ref"),
        host_us_ref=next(r["host_us"] for r in kern["write_rows"] if "host_us" in r))
    del params
    torch.cuda.empty_cache()
    demo_r = phase_demo(device)

    # Phase 5m: the MoE family at Mixtral width, its weights made on the
    # card after the dense ones are gone and freed before phase 6's rows.
    t = time.perf_counter()
    mcfg = dataclasses.replace(moe.MoeConfig.mixtral_8x7b(), n_layers=MOE_LAYERS)
    mparams = moe.init_moe_params(
        mcfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t
    moe_r = phase_moe(device, mcfg, mparams, rate=card["hbm_rate"])
    moe_r["init_s"] = init_s
    del mparams
    torch.cuda.empty_cache()
    log(f"[moe] weights {init_s:.3f} s; phase with them "
        f"{time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    fab = phase_fabric(
        device, row_bytes=2 * GiB - BLOCK,
        sizes=FABRIC_SIZES, rate=card["hbm_rate"],
        handle_sizes=(4 * KiB, page, 256 * MiB), ring_bytes=64 * MiB,
        bench_kw={"arena_bytes": 256 * MiB, "nbytes": 64 * MiB, "iters": 2000},
        timed=(page, GiB),
    )
    log(f"[fabric] phase {time.perf_counter() - t:.3f} s")

    # The wire's re-run at the bench's end (dcn_tail, 42-57 s) is left out:
    # the early echo is banked and graded alike, and the script stays inside
    # its time on a slow host (1115 s with it on one).
    bench = phase_bench(device, card["hbm_rate"], CEIL_READ, CEIL_COPY, CEIL_TRIP,
                        bench_kw={"dcn_tail": False}, gb_max=1 * GiB)

    # Phase 9 last, in a process of its own: the card holds nothing of the
    # earlier phases.
    t = time.perf_counter()
    trn = phase_train_isolated(*train_sized_config(), sharded={})
    log(f"[train] phase 9 with its process {time.perf_counter() - t:.3f} s")

    main_path = {"ocm_test": loop_launches, "serving": serving["launches"],
                 "serving_engine": engine_launches, "wire": wire["launches"],
                 "libocm": wire["libocm"]["launches"],
                 "daemon_py": daemons_py["launches"], "client": client["launches"],
                 "warmboot": warmboot["launches"],
                 # 8e and the harness's own processes (its smoke in 8e, its
                 # bench cells in phase 7's serving stage).
                 "harness": {k: v + bench["launches_serving"].get(k, 0)
                             for k, v in harness["launches"].items()},
                 "observed": observed["launches"], "demo": demo_r["launches"],
                 "moe": moe_r["launches"],
                 "moe_train": trn["sharded"]["moe_train"]["launches"],
                 "fabric_handles": fab["launches_handles"],
                 "copy_bench": fab["launches_copy_bench"],
                 "bench": bench["launches"], "train": trn["launches"]}
    rows_by_kernel = {**kern, **fab["rows"], **bench["rows"], "attn_decode": attn_r}
    line = []
    for name, rows in rows_by_kernel.items():
        # K1-K4 are reported at one cold KV page across rows, with their
        # device and host times; K6-K10 at the timed launch of copy_bench or
        # of the ceiling probe; A1 at phase 3a's shorter context.
        timed = [r for r in rows if "bound_ms" in r]
        at = next((r for r in timed if r["nbytes"] == page
                   and r.get("case", "cross_row") == "cross_row"), timed[0])
        line.append({
            "name": name, "route": "cuda", "source": _SOURCE[name],
            "replaces": _REPLACES[name],
            "launches": sum(c[name] for c in main_path.values()),
            **{f"launches_{p}": c[name] for p, c in main_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows if "max_abs_err" in r),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": "bytes",
            "library_ms": at["library_ms"], "nbytes": at["nbytes"],
            **{k: at[k] for k in ("device_ms", "device_by", "host_us",
                                  "library_device_ms") if k in at},
            "sizes": [{k: r.get(k) for k in (
                "case", "nbytes", "iters", "extents", "ms", "device_ms", "device_by",
                "host_us", "issue_us", "plain_ms", "library_ms", "library_device_ms",
                "bound_ms")
                if k in r} for r in timed],
        })
    missing = [e["name"] for e in line if e["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: {missing}")
    detail = fab["bench"]["detail"]
    summary = {
        "card": card["smi"], "build_s": build_s, "attn_decode": attn_r,
        "alloc_p50_us": loop["alloc_p50_us"], "tok_s": serving["tok_s"],
        "profile": serving["profile"],
        "requests": serving["requests"],
        "engine": {name: {k: r[k] for k in (
            "seconds", "profiler_s", "tok_s", "emitted", "prefill_tokens", "steps",
            "batch_size_max", "prefill_chunks", "moves", "prefix", "stalls",
            "prefetch_stall_events", "prefetch", "preempts", "graphs", "hot_io",
            "profiles", "step_ms", "t0_vs_t1")}
            for name, r in engine["runs"].items()},
        "engine_batched_vs_interleaved": engine["batched_vs_interleaved"],
        "wire": {k: wire[k] for k in ("build_s", "alloc_p50_us", "free_p50_us",
                                      "rates", "placed", "errors", "engine",
                                      "libocm", "seconds")},
        "daemons_py": {k: daemons_py[k] for k in (
            "remote_host", "placed", "kv", "resilient", "qos", "no_card",
            "seconds")},
        "client": {k: client[k] for k in (
            "mux", "fabric", "serving", "hedge", "deadline", "replicas",
            "replica_chains", "starts", "seconds")},
        "warmboot": {"arms": {name: {k: a[k] for k in (
            "seconds", "boot_s", "close_s", "tok_s", "ttft_mean_s",
            "prefix_hit_ratio", "prefill_chunks", "restored", "restored_tiers",
            "occupancy_end", "graphs_captured", "io", "disk")}
            for name, a in warmboot["arms"].items()},
            "warm_vs_cold": warmboot["warm_vs_cold"],
            "persist_smoke": warmboot["persist_smoke"],
            "seconds": warmboot["seconds"]},
        "harness": {k: harness[k] for k in (
            "page_bytes", "pages", "cells", "remote_bytes_shared_noshare",
            "shared_vs_noshare", "drained_ranks", "smoke", "gups", "seconds")},
        "observed": {k: observed.get(k) for k in (
            "cells", "launches", "slo", "export", "critpath", "profiler", "cli",
            "tok_s", "tok_s_unobserved", "host_us_k1", "host_us_k1_phase3",
            "clis", "drained_ranks", "seconds", "seconds_by")},
        "demo": demo_r,
        "moe": {k: moe_r[k] for k in (
            "layers", "page_bytes", "pages", "token_bytes", "bound_ms", "modes",
            "launches", "init_s", "seconds")},
        "engine_shipped_vs_c": engine["shipped_vs_c"],
        "copy_bench": {k: detail[k] for k in (
            "copy_loop_gbps_s2", "copy_loop_gbps_s4", "remote_loop_gbps",
            "plain_loop_gbps", "alloc_p50_us", "free_p50_us")},
        "ceiling": bench["ceiling"],
        "bench": {"value": bench["bench"]["value"], "vs_hbm": bench["bench"]["vs_hbm"],
                  "grade": [r[:2] for r in bench["grade"]],
                  **{k: bench["bench"]["detail"].get(k) for k in (
                      "mfu", "mfu_forward_tflops", "mfu_train", "mfu_train_tflops",
                      "mfu_train_variants", "dcn", "gups", "gups_method",
                      "gups_updates", "gups_table_sum", "serving")},
                  "stage_s": bench["bench"]["detail"]["stage_s"]},
        "train": {k: trn.get(k) for k in (
            "batch", "seq", "losses", "step_ms", "step_ms_median", "tokens_per_s",
            "mfu", "peak_tflops", "checkpoint", "offload", "profile", "seconds")},
        "train_sharded": {
            "moe_train": {k: trn["sharded"]["moe_train"].get(k) for k in (
                "layers", "batch", "seq", "losses", "step_ms", "step_ms_median",
                "tokens_per_s", "mfu", "train_flops", "flops_active_top_k",
                "capacity", "trades", "checkpoint", "profile", "peak_memory_gb",
                "seconds")},
            "mesh_of_one": trn["sharded"]["mesh_of_one"],
            "seconds": trn["sharded"]["seconds"]},
        "seconds": time.perf_counter() - t_all,
    }
    log("[summary] " + json.dumps(summary))
    print(json.dumps({"kernels": line}))
    print(card["smi"])
    # Every phase ran on cuda:0 alone: one card was driven.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
