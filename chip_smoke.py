#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device-sink path on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--parent DIR]

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``dragonfly2_tpu_torch/csrc`` with nvcc
   (one nvcc a source, started together, K3's read floor too) and prints
   each kernel's registers, shared memory and spills;
3. holds each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes, at the feed's shape (K2: 64 token
   records into 64 slots) and at odd shapes (K2 also: one piece, a piece
   count that is not a multiple of its cluster, pieces smaller than one
   stage, source and slot at different 16-byte phases, the sink's
   per-slot outputs, a slot out of range), and times each kernel by its
   device time (``device_time``: events around many back-to-back calls
   with the host running ahead, over their count; at the feed's shape
   over 16 input sets in turn, more than the L2 holds) beside the host's
   microseconds per call, the plain version, a ``copy_`` of the same
   bytes and, for K2, its register path alone and its other launch
   plans; holds K3 (the gear scan of content-defined chunking) against
   its plain version at 64 MiB (ctx 0 and 31), at the manifest's 8 MiB
   spans, with dense candidates, at 1-33 bytes and 4 MiB + 3, at starts
   off a 16-byte boundary, at the edges of its tiles and runs (both of
   its run lengths, starts 0, 1, 8 and 15 bytes past a 16-byte boundary,
   dense candidates across tile edges), at regions ending on the last
   byte of their allocation, through its second launch, and over 2^31 +
   4099 bytes, and times it beside its bound, its plain version, a
   ``copy_`` of the same bytes and a coalesced read of them (the read
   floor, ``csrc/read_floor.cu``); with
   ``--parent DIR`` also times the kernels of the checkout in DIR against
   this tree's, in turns;
4. lands one checkpoint shard the size of Llama-3.1-8B's
   ``model-00001-of-00004.safetensors`` (~4.98 GB: the embedding and
   layers 0-8 at the published widths, random bf16 from ``--seed``)
   through ``DeviceSinkManager.on_piece`` in shuffled piece order, then
   ``finalize`` -> ``take`` -> ``verify_u8_against_host`` ->
   ``load_from_sink``; checks every landed byte and tensor, and that the
   path launched both kernels; splits the landing's host time and the
   verify gate's time into their parts; then checks that a corrupt piece
   fails verification by name; then serves the same shard over HTTP from
   a process of its own (a stand-in origin over the shard's file in a
   temporary directory, HEAD and ranged GET, its requests counted) and
   fetches it through the port's daemon piece path (``StandInDaemon``:
   ``TaskManager`` -> ``PieceManager`` -> the ``http`` origin client ->
   ``LocalTaskStore``, CRC-32C fused into the write by the host library ->
   ``DeviceSinkManager``, K2 per batch -> ``finalize``): a cold
   ``download_to_device`` (every piece from the origin), a warm one (the
   completed task reused and backfilled from the store, no origin
   request) and ``download_sharded`` of the first quarter of the tensors
   (ranged tasks imported from the local parent, no origin request);
   checks every byte and tensor, the store's digest against the shard's
   sha256, and splits each landing's host time into origin wait, store
   write, host checksums and staging; then pulls the shard from a parent
   daemon in a process of its own (``P2PParent``: a stand-in origin, the
   port's daemon fetching the shard back-to-source twice, its
   ``UploadManager`` and ``DaemonRpcServer``, and ``StandInScheduler``)
   through the port's P2P path (``StandInDaemon`` with a
   ``SchedulerClient``: ``PeerTaskConductor`` registers, syncs the
   parent's pieces, fetches them in runs of ranged GETs into the store,
   CRC-32C checked against the parent's digests, K2 per batch, reports
   every piece): ``download_to_device`` with no digest and with the
   shard's sha256 (its completion re-hash skipped, certified by the
   parent's digests); checks every byte and tensor, no origin request,
   the bytes the parent served, the reports the scheduler saw (packed
   batches decoded, every piece with its digest, the pieces' timings
   rolled up by host in a ``PodAggregator``, the terminal message's
   flight digest) and the digest store against the shard's sha256, the
   parent's upload server accounting the bytes it served by tenant in
   unlimited ``TenantBuckets``; then, the child's stores removed, a fresh
   child whose piece workers pass a ``WFQGate`` of 2 x the parent
   concurrency pulls the shard as the tenant ``trainer``
   (``Daemon.Download``, ``device: "tpu"``; ``p2p_qos``): every byte, the
   gate's grants by class, its ``land_s`` beside the first pull's, and
   each pull's bytes by tenant equal to the shard; then
   pulls the shard over PEX with no scheduler anywhere (``pex``: a holder
   daemon in a process of its own gossips its task over UDP with a shared
   secret; the child's ``TaskManager`` finds it with a ``PeerExchange``
   and ``Daemon.Download`` with ``device: "tpu"`` and
   ``disable_back_source`` pulls every piece from it), checking every
   byte and tensor and no origin request; for the cold daemon request,
   the p2p request with no digest and the pex pull it prints the flight
   (``Daemon.FlightReport`` over the port's drpc: the phase fold, each
   piece's device landing and its wait from the store write, events
   dropped) and checks that every piece landed and reached the device;
   then lets the port's own scheduler pick the card's parents
   (``swarm``: the port's ``SchedulerServer``, the origin and a seed
   daemon each in a process of its own, children in this one): child 1
   pulls the shard with its sha256 onto the card, the scheduler triggers
   the seed (``Peer.TriggerDownloadTask``) and hands it out; child 2
   registers once child 1 has landed a quarter of its pieces and is
   handed the running child 1 beside the seed; then two fresh children
   on one ``tpu_slice`` pull the shard's first quarter as a second object
   with ``pod_broadcast``, each handed a stripe plan of two; checks the
   origin served each object once, every buffer gated by K1 and held to
   every byte, ``StatTask`` (succeeded, 3 peers) and ``ListHosts`` (the
   seed a super seed), and prints each child's registration latency
   (register to its first ``normal_task``, from its own flight), its
   ``land_s``, the bytes the seed and the children uploaded, child 2's
   certification wait and completion re-hashes, the stripe plans and the
   seed's bytes for the striped object; then a preheat job through the
   port's manager (``manager_preheat``: the port's ``ManagerServer`` and
   its ``SchedulerServer`` with ``manager_addr`` each in a process of its
   own, the origin in a third; a seed ``Daemon`` with the device sink in
   this one): root signs in over REST and posts a ``preheat`` of the
   shard (``all_seed_peers``, ``device: "tpu"``), the manager's job queue
   hands it to the scheduler's job worker, which triggers the seed; the
   job is polled to ``SUCCESS`` and the seed's verified buffer taken,
   gated by K1 and held to every byte; checks the launches, no
   device-copy failure, one origin read of the shard and the job's
   result, and prints POST to ``SUCCESS`` and POST to the verified buffer
   beside the ``daemon`` phase's cold landing; then the cold-host
   sequence through the port's own CLI (``cli``: ``manager``,
   ``scheduler`` with no ``--config``, the fleet on, and a ``daemon
   --seed-peer --manager`` each ``python -m
   dragonfly2_tpu_torch.cli.main`` in a process of its own, the seed
   found through the manager and registered there with
   ``UpdateSeedPeer``; a child built from the CLI's argv mapping in this
   one, on which ``dfget --device tpu --no-daemon`` lands the shard from
   the triggered seed: device-verified, from P2P, every byte, K2 once a
   batch and K1 twice; a cold host's ``dfget -O --device tpu
   --manager`` spawning the port's daemon, which lands in its own
   process: device-verified, the output's sha256, its ``/metrics``
   landed bytes, a clean stop on SIGTERM; ``dfstore cp`` to the child's
   gateway replicated to the seed the manager lists; ``dfcache`` import,
   stat, export and delete; the scheduler's ``/debug/fleet/decisions``
   and ``/debug/fleet/hosts``), and prints each ``dfget``'s wall time,
   ``land_s``, the cold spawn's time to a live daemon and the child's
   registration; then the observability plane on a landing, over the
   same origin (``observe``: two CLI schedulers whose
   ``scheduling.algorithm`` names an evaluator plugin this script writes
   into a ``DRAGONFLY_PLUGIN_DIR``, one on the defaults (the pod lens,
   the SLO engine, the runtime observatory) and one with ``podlens`` and
   ``prof`` off, a CLI seed on each, a stand-in OTLP collector, each in a
   process of its own, every role tracing to the collector; a child in
   this one lands the shard for ``dfget --device tpu --pod``: every
   byte, K2 once a batch and K1 twice, the origin read once by the seed,
   the plugin's order handed out, the scheduler's
   ``/debug/pod/<task>/timeline`` with the seed's and the child's rows,
   clock samples and device landings, ``dfget --pod``'s text that
   report's ``render_timeline``, ``/debug/slo`` over both completions,
   the child's ``/debug/prof`` naming its ``df-device-sink`` worker,
   ``/debug/prof/runtime`` and ``/debug/flight/<task>``, one trace from
   ``dfget.download`` through ``rpc.*`` on the scheduler and the seed to
   the seed's ``upload.serve``; then the same landing with everything
   off (``observe_off``), and prints both ``land_s`` and the sink
   worker's splits and sampled profile);
5. hot-swaps the landed shard to a second generation (the last two
   layers redrawn and every RMSNorm weight perturbed, from ``--seed``)
   through ``swap_generation``, the device half of ``download_delta``:
   reused 1.25 MiB chunks copy out of the live buffer, the changed ones
   stage from the host, the verify gate checks the spare buffer, and a
   ``DoubleBuffer`` flips while a reader thread takes snapshots; checks
   every byte and tensor, the byte accounting against the plan, and that
   a wrong host checksum fails the gate by piece and does not flip;
   then chunks a 512 MiB prefix of the shard with the card's
   ``GearChunker`` in two feed splits, each equal to the plain CPU
   chunker's chunks; builds the whole shard's manifest with
   ``manifest_from_store`` on the card and splits its time into the
   reads, the staging, the scan and sha256, with K3's share estimated
   as its launches times its device time at the same shape;
   and swaps generation 1 to generation 2 through ``download_delta``'s
   fallback (``local_base_manifest`` over generation 1's store, since no
   manifest of it was published, then ``swap_generation``), holding the
   bytes it reuses and stages to ``plan_delta`` of the two
   content-defined manifests exactly, with the checks of the fixed-chunk
   swap; then serves generation 1 from a stand-in object gateway
   (``StandInGateway``: the reference gateway's HEAD, GET, ranged-task GET
   and PUT over host memory, HTTP/1.1 keep-alive) and builds its manifest
   with ``fetch_or_build_manifest`` through the port's ``Dfstore``: a
   miss that streams the object through the card's chunker (K3 once a
   stream chunk), equal to ``manifest_from_store``'s manifest but for its
   name and published beside the object, then a hit with no K3 launch;
   then serves both generations from a process of its own and runs the
   daemon's other task kinds on the card: generation 1 lands through
   the port's daemon and goes live in a ``DoubleBuffer``, generation 2's
   manifest arrives as a publishing peer's import (generation 1's is
   never published), and ``download_delta`` runs the daemon's delta task
   (``TaskManager.start_delta_task``: the base manifest built from the
   landed store by K3 and published, reused chunks copied out of the
   base store and checked by sha256, the changed spans fetched as ranged
   tasks) and the swap (reused chunks copied out of the live buffer, the
   gate by K1) under a snapshot reader; checks the task's stats and the
   staged bytes against ``plan_delta``, every byte and tensor, the
   published base manifest against the whole-shard one, and that the
   origin served only the changed spans (``daemon_delta``); then a fresh
   daemon with its peer drpc server and a stand-in scheduler takes
   ``Peer.TriggerDownloadTask`` (``device: "tpu"``, as a scheduler's
   preheat sends it) from the port's drpc client: the ACK before the
   seed lands, the seed registered as one and landed by K2 as its pieces
   arrive, the verified buffer taken from the sink manager, gated by K1
   and held to every byte of generation 1 (``seed``); a second trigger
   answers ``already_complete`` with no origin request
   (``seed_again``); then the port's own ``Daemon`` built from a
   ``DaemonConfig`` (``dfdaemon``: the device sink, the stand-in
   scheduler, a 2 s GC loop and the object gateway over an ``fs`` root
   holding the shard, which the task-kind phases wrote and handed over,
   and the webdataset token shards): a PUT through the gateway,
   ``Dfstore.prefetch_object(..., device="tpu")`` landing the shard on
   the card by K2, ``download_to_device`` claiming that sink (a reuse
   hit: no landing, no origin read; the gate by K1), the whole object, a
   Range window and a ranged task read through the gateway and held to
   the host bytes, the first 64 batches of epoch 0 through the gateway
   into ``DeviceFeed`` (``dfdaemon_epoch``, one K2 a batch), and
   ``stop()``: the stand-in scheduler saw the host's announces (with a
   clock sample) and its leave, the GC loop ran and reclaimed no live
   store, the sinks closed; then the port's ``Daemon`` as a registry
   mirror and an intercepting proxy (``proxy``: ``proxy.enabled`` with
   ``hijack_https`` for the registry's host and its ephemeral port
   white-listed, ``qos.enabled``) in front of a stand-in HTTPS registry
   in a process of its own (``StandInRegistry``: ``http.server`` and
   ``ssl``, its leaf forged by a second ``CertAuthority``, trusted
   through ``DRAGONFLY_SSL_CA_FILE``) serving the shard as a blob and a
   JSON manifest: the blob through the mirror (plaintext to the client,
   TLS to the registry, back-to-source into the store), the blob again
   through a hijacked CONNECT trusting only the daemon's CA (no registry
   request: ``sendfile`` off the store through TLS), a Range inside the
   tunnel (206, the exact bytes), the manifest passed through
   (``via="direct"``), each sha256 held to the shard's; then
   ``Daemon.Download`` of the blob's registry URL with ``device: "tpu"``
   off the proxy-filled store (no registry request), the verified buffer
   gated by K1 and held to every byte;
6. spreads the main path's verified sink over a device mesh (the
   ``mesh`` path, a world of one rank over NCCL: the card holds one
   GPU): ``initialize_distributed`` with explicit arguments,
   ``make_mesh`` and a manager's ``default_mesh``; ``shard_to_mesh``
   (its shard the sink's own buffer), ``ici_broadcast`` (bytes equal,
   device time beside a ``copy_``), ``all_gather_shards``,
   ``replicate_to_mesh``, ``load_from_sink(shardings=...)`` on a
   ``("dp", "tp")`` mesh, ``global_replicated`` and
   ``global_from_local_shards`` (no copy), and a ``StripedBroadcast``
   fed in 32 MiB host chunks; prints the phase's peak device memory and
   its ``torch.distributed`` calls per function;
7. feeds 64 batches of 64 token records (8192 int32 ids each) and a
   short batch of 17 through ``DeviceFeed``, some records zero-padded,
   and checks every batch against the host records; then runs a short
   feed window under ``torch.profiler`` and prints the device operations
   it queued and K2's kernel time by name; then the webdataset phase:
   4 USTAR token shards of 10,000 samples (``<key>.tokens``, up to 8192
   int32 ids, every seventh short; ``<key>.json``) written with
   ``tarfile`` from ``--seed`` into the stand-in gateway, a
   ``PodShardedLoader`` over the port's ``Dfstore`` whose ``prepare()``
   builds every index by streaming its shard, a fresh loader's
   ``prepare()`` that hits them all, the loader alone over a cut prefix of
   epoch 1, then ``epoch(0)`` through ``DeviceFeed`` (625 batches of 64 x
   32 KiB records, one K2 launch a batch), checking the order against
   ``plan(0)`` and every batch against the host records;
8. runs ``entry()`` (``dragonfly2_tpu_torch/entry.py``) at the JAX
   entry's shape and at ``bench.py``'s 512 MiB shape, each output held
   bit for bit against K2's plain version;
9. runs the train step ``dryrun_multichip(1)`` in a child process (one
   NCCL rank) at Llama-3.1-8B's MLP widths (``w1`` 4096 x 14336 bf16
   landed, gathered and bitcast) and at the JAX dryrun's, each held
   against the same step on this device with no process group, and
   prints its wall time and peak device memory;
10. runs the device bench's measurements (``dragonfly2_tpu_torch/
    bench.py``) and prints its JSON line;
11. checks each kernel's launches on each path (main, hot_swap, mesh,
    feed, entry, train, bench, chunker, manifest, cdc_swap, wds,
    gateway_manifest, daemon, p2p, pex, daemon_delta, seed, seed_again,
    dfdaemon, dfdaemon_epoch, p2p_qos, proxy, swarm, manager_preheat,
    cli, observe, observe_off), prints one
    ``{"kernels": [...]}`` line with them and, last, one ``{"ok": true,
    "device": {...}}`` line.

Any failure raises and exits non-zero. Without CUDA it exits 2 and prints
no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import ctypes
import dataclasses
import hashlib
import http.client
import inspect
import io
import json
import mmap
import multiprocessing
import os
import re
import shutil
import signal
import socket
import ssl
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlsplit

import numpy as np
import torch
import torch.distributed as dist

from dragonfly2_tpu_torch import bench
from dragonfly2_tpu_torch import entry as pentry
from dragonfly2_tpu_torch.bench import (
    bound_ms,
    card_bandwidth,
    device_time,
    host_ms,
    smi_line,
)
from dragonfly2_tpu_torch.client.device import (
    PREFIX_GUESS,
    download_delta,
    download_sharded,
    download_to_device,
    local_base_manifest,
    swap_generation,
)
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.peer.device_sink import (
    DeviceSinkError,
    DeviceSinkManager,
    TaskDeviceSink,
)
from dragonfly2_tpu_torch.daemon.peer.piece_manager import (
    PieceManager,
    PieceManagerOption,
)
from dragonfly2_tpu_torch.daemon.peer.conductor import (
    PIECE_WORKERS,
    conductor_factory,
)
from dragonfly2_tpu_torch.daemon.proxy import PROXY_BYTES, PROXY_REQUESTS
from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    COMPLETION_REHASH,
    SEED_DEVICE_FAILURES,
    FileTaskRequest,
    TaskManager,
)
from dragonfly2_tpu_torch.daemon.rpcserver import DaemonRpcServer
from dragonfly2_tpu_torch.daemon.schedulerclient import SchedulerClient
from dragonfly2_tpu_torch.daemon.upload import (
    UPLOAD_BYTES,
    UPLOAD_REQUESTS,
    UploadManager,
)
from dragonfly2_tpu_torch.client.dfstore import STREAM_CHUNK, Dfstore
from dragonfly2_tpu_torch.dataset import tar_index
from dragonfly2_tpu_torch.dataset.device_feed import DEVICE_BATCHES, DeviceFeed
from dragonfly2_tpu_torch.dataset.loader import (
    READAHEAD_DEPTH,
    LoaderOptions,
    PodShardedLoader,
)
from dragonfly2_tpu_torch.dataset.tar_index import INDEX_FETCHES
from dragonfly2_tpu_torch.delta.chunker import GearChunker, chunk_bytes
from dragonfly2_tpu_torch.delta.manifest import (
    MANIFEST_FETCHES,
    CDCParams,
    Chunk,
    DeltaManifest,
    fetch_or_build_manifest,
    manifest_from_store,
    manifest_object_key,
)
from dragonfly2_tpu_torch.delta.resolver import (
    fetch_manifest,
    manifest_request,
    plan_delta,
)
from dragonfly2_tpu_torch.ops import _build, checksum, gear
from dragonfly2_tpu_torch.ops.convert import placements_from_spec
from dragonfly2_tpu_torch.ops.hbm_sink import DoubleBuffer, verify_u8_against_host
from dragonfly2_tpu_torch.ops.safetensors import load_from_sink
from dragonfly2_tpu_torch.parallel import ici, multihost
from dragonfly2_tpu_torch.daemon.pex import PeerExchange
from dragonfly2_tpu_torch.pkg import flight, idgen
from dragonfly2_tpu_torch.pkg.certify import CertAuthority
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.piece import (
    Range,
    compute_piece_count,
    compute_piece_size,
)
from dragonfly2_tpu_torch.pkg.ratelimit import Limiter
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.proto import reportcodec, wire
from dragonfly2_tpu_torch.proto.common import UrlMeta
from dragonfly2_tpu_torch.qos import TenantBuckets, WFQGate
from dragonfly2_tpu_torch.qos.wfq import GRANTS, TENANT_UPLOAD_BYTES
from dragonfly2_tpu_torch.rpc import Client, Server
from dragonfly2_tpu_torch.storage import StorageManager, StorageOption

# Llama-3.1-8B (meta-llama/Llama-3.1-8B config.json): hidden 4096,
# intermediate 14336, 32 heads / 8 KV heads of 128, vocab 128256.
LLAMA_8B = {"hidden": 4096, "kv": 1024, "inter": 14336, "vocab": 128256}
SHARD_LAYERS = 9          # shard 1 of 4 holds the embedding and layers 0-8
BATCH_PIECES = 8
# The delta chunk: the default CDC geometry's expected size (CDCParams,
# ~1.25 MiB), cut at fixed offsets here.
CHUNK = 1280 << 10
# Dataset feed: sequences of 8192 int32 token ids (the pre-training
# context of "The Llama 3 Herd of Models", section 3.4), 64 per batch.
SEQ_TOKENS = 8192
FEED_BATCH = 64
FEED_BATCHES = 64
FEED_TAIL = 17            # the short final batch


def zero_launches() -> None:
    """Every kernel's launch count to 0, just before a path; each path's
    counts are read just after it with ``checksum.launch_counts()``."""
    checksum.chunk_checksums.launches = 0
    checksum.land_and_checksum.launches = 0
    gear.gear_candidates.launches = 0


def random_words(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n random int32 words covering every bit pattern."""
    return torch.randint(0, 256, (n * 4,), dtype=torch.uint8, device=device,
                         generator=gen).view(torch.int32)


def max_abs_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def check_equal(what: str, pairs) -> None:
    for i, (a, b) in enumerate(pairs):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 "version")


# --------------------------------------------------------------------- #
# Kernel phases
# --------------------------------------------------------------------- #

def phase_chunk_checksums(n: int, pw: int, gen, device, bw: float) -> dict:
    """K1 against its plain version over n pieces of pw words, timed."""
    words = random_words(n * pw, gen, device)
    got = checksum.chunk_checksums(words, pw)
    want = checksum.chunk_checksums_torch(words, pw)
    check_equal("chunk_checksums", zip(got, want))
    err = max_abs_err(zip(got, want))
    ms, call_us = device_time(
        lambda j: checksum.chunk_checksums(words, pw), 10)
    plain, _ = device_time(
        lambda j: checksum.chunk_checksums_torch(words, pw), 2, windows=1)
    dst = torch.empty_like(words)
    copy, _ = device_time(lambda j: dst.copy_(words), 10)
    return {"max_abs_err": err, "ms": ms, "call_us": call_us,
            "plain_ms": plain,
            "bound_ms": bound_ms(n * pw * 4 + 8 * n, bw), "bound_by": "bytes",
            "library_ms": None, "copy_ms": copy, "shape": f"n={n} pw={pw}"}


def land_sets(k: int, n_slots: int, pw: int, sets: int, gen, device):
    """``sets`` distinct (buffer, pieces, slots) triples: k random pieces
    for shuffled slots of a random n_slots-slot buffer."""
    out = []
    for r in range(sets):
        buf = random_words(n_slots * pw, gen, device)
        pieces = random_words(k * pw, gen, device).view(k, pw)
        perm = torch.randperm(n_slots,
                              generator=torch.Generator().manual_seed(k + r))
        out.append((buf, pieces, perm[:k].to(torch.int32).to(device)))
    return out


def phase_land_and_checksum(k: int, n_slots: int, pw: int, gen, device,
                            bw: float, sets: int = 1, n: int = 40) -> dict:
    """K2 against its plain version: k pieces into shuffled slots of a
    n_slots-slot buffer whose other slots must keep their bytes. Then
    timed over ``sets`` distinct inputs taken in turn (enough that the
    card's 50 MB L2 holds none of them from one call to its next), beside
    the same launch with the register path only, a ``copy_`` of the same
    bytes, the plain version, and the pinned host-to-device copy of one
    batch, the landing's other device work."""
    data = land_sets(k, n_slots, pw, sets, gen, device)
    buf_a, pieces, slots = data[0]
    buf_b = buf_a.clone()
    _, s_a, x_a = checksum.land_and_checksum(buf_a, pieces, slots)
    _, s_b, x_b = checksum.land_and_checksum_torch(buf_b, pieces, slots)
    check_equal("land_and_checksum", [(buf_a, buf_b), (s_a, s_b), (x_a, x_b)])
    err = max_abs_err([(s_a, s_b), (x_a, x_b)])
    del buf_b
    plan = checksum._land_plan(k, pw, checksum._phase(pieces),
                               checksum._phase(buf_a))
    registers = plan._replace(stage_words=0, stages=0, threads=1024)

    def land(j, p=None):
        checksum.land_and_checksum(*data[j % sets], plan=p)

    ms, call_us = device_time(land, n)
    reg_ms, _ = device_time(lambda j: land(j, registers), n)
    dsts = [torch.empty_like(p) for _, p, _ in data]
    copy, _ = device_time(lambda j: dsts[j % sets].copy_(data[j % sets][1]), n)
    plain, _ = device_time(
        lambda j: checksum.land_and_checksum_torch(*data[j % sets]),
        max(2, n // 20), windows=1)
    pinned = torch.empty((k, pw), dtype=torch.int32, pin_memory=True)
    h2d, _ = device_time(lambda j: dsts[0].copy_(pinned, non_blocking=True),
                         10)
    return {"max_abs_err": err, "ms": ms, "call_us": call_us,
            "plain_ms": plain,
            "bound_ms": bound_ms(2 * k * pw * 4 + 12 * k, bw),
            "bound_by": "bytes", "library_ms": None, "copy_ms": copy,
            "register_path_ms": reg_ms, "plan": plan._asdict(),
            "l2_rotation_sets": sets, "h2d_batch_ms": h2d,
            "shape": f"k={k} slots={n_slots} pw={pw}"}


def land_case(gen, device, k: int, n_slots: int, pw: int, src_off: int = 0,
              dst_off: int = 0, per_slot: bool = False,
              out_of_range: bool = False) -> None:
    """K2 against its plain version at one shape: pieces and buffer
    starting ``src_off`` and ``dst_off`` words past a random word buffer's
    start; with ``per_slot``, the sink's per-slot output arrays; with
    ``out_of_range``, piece 0 aimed past the last slot, which must leave
    the buffer untouched and (without per-slot arrays) give 0, 0."""
    buf = random_words(n_slots * pw + dst_off, gen, device)[dst_off:]
    pieces = random_words(k * pw + src_off, gen, device)[src_off:].view(k, pw)
    perm = torch.randperm(n_slots, generator=torch.Generator().manual_seed(pw))
    slots = perm[:k].to(torch.int32).to(device)
    if out_of_range:
        slots[0] = n_slots
    ref = buf.clone()
    keep = slice(1 if out_of_range else 0, k)
    what = (f"land_and_checksum k={k} slots={n_slots} pw={pw} offsets "
            f"{src_off}/{dst_off} per_slot={per_slot} "
            f"out_of_range={out_of_range}")
    if per_slot:
        outs = [random_words(n_slots, gen, device) for _ in range(2)]
        want = [t.clone() for t in outs]
        checksum.land_and_checksum(buf, pieces, slots, *outs)
        checksum.land_and_checksum_torch(ref, pieces[keep],
                                         slots[keep].clone(), *want)
        check_equal(what, [(buf, ref), *zip(outs, want)])
        return
    _, s_a, x_a = checksum.land_and_checksum(buf, pieces, slots)
    _, s_b, x_b = checksum.land_and_checksum_torch(ref, pieces[keep],
                                                   slots[keep].clone())
    zero = torch.zeros(k - s_b.numel(), dtype=torch.int32, device=device)
    check_equal(what, [(buf, ref), (s_a, torch.cat([zero, s_b])),
                       (x_a, torch.cat([zero, x_b]))])


def phase_odd_shapes(gen, device) -> None:
    """Both kernels at shapes the TPU kernels refused: odd piece sizes,
    piece counts that are not multiples of 8, a word buffer that does not
    start on a 16-byte boundary, and all-ones words that wrap the sum; K2
    also at one piece (a sink's last flush), a piece count that is not a
    multiple of its cluster, pieces smaller than one stage of its ring,
    pieces whose source and slot differ in 16-byte phase, the sink's
    per-slot outputs, and a slot out of range."""
    for n, pw in ((13, 1001), (9, 7), (3, 1)):
        words = random_words(n * pw + 1, gen, device)
        for w in (words[:-1], words[1:]):   # aligned and 4-byte offset start
            check_equal(f"chunk_checksums n={n} pw={pw}",
                        zip(checksum.chunk_checksums(w, pw),
                            checksum.chunk_checksums_torch(w, pw)))
    ones = torch.full((9 * 7,), -1, dtype=torch.int32, device=device)
    s, x = checksum.chunk_checksums(ones, 7)
    if not (checksum.to_u32(s).cpu().numpy() == (7 * 0xFFFFFFFF) % (1 << 32)).all():
        raise AssertionError("all-ones sum does not wrap mod 2^32")
    if not (checksum.to_u32(x).cpu().numpy() == 0xFFFFFFFF).all():
        raise AssertionError("all-ones xor wrong")
    for k, n_slots, pw, src_off, dst_off in (
            (13, 29, 1001, 0, 0), (3, 5, 7, 0, 0),
            (1, 4, 1 << 20, 0, 0),       # one piece of 4 MiB
            (13, 40, 70_000, 0, 0),      # 13 pieces, clusters of 8
            (4, 8, 2048, 0, 0),          # pieces smaller than one stage
            (8, 16, 65536, 1, 0),        # 16-byte phases differ
            (8, 16, 65536, 2, 2),        # both off a 16-byte boundary
            (9, 20, 3001, 1, 3)):
        for per_slot in (False, True):
            land_case(gen, device, k, n_slots, pw, src_off, dst_off, per_slot)
    if _on_card(device):   # the plain version refuses a slot out of range
        for per_slot in (False, True):
            land_case(gen, device, 6, 12, 65536, per_slot=per_slot,
                      out_of_range=True)


# --------------------------------------------------------------------- #
# Main path: one checkpoint shard through the device sink
# --------------------------------------------------------------------- #

def shard_layout(widths: dict, layers: int) -> list[tuple[str, tuple]]:
    h, kv, inter = widths["hidden"], widths["kv"], widths["inter"]
    out = [("model.embed_tokens.weight", (widths["vocab"], h))]
    for i in range(layers):
        p = f"model.layers.{i}."
        out += [(p + "self_attn.q_proj.weight", (h, h)),
                (p + "self_attn.k_proj.weight", (kv, h)),
                (p + "self_attn.v_proj.weight", (kv, h)),
                (p + "self_attn.o_proj.weight", (h, h)),
                (p + "mlp.gate_proj.weight", (inter, h)),
                (p + "mlp.up_proj.weight", (inter, h)),
                (p + "mlp.down_proj.weight", (h, inter)),
                (p + "input_layernorm.weight", (h,)),
                (p + "post_attention_layernorm.weight", (h,))]
    return out


def make_shard(layout, gen, device) -> tuple[np.ndarray, dict]:
    """A safetensors file of random bf16 tensors, as host bytes. The
    values are drawn on the card; the header is padded to 8 bytes, as the
    safetensors library writes it. Returns (content, {name: (begin, end)})
    with absolute byte spans."""
    header, off = {}, 0
    for name, shape in layout:
        nbytes = int(np.prod(shape)) * 2
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    start = 8 + len(hjson)
    content = np.empty(start + off, dtype=np.uint8)
    content[:8] = np.frombuffer(len(hjson).to_bytes(8, "little"), np.uint8)
    content[8:start] = np.frombuffer(hjson, np.uint8)
    spans = {}
    for name, shape in layout:
        b, e = header[name]["data_offsets"]
        t = torch.randn(shape, dtype=torch.bfloat16, device=device,
                        generator=gen)
        content[start + b:start + e] = t.view(-1).view(torch.uint8).cpu().numpy()
        spans[name] = (start + b, start + e)
    return content, spans


class _PieceRec:
    __slots__ = ("num", "digest")

    def __init__(self, num: int):
        self.num = num
        self.digest = ""


class _StoreMeta:
    def __init__(self, content_length: int, piece_size: int, pieces: dict,
                 task_id: str):
        self.content_length = content_length
        self.piece_size = piece_size
        self.total_piece_count = len(pieces)
        self.pieces = pieces
        self.task_id = task_id
        self.url = f"chip-smoke://{task_id}"


class ShardStore:
    """The surface of the daemon's completed task store that the device
    sink manager, the hot-swap and ``manifest_from_store`` use, over bytes
    held in host memory."""

    def __init__(self, content: np.ndarray, piece_size: int,
                 task_id: str = "chip-smoke"):
        self._content = content
        n = compute_piece_count(content.size, piece_size)
        self.metadata = _StoreMeta(content.size, piece_size,
                                   {i: _PieceRec(i) for i in range(n)},
                                   task_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def read_piece(self, num: int):
        ps = self.metadata.piece_size
        return memoryview(self._content[num * ps:(num + 1) * ps])

    def read_into(self, offset: int, length: int, buf) -> None:
        memoryview(buf)[:length] = memoryview(
            self._content[offset:offset + length])

    def get_pieces(self):
        return list(self.metadata.pieces.values())


class CorruptPiece(ShardStore):
    """A store whose piece ``bad`` reads with one bit flipped, so its host
    checksum disagrees with the landed bytes."""

    def __init__(self, store: ShardStore, bad: int):
        self._content = store._content
        self.metadata = store.metadata
        self.bad = bad

    def read_piece(self, num: int):
        data = super().read_piece(num)
        if num != self.bad:
            return data
        out = bytearray(data)
        out[0] ^= 1
        return out


def gate_breakdown(u8: torch.Tensor, piece_size: int, host_checksums) -> dict:
    """Where the verify gate's time goes once warm: the whole gate on the
    host clock; its device parts by CUDA events (K1 over the whole pieces,
    then zero-padding the short last piece and K1 over it); and the
    read-back of the checksums to the host, on the host clock."""
    pw = piece_size // 4
    full = u8.numel() // piece_size
    head = u8[:full * piece_size].view(torch.int32)
    rest = u8[full * piece_size:]

    def last_piece():
        t = torch.zeros(piece_size, dtype=torch.uint8, device=u8.device)
        t[:rest.numel()] = rest
        return checksum.chunk_checksums(t.view(torch.int32), pw)

    parts = [checksum.chunk_checksums(head, pw), last_piece()]

    def readback():
        torch.cat([s for s, _ in parts]).cpu()
        torch.cat([x for _, x in parts]).cpu()

    return {"warm_ms": host_ms(lambda: verify_u8_against_host(
                u8, piece_size, host_checksums), 5),
            "k1_pieces_ms": device_time(
                lambda j: checksum.chunk_checksums(head, pw), 5)[0],
            "last_piece_ms": device_time(lambda j: last_piece(), 5)[0],
            "readback_ms": host_ms(readback, 5)}


def drive_main_path(content: np.ndarray, spans: dict, layout, piece_size: int,
                    seed: int, device: torch.device):
    """Land ``content`` through the port's entry points and check it.
    Returns the report and the verified sink the caller took."""
    store = ShardStore(content, piece_size)
    n_pieces = len(store.metadata.pieces)
    order = list(range(n_pieces))
    np.random.default_rng(seed).shuffle(order)
    mgr = DeviceSinkManager(batch_pieces=BATCH_PIECES, device=device)
    task_id = f"chip-smoke-{seed}"
    times = {}

    async def land_and_finalize():
        t0 = time.perf_counter()
        for num in order:
            await mgr.on_piece(task_id, store, store.metadata.pieces[num])
        t1 = time.perf_counter()
        sink = await mgr.finalize(task_id, store)
        t2 = time.perf_counter()
        times["land_s"], times["finalize_s"] = t1 - t0, t2 - t1
        return sink

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        sink = asyncio.run(land_and_finalize())
        if sink is None:
            raise AssertionError("finalize returned None: the landing "
                                 "degraded to disk-only")
        taken = mgr.take(task_id)
        if taken is not sink or not taken.verified:
            raise AssertionError("take() did not return the verified sink")
        t0 = time.perf_counter()
        u8 = taken.as_bytes_array()
        verify_u8_against_host(u8, taken.sink.piece_size,
                               taken.sink.host_checksums)
        t1 = time.perf_counter()
        tensors = load_from_sink(taken)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        mgr.close()
    launches = checksum.launch_counts()
    times["verify_gate_s"], times["load_s"] = t1 - t0, t2 - t1
    # The landing's host time by share, accumulated inside land_piece and
    # flush while the pieces landed.
    for key in ("host_checksum_s", "stage_s", "stage_wait_s"):
        times[key] = getattr(taken.sink, key)
    peak = torch.cuda.max_memory_allocated()

    # What came out: every byte, and every tensor by name, shape and value.
    host = torch.from_numpy(content).to(device)
    if not torch.equal(u8, host):
        raise AssertionError("landed bytes differ from the shard")
    if set(tensors) != {name for name, _ in layout}:
        raise AssertionError("tensor names differ from the header")
    for name, shape in layout:
        t = tensors[name]
        b, e = spans[name]
        if t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
            raise AssertionError(f"{name}: {t.dtype} {tuple(t.shape)}")
        if not torch.equal(t.reshape(-1).view(torch.uint8), host[b:e]):
            raise AssertionError(f"{name}: bytes differ from the shard")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite values")
    want_k2 = -(-n_pieces // BATCH_PIECES)
    if launches["land_and_checksum"] != want_k2:
        raise AssertionError(f"land_and_checksum launched "
                             f"{launches['land_and_checksum']} times, "
                             f"want {want_k2}")
    if launches["chunk_checksums"] < 1:
        raise AssertionError("chunk_checksums never launched on the path")
    gate = gate_breakdown(u8, taken.sink.piece_size, taken.sink.host_checksums)
    return {"pieces": n_pieces, "piece_size": piece_size, "times": times,
            "verify_gate_warm": gate, "launches": launches,
            "peak_device_bytes": peak, "tensors": len(tensors)}, taken


def phase_corruption(device: torch.device) -> str:
    """A piece whose host checksum disagrees must fail verify, by name."""
    piece = 1 << 20
    data = np.random.default_rng(7).integers(0, 256, 4 * piece, np.uint8)
    sink = TaskDeviceSink("chip-smoke-corrupt", data.size, piece,
                          device=device, batch_pieces=BATCH_PIECES)
    for n in range(4):
        sink.land(n, memoryview(data[n * piece:(n + 1) * piece]))
    s, x = sink.sink.host_checksums[2]
    sink.sink.host_checksums[2] = (s ^ 1, x)
    try:
        sink.verify()
    except DeviceSinkError as e:
        if "piece 2" not in str(e):
            raise AssertionError(f"corruption reported without its piece: {e}")
        return str(e)
    raise AssertionError("a corrupt piece passed verification")


# --------------------------------------------------------------------- #
# Hot swap: the landed shard to its next generation, through the device
# half of download_delta
# --------------------------------------------------------------------- #

def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def make_generation2(content: np.ndarray, spans: dict, layout, gen,
                     device) -> tuple[np.ndarray, list, dict]:
    """The same layout after a fine-tune of the last two blocks plus
    every RMSNorm: the last two layers redrawn (one contiguous run) and
    both norm weights of every other layer redrawn (small, scattered).
    Returns (content, changed byte spans, counts)."""
    out = content.copy()
    layers = sorted({int(n.split(".")[2]) for n, _ in layout
                     if n.startswith("model.layers.")})
    last_two = {f"model.layers.{i}." for i in layers[-2:]}
    redrawn = [(n, s) for n, s in layout
               if any(n.startswith(p) for p in last_two)]
    norms = [(n, s) for n, s in layout if n.endswith("layernorm.weight")
             and not any(n.startswith(p) for p in last_two)]
    for name, shape in redrawn + norms:
        b, e = spans[name]
        t = torch.randn(shape, dtype=torch.bfloat16, device=device,
                        generator=gen)
        out[b:e] = t.view(-1).view(torch.uint8).cpu().numpy()
        if np.array_equal(out[b:e], content[b:e]):
            raise AssertionError(f"{name}: redraw left the bytes unchanged")
    run = (spans[redrawn[0][0]][0], spans[redrawn[-1][0]][1])
    if run[1] - run[0] != sum(spans[n][1] - spans[n][0] for n, _ in redrawn):
        raise AssertionError("the redrawn layers are not one contiguous run")
    changed = [run] + [spans[n] for n, _ in norms]
    return out, changed, {
        "redrawn_tensors": len(redrawn), "redrawn_bytes": run[1] - run[0],
        "perturbed_tensors": len(norms),
        "perturbed_bytes": sum(spans[n][1] - spans[n][0] for n, _ in norms)}


def fixed_manifest(content: np.ndarray, name: str,
                   chunk: int = CHUNK) -> DeltaManifest:
    """A manifest of fixed-size chunks, hashed with sha256 over the host
    bytes in parallel threads (hashlib releases the interpreter lock)."""
    mv = memoryview(content)
    offsets = range(0, content.size, chunk)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4,
                            thread_name_prefix="df-chip-sha") as ex:
        digests = list(ex.map(
            lambda o: hashlib.sha256(mv[o:o + chunk]).hexdigest(), offsets))
    m = DeltaManifest(name=name, content_length=content.size, params=CDCParams(),
                      chunks=[Chunk(o, min(chunk, content.size - o), d)
                              for o, d in zip(offsets, digests)])
    m.validate()
    return m


def planned_bytes(total: int, changed, chunk: int = CHUNK) -> tuple[int, int]:
    """(reused, staged) bytes the delta must come to: every chunk that
    holds a changed byte is staged, every other chunk reused."""
    hit = set()
    for b, e in changed:
        hit.update(range(b // chunk, (e - 1) // chunk + 1))
    staged = sum(min(chunk, total - i * chunk) for i in hit)
    return total - staged, staged


def swap_under_reader(hot: DoubleBuffer, swap, device: torch.device):
    """``swap()`` while a reader thread takes snapshots of ``hot`` across
    the flip; the launch counts set to 0 just before it and read just
    after. Returns (result, launches, swap_s, peak device bytes,
    snapshots by generation, mixed snapshots)."""
    mixed: list = []
    seen: dict = {}
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            g, buf, tensors = hot.snapshot()
            ptr = buf.untyped_storage().data_ptr()
            if any(t.untyped_storage().data_ptr() != ptr
                   for t in tensors.values()):
                mixed.append(g)
            seen[g] = seen.get(g, 0) + 1
            time.sleep(50e-6)

    if _on_card(device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    thread = threading.Thread(target=reader, name="df-chip-reader")
    thread.start()
    try:
        t0 = time.perf_counter()
        result = swap()
        if _on_card(device):
            torch.cuda.synchronize()
        swap_s = time.perf_counter() - t0
        launches = checksum.launch_counts()
        peak = torch.cuda.max_memory_allocated() if _on_card(device) else 0
        time.sleep(0.05)               # snapshots of the new generation
    finally:
        stop.set()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("snapshot reader did not stop")
    return result, launches, swap_s, peak, seen, mixed


def check_generation2(result, hot: DoubleBuffer, gen2: np.ndarray, layout,
                      spans: dict, seen: dict, mixed: list) -> torch.Tensor:
    """What a swap to generation 2 must give: the flip, no mixed
    snapshot, every byte and every tensor. Returns the flipped buffer."""
    buf = hot.buffer()
    if not (result.flipped and result.on_device and hot.generation == 2
            and buf is result.buffer):
        raise AssertionError(f"no flip to generation 2: {result.generation}")
    if mixed:
        raise AssertionError(f"mixed-generation snapshots: {mixed[:3]}")
    if set(seen) != {1, 2}:
        raise AssertionError(f"reader saw generations {sorted(seen)}")
    if not equal_in_steps(buf, gen2):
        raise AssertionError("flipped buffer differs from generation 2")
    tensors = hot.tensors()
    if set(tensors) != {name for name, _ in layout}:
        raise AssertionError("tensor names differ from the header")
    for name, shape in layout:
        t = tensors[name]
        b, e = spans[name]
        if t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
            raise AssertionError(f"{name}: {t.dtype} {tuple(t.shape)}")
        if not torch.equal(t.reshape(-1).view(torch.uint8), buf[b:e]):
            raise AssertionError(f"{name}: bytes differ from generation 2")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite values")
    return buf


def check_refusal(store: ShardStore, hot: DoubleBuffer, buf, **swap_kw) -> str:
    """A generation 2 whose host checksum of one piece is wrong fails the
    gate by piece number, and the live generation stays."""
    bad = store.metadata.total_piece_count // 2
    try:
        swap_generation(CorruptPiece(store, bad), hot=hot, **swap_kw)
    except DfError as e:
        if e.code != Code.ClientPieceDownloadFail or f"piece {bad} " not in str(e):
            raise AssertionError(f"wrong gate failure: {e!r}")
        refused = str(e)
    else:
        raise AssertionError("a wrong host checksum passed the gate")
    if hot.generation != 2 or hot.buffer() is not buf:
        raise AssertionError("the refused generation flipped")
    return refused


def phase_hot_swap(content: np.ndarray, spans: dict, layout, taken,
                   piece_size: int, gen, device: torch.device,
                   chunk: int = CHUNK) -> tuple[dict, np.ndarray, list]:
    """Generation 1 (the main path's verified sink) goes live in a
    DoubleBuffer; generation 2 swaps in through swap_generation over
    fixed-size chunk manifests while a reader thread takes snapshots
    across the flip. Returns the report, generation 2's bytes and its
    changed spans."""
    live = taken.as_bytes_array()
    hot = DoubleBuffer()
    hot.flip(live, load_from_sink(taken))
    t0 = time.perf_counter()
    gen2, changed, counts = make_generation2(content, spans, layout, gen,
                                             device)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    base_m = fixed_manifest(content, "generation-1", chunk)
    new_m = fixed_manifest(gen2, "generation-2", chunk)
    manifest_s = time.perf_counter() - t0
    store = ShardStore(gen2, piece_size, "generation-2")
    want_reused, want_staged = planned_bytes(content.size, changed, chunk)

    result, launches, swap_s, peak, seen, mixed = swap_under_reader(
        hot, lambda: swap_generation(
            store, live_u8=live, new_m=new_m, base_m=base_m, hot=hot,
            device=device, task_id="chip-smoke-generation-2"), device)

    # What came out: the flip, every byte, every tensor, the accounting.
    buf = check_generation2(result, hot, gen2, layout, spans, seen, mixed)
    got = (result.reused_device_bytes, result.staged_bytes)
    if got != (want_reused, want_staged):
        raise AssertionError(f"reused/staged {got} != plan "
                             f"{(want_reused, want_staged)}")
    if _on_card(device) and launches["chunk_checksums"] < 1:
        raise AssertionError("chunk_checksums never launched on the swap")

    # Warm gate, on the flipped buffer.
    checks = {rec.num: checksum.checksum_numpy(store.read_piece(rec.num))
              for rec in store.get_pieces()}
    gate_warm_ms = host_ms(
        lambda: verify_u8_against_host(buf, piece_size, checks), 5)
    refused = check_refusal(store, hot, buf, live_u8=live, new_m=new_m,
                            base_m=base_m, device=device)
    return {"content_bytes": content.size, "chunk": chunk,
            "chunks": new_m.num_chunks, **counts,
            "reused_device_bytes": result.reused_device_bytes,
            "staged_bytes": result.staged_bytes, "copies": result.copies,
            "timings": result.timings, "swap_s": swap_s,
            "gate_warm_ms": gate_warm_ms, "made_s": made_s,
            "manifest_s": manifest_s, "peak_device_bytes": peak,
            "snapshots": seen, "launches": launches,
            "refused": refused}, gen2, changed


# --------------------------------------------------------------------- #
# Content-defined chunking on the card: K3, the chunker, whole-shard
# manifests, and the hot swap through download_delta's fallback
# --------------------------------------------------------------------- #

# The scan's mask: the default CDCParams' (expected chunk 256 KiB + 1 MiB).
GEAR_BITS = CDCParams().mask_bits
# The manifest reads of manifest_from_store, the main path's K3 shape: one
# span of new bytes a launch, after 31 bytes of left context.
SPAN = 8 << 20
GEAR_MAIN = SPAN + gear.WINDOW - 1
# Over 2^31 bytes: 64-bit offsets in K3.
GEAR_HUGE = (1 << 31) + 4099
CHUNKER_PREFIX = 512 << 20
# H100 SXM: 132 SMs x 64 int32 lanes x 1.98 GHz, half the float32 lanes
# behind the card's 67 TFLOP/s (an FMA counted as two).
INT32_OPS = 132 * 64 * 1.98e9
# K3's operations a position: a shift, an add and a compare.
GEAR_OPS = 3


def gear_bound_ms(n: int, candidates: int, bw: float) -> tuple[float, str]:
    """K3's bound over n positions: each byte and the 1 KiB table read
    once and 8 bytes a candidate written, over the memory rate; or
    ``GEAR_OPS`` operations a position over the card's int32 rate;
    whichever is longer."""
    by_bytes = bound_ms(n + 1024 + 8 * candidates, bw)
    by_ops = n * GEAR_OPS / INT32_OPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def planned_k3(sizes) -> int:
    """K3's launches for a GearChunker fed ``sizes`` bytes in turn: one
    for each started scan block of each feed."""
    return sum(-(-n // GearChunker._SCAN_BLOCK) for n in sizes)


def span_sizes(total: int, span: int = SPAN) -> list[int]:
    """The reads of ``manifest_from_store`` over ``total`` bytes (or the
    chunks of a stream of ``span`` bytes each but the last)."""
    return [min(span, total - off) for off in range(0, total, span)]


def phase_gear(gen, device, bw: float) -> dict:
    """K3 against its plain version on the same card tensors, bit for
    bit: 64 MiB of random bytes at ctx 0 and 31, the main path's shape
    (8 MiB + 31 bytes, ctx 31), dense candidates (mask_bits 4 and 1),
    regions of 1, 31, 32, 33 and 4 MiB + 3 bytes, starts 1-15 bytes past
    a 16-byte boundary, 4 MiB of a 32-byte window repeated (a candidate
    every 32 bytes: more than the first launch has room for, so a second
    launch), and one region of 2^31 + 4099 bytes. At the kernel's edges
    (its tile T and run R, ``gear.geometry()``): T - 1, T, T + 1, T + 31,
    3T + 17, R - 1, R and R + 1 bytes, each at starts 0, 1, 8 and 15 bytes
    past a 16-byte boundary; regions ending on the last byte of their own
    allocation with n % 16 != 0; dense candidates across tile edges. Then
    K3 timed by ``device_time`` at the main path's shape, at 64 MiB and at
    a gateway stream chunk (launches with no read-back between them),
    beside the plain version, the bound, a ``copy_`` of the same bytes and
    the read floor (``csrc/read_floor.cu``: a coalesced read of the same
    words, what reading alone costs)."""
    big = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8, device=device,
                        generator=gen)
    cases = []

    def case(what, region, ctx, bits, launches=1):
        before = gear.gear_candidates.launches
        got = gear.gear_candidates(region, ctx, bits)
        want = gear.gear_candidates_torch(region, ctx, bits)
        took = gear.gear_candidates.launches - before
        if not torch.equal(got, want):
            raise AssertionError(f"gear_candidates {what}: differs from the "
                                 "plain version")
        if took != launches:
            raise AssertionError(f"gear_candidates {what}: {took} launches, "
                                 f"want {launches}")
        cases.append({"case": what, "bytes": region.numel(), "ctx": ctx,
                      "mask_bits": bits, "candidates": got.numel(),
                      "launches": took})
        return got, want

    for ctx in (0, 31):
        case(f"64 MiB ctx {ctx}", big, ctx, GEAR_BITS)
    main_got, main_want = case("main path: 8 MiB + 31, ctx 31",
                               big[:GEAR_MAIN], 31, GEAR_BITS)
    case("dense, mask_bits 4", big, 0, 4)
    case("dense, mask_bits 1", big[:1 << 20], 5, 1)
    for n in (1, 31, 32, 33, (4 << 20) + 3):
        for ctx in sorted({0, min(n, 31)}):
            case(f"{n} bytes ctx {ctx}", big[:n], ctx, 2)
        case(f"{n} bytes, mask_bits {GEAR_BITS}", big[:n], 0, GEAR_BITS)
    for off in (1, 3, 8, 15):
        case(f"start {off} bytes past 16", big[off:off + (1 << 20) + 5], 31,
             10)
    # The kernel's edges, for each of its two runs (``gear.geometry``: the
    # short one for small regions, the long one at the main path's 8 MiB):
    # a tile's and a run's ends, the halo, a tile holding a few bytes, at
    # starts off a 16-byte boundary; mask_bits 6 (a candidate every 64
    # positions or so).
    short, long_ = gear.geometry(1), gear.geometry(GEAR_MAIN)
    geometries = {"short": (short, 0),
                  "long": (long_, (SPAN // long_[0] - 1) * long_[0])}
    for name, ((tile, run), base) in geometries.items():
        for x in (tile - 1, tile, tile + 1, tile + 31, 3 * tile + 17, run - 1,
                  run, run + 1):
            n = base + x
            if gear.geometry(n) != (tile, run):
                raise AssertionError(f"gear_candidates: {n} bytes do not "
                                     f"take the {name} run")
            for off in (0, 1, 8, 15):
                for ctx in (0, 31):
                    case(f"{n} bytes at +{off}, ctx {ctx} ({name} run: T="
                         f"{tile}, R={run})", big[off:off + n], ctx, 6)
        case(f"dense across tile edges, mask_bits 1 ({name} run)",
             big[7:7 + base + 3 * tile + 17], 0, 1)
        case(f"dense across tile edges, mask_bits 4 ({name} run)",
             big[7:7 + base + 3 * tile + 17], 0, 4)
    tile = short[0]
    # Regions that end on the last byte of their own allocation: a copy of
    # 12 MiB (over PyTorch's 10 MiB, a segment of its own once the cache is
    # empty; copied, so that the generator, and the shard drawn from it
    # later, stay as they were), its last T + 5 bytes and all of it but its
    # first 5.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    own = big[:12 << 20].clone()
    for what, region in ((f"last {tile + 5} bytes", own[-(tile + 5):]),
                         ("12 MiB less its first 5 bytes", own[5:])):
        if not region.numel() % 16 or (region.data_ptr() + region.numel()
                                       != own.data_ptr() + own.numel()):
            raise AssertionError(f"gear_candidates {what}: not at the "
                                 "allocation's end with n % 16 != 0")
        case(f"{what} of an allocation", region, 0, 6)
    del own
    # The window ending at a candidate, repeated: every 32nd position is a
    # candidate, 32768 a MiB against the first launch's room of
    # 4 x 2^-20 a byte plus _SPARE_SLOTS.
    p = int(main_want[0])
    periodic = big[p - 31:p + 1].repeat((4 << 20) // gear.WINDOW)
    got, _ = case("4 MiB of a repeated window", periodic, 0, GEAR_BITS,
                  launches=2)
    if got.numel() < periodic.numel() // gear.WINDOW:
        raise AssertionError(f"gear_candidates: {got.numel()} candidates in "
                             "the repeated window, want one every 32 bytes")
    del periodic
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    huge = torch.randint(0, 256, (GEAR_HUGE,), dtype=torch.uint8,
                         device=device, generator=gen)
    case(f"{GEAR_HUGE} bytes (over 2^31)", huge, 31, GEAR_BITS)
    del huge
    torch.cuda.empty_cache()
    huge_s = time.perf_counter() - t0

    def timed(region, ctx, n):
        out = torch.empty(4 * (region.numel() >> GEAR_BITS) + (1 << 16),
                          dtype=torch.int64, device=device)
        count = torch.zeros(1, dtype=torch.int64, device=device)
        ms, call_us = device_time(
            lambda j: gear.gear_scan(region, ctx, GEAR_BITS, out, count), n)
        plain, _ = device_time(
            lambda j: gear.gear_candidates_torch(region, ctx, GEAR_BITS), 2,
            windows=1)
        dst = torch.empty_like(region)
        copy_ms, _ = device_time(lambda j: dst.copy_(region), n)
        folds = torch.empty(bench.READ_FLOOR_BLOCKS, dtype=torch.int32,
                            device=device)
        read_ms, _ = device_time(lambda j: bench.read_floor(region, folds), n)
        cands = gear.gear_candidates(region, ctx, GEAR_BITS).numel()
        bound, by = gear_bound_ms(region.numel(), cands, bw)
        return {"ms": ms, "call_us": call_us, "plain_ms": plain,
                "copy_ms": copy_ms, "read_ms": read_ms,
                "bound_ms": bound, "bound_by": by, "candidates": cands,
                "shape": f"n={region.numel()} ctx={ctx} "
                         f"mask_bits={GEAR_BITS}"}

    main = timed(big[:GEAR_MAIN], 31, 40)
    at_64 = timed(big, 31, 10)
    at_stream = timed(big[:STREAM_CHUNK + gear.WINDOW - 1], 31, 40)
    del big
    return {**main, "max_abs_err": max_abs_err([(main_got, main_want)]),
            "library_ms": None, "geometries": {k: v[0] for k, v in
                                               geometries.items()},
            "at_64_mib": at_64,
            "at_stream_chunk": at_stream, "cases": cases, "huge_s": huge_s}


def chunk_triples(chunks) -> list[tuple[int, int, str]]:
    return [(c.offset, c.length, c.sha256) for c in chunks]


def feed_sizes(total: int, seed: int) -> list[int]:
    """A seeded irregular split of ``total`` bytes: a few tiny feeds, then
    random ones up to 96 MiB (more than one scan block)."""
    rng = np.random.default_rng(seed)
    sizes = [1, 30, 1, 4095]
    while sum(sizes) < total:
        sizes.append(int(rng.integers(1, 96 << 20)))
    sizes[-1] -= sum(sizes) - total
    return [n for n in sizes if n > 0]


def phase_chunker(content: np.ndarray, seed: int,
                  device: torch.device) -> dict:
    """The card's GearChunker over a ``CHUNKER_PREFIX`` prefix of the
    shard, fed in 8 MiB spans (as manifest_from_store reads) and in a
    seeded irregular split, against the plain chunker on the CPU. The
    launches are counted from 0 just before the two card runs: one K3
    launch for each started scan block of each feed."""
    prefix = memoryview(content)[:CHUNKER_PREFIX]
    params = CDCParams()
    t0 = time.perf_counter()
    want = chunk_triples(chunk_bytes(prefix, params, device="cpu"))
    plain_s = time.perf_counter() - t0
    splits = {"8 MiB spans": span_sizes(CHUNKER_PREFIX),
              "irregular": feed_sizes(CHUNKER_PREFIX, seed)}
    torch.cuda.synchronize()
    zero_launches()
    runs = {}
    for name, sizes in splits.items():
        t0 = time.perf_counter()
        ch = GearChunker(params, device=device)
        off = 0
        for n in sizes:
            ch.feed(prefix[off:off + n])
            off += n
        ch.finish()
        runs[name] = {"s": time.perf_counter() - t0, "feeds": len(sizes),
                      **ch.timings}
        if chunk_triples(ch.chunks) != want:
            raise AssertionError(f"chunker, {name}: chunks differ from the "
                                 "plain chunker's")
    launches = checksum.launch_counts()
    want_k3 = sum(planned_k3(sizes) for sizes in splits.values())
    if launches["gear_candidates"] != want_k3:
        raise AssertionError(f"chunker: K3 launched "
                             f"{launches['gear_candidates']} times, want "
                             f"{want_k3}")
    del prefix
    return {"bytes": CHUNKER_PREFIX, "chunks": len(want), "plain_s": plain_s,
            "runs": runs, "launches": launches, "planned_k3": want_k3}


def phase_manifest(content: np.ndarray, piece_size: int,
                   device: torch.device) -> tuple[dict, DeltaManifest]:
    """One manifest_from_store over the whole shard on the card, its time
    split into the reads, the staging, the scan (K3 and its read-back)
    and cut selection with sha256. K3 launches once for each started scan
    block of each span read, counted from 0 just before."""
    store = ShardStore(content, piece_size, "generation-1")
    stats: dict = {}
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    m = manifest_from_store(store, params=CDCParams(), span=SPAN,
                            device=device, stats=stats)
    manifest_s = time.perf_counter() - t0
    launches = checksum.launch_counts()
    m.validate()
    sizes = span_sizes(content.size)
    if (launches["gear_candidates"] != planned_k3(sizes)
            or stats["feeds"] != len(sizes)):
        raise AssertionError(f"manifest: K3 launched "
                             f"{launches['gear_candidates']} times over "
                             f"{stats['feeds']} reads, want "
                             f"{planned_k3(sizes)} over {len(sizes)}")
    lengths = [c.length for c in m.chunks]
    p = m.params
    if max(lengths) > p.max_size or min(lengths[:-1]) < p.min_size:
        raise AssertionError("manifest: a chunk outside the CDC bounds")
    return {"bytes": content.size, "chunks": m.num_chunks,
            "mean_chunk": content.size / m.num_chunks,
            "forced_cuts": sum(n == p.max_size for n in lengths),
            "manifest_s": manifest_s, **stats, "launches": launches}, m


def phase_cdc_swap(content: np.ndarray, gen2: np.ndarray, spans: dict,
                   layout, taken, base_ref: DeltaManifest, piece_size: int,
                   device: torch.device) -> tuple[dict, DeltaManifest]:
    """Generation 1 to generation 2 through download_delta's repaired
    fallback: the publisher's manifest of generation 2 from
    manifest_from_store, and no published manifest of generation 1, so
    ``local_base_manifest`` chunks generation 1's store on the card; then
    ``swap_generation`` while a reader takes snapshots. The path (the
    fallback and the swap) is counted from 0 just before it. Checks the
    base manifest against the whole-shard one (``base_ref``), the
    accounting against ``plan_delta`` exactly, every byte and tensor, and
    the refusal of a wrong host checksum. Returns the report and the
    publisher's manifest of generation 2."""
    live = taken.as_bytes_array()
    hot = DoubleBuffer()
    hot.flip(live, load_from_sink(taken))
    t0 = time.perf_counter()
    new_m = manifest_from_store(ShardStore(gen2, piece_size, "generation-2"),
                                params=CDCParams(), device=device)
    publisher_s = time.perf_counter() - t0
    plan = plan_delta(new_m, base_ref)
    base_store = ShardStore(content, piece_size, "generation-1")
    store = ShardStore(gen2, piece_size, "generation-2")
    stats: dict = {}
    built: dict = {}

    def swap():
        t = time.perf_counter()
        built["base_m"] = local_base_manifest(base_store, new_m,
                                              device=device, stats=stats)
        built["base_s"] = time.perf_counter() - t
        return swap_generation(store, live_u8=live, new_m=new_m,
                               base_m=built["base_m"], hot=hot, device=device,
                               task_id="chip-smoke-cdc-generation-2")

    result, launches, swap_s, peak, seen, mixed = swap_under_reader(
        hot, swap, device)
    base_m = built["base_m"]
    if chunk_triples(base_m.chunks) != chunk_triples(base_ref.chunks):
        raise AssertionError("cdc swap: the fallback's base manifest differs "
                             "from the whole-shard manifest")
    buf = check_generation2(result, hot, gen2, layout, spans, seen, mixed)
    got = (result.reused_device_bytes, result.staged_bytes)
    if got != (plan.reused_bytes, plan.fetched_bytes):
        raise AssertionError(f"cdc swap: reused/staged {got} != plan "
                             f"{(plan.reused_bytes, plan.fetched_bytes)}")
    want = {"chunk_checksums": 2, "land_and_checksum": 0,
            "gear_candidates": planned_k3(span_sizes(content.size))}
    if _on_card(device) and launches != want:
        raise AssertionError(f"cdc swap: launches {launches}, want {want}")
    refused = check_refusal(store, hot, buf, live_u8=live, new_m=new_m,
                            base_m=base_m, device=device)
    return {"content_bytes": content.size, "chunks_new": new_m.num_chunks,
            "chunks_base": base_m.num_chunks,
            "reused_chunks": len(plan.reused),
            "fetched_chunks": len(plan.fetched),
            "reused_device_bytes": result.reused_device_bytes,
            "staged_bytes": result.staged_bytes, "copies": result.copies,
            "timings": result.timings, "base_manifest_s": built["base_s"],
            "base_manifest": stats, "publisher_manifest_s": publisher_s,
            "swap_s": swap_s, "peak_device_bytes": peak, "snapshots": seen,
            "launches": launches, "refused": refused}, new_m


# --------------------------------------------------------------------- #
# The mesh path: the verified sink spread over a device mesh
# --------------------------------------------------------------------- #

STRIPE_CHUNK = 32 << 20


def equal_in_steps(dev_u8: torch.Tensor, host_u8: np.ndarray,
                   step: int = 256 << 20) -> bool:
    """``dev_u8`` equals the host bytes, compared a step at a time."""
    if dev_u8.numel() != host_u8.size:
        return False
    return all(torch.equal(dev_u8[o:o + step], torch.from_numpy(
        host_u8[o:o + step]).to(dev_u8.device))
        for o in range(0, host_u8.size, step))


def phase_mesh(content: np.ndarray, layout, taken,
               device: torch.device) -> dict:
    """The verified sink through the port's mesh layer in a world of one
    rank over NCCL: every placement checked against the landed bytes, the
    zero-copy ones by ``data_ptr``. The caller zeroes nothing: the counts
    are set to 0 here, just before the path, and read just after it."""
    multihost.initialize_distributed(
        f"localhost:{multihost.free_port()}", 1, 0, device=device,
        timeout_s=120)
    try:
        backend = dist.get_backend_config()
        if "cuda:nccl" not in backend:
            raise AssertionError(f"process group without NCCL: {backend}")
        buf = taken.sink._buffer
        u8 = taken.as_bytes_array()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        ici.reset_collective_counts()
        t0 = time.perf_counter()
        mesh = ici.make_mesh()
        mgr = DeviceSinkManager(device=device)
        try:
            host_mesh = mgr.default_mesh()
        finally:
            mgr.close()
        if (mesh.device_type, tuple(mesh.mesh.shape)) != ("cuda", (1,)) or (
                host_mesh.mesh_dim_names, tuple(host_mesh.mesh.shape)) != (
                ("d",), (1,)):
            raise AssertionError(f"meshes {mesh} and {host_mesh}")
        no_copy = {}
        sharded = taken.shard_to_mesh(mesh)
        no_copy["shard_to_mesh"] = sharded.to_local().data_ptr() == \
            buf.data_ptr()
        replicated = taken.ici_broadcast(mesh, n_chunks=4)
        if not torch.equal(replicated.to_local(), buf):
            raise AssertionError("ici_broadcast bytes differ from the sink")
        del replicated
        gathered = ici.all_gather_shards(mesh, sharded)
        if not torch.equal(gathered.to_local(), buf):
            raise AssertionError("all_gather_shards differs from the sink")
        del gathered
        head = content[:STRIPE_CHUNK]
        rep = ici.replicate_to_mesh(mesh, head)
        if not equal_in_steps(rep.to_local(), head):
            raise AssertionError("replicate_to_mesh differs from the host")
        del rep
        names = ("dp", "tp")
        first = "model.layers.0."
        specs = {"model.embed_tokens.weight": ("dp",),
                 first + "self_attn.q_proj.weight": (None, "tp"),
                 first + "input_layernorm.weight": (),
                 first + "post_attention_layernorm.weight": ()}
        mesh2 = multihost.global_mesh({"dp": 1, "tp": 1})
        shardings = {n: (mesh2, placements_from_spec(names, spec))
                     for n, spec in specs.items()}
        placed = load_from_sink(taken, shardings=shardings)
        plain = load_from_sink(taken)
        if set(placed) != {name for name, _ in layout}:
            raise AssertionError("load_from_sink(shardings=) lost tensors")
        for n in specs:
            local = placed[n].to_local()
            if not torch.equal(local, plain[n]):
                raise AssertionError(f"{n}: placed block differs")
            no_copy[f"load_from_sink {n}"] = (local.data_ptr()
                                              == plain[n].data_ptr())
        del placed, plain
        g = multihost.global_replicated(mesh, u8)
        no_copy["global_replicated"] = g.to_local().data_ptr() == u8.data_ptr()
        g = multihost.global_from_local_shards(mesh, u8)
        no_copy["global_from_local_shards"] = (g.to_local().data_ptr()
                                               == u8.data_ptr())
        del g
        t1 = time.perf_counter()
        sb = ici.StripedBroadcast(mesh, n_chunks=4)
        for o in range(0, content.size, STRIPE_CHUNK):
            sb.feed(content[o:o + STRIPE_CHUNK])
        striped = sb.result().to_local()
        striped_s = time.perf_counter() - t1
        if not equal_in_steps(striped, content):
            raise AssertionError("StripedBroadcast differs from the content")
        del striped, sb
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = checksum.launch_counts()
        calls = ici.collective_counts()
        peak = torch.cuda.max_memory_allocated()
        if not all(no_copy.values()):
            raise AssertionError(f"placements that copied: {no_copy}")

        # Device time of the spread beside a copy_ of the same bytes.
        dst = torch.empty_like(buf)
        ici_ms, ici_us = device_time(
            lambda j: taken.ici_broadcast(mesh, n_chunks=4), 5)
        copy_ms, _ = device_time(lambda j: dst.copy_(buf), 5)
        del dst
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "ranks": 1, "bytes": buf.numel() * 4,
            "no_copy": no_copy, "collective_calls": calls,
            "launches": launches, "peak_device_bytes": peak,
            "path_s": path_s, "striped_feeds": -(-content.size
                                                // STRIPE_CHUNK),
            "striped_s": striped_s, "ici_broadcast_ms": ici_ms,
            "ici_broadcast_call_us": ici_us, "copy_ms": copy_ms}


# --------------------------------------------------------------------- #
# Dataset feed: token records into device batches
# --------------------------------------------------------------------- #

def token_records(seed: int, vocab: int, tokens: int = SEQ_TOKENS,
                  batches: int = FEED_BATCHES, batch: int = FEED_BATCH,
                  tail: int = FEED_TAIL) -> tuple[list, np.ndarray]:
    """``batches`` full batches and a ``tail`` of int32 token sequences;
    every seventh is cut short (a document end) and must be zero-padded.
    Returns (sample dicts, the padded records as uint8 rows)."""
    rng = np.random.default_rng(seed)
    n = batches * batch + tail
    ids = rng.integers(0, vocab, (n, tokens), dtype=np.int32)
    lengths = np.full(n, tokens)
    lengths[::7] = rng.integers(1, tokens, lengths[::7].size)
    for i in np.flatnonzero(lengths < tokens):
        ids[i, lengths[i]:] = 0
    samples = [{"__key__": f"seq-{i:06d}",
                "tokens": ids[i, :lengths[i]].tobytes()} for i in range(n)]
    return samples, ids.view(np.uint8)


def phase_feed(seed: int, vocab: int, device: torch.device, **shape) -> dict:
    """The records through DeviceFeed (pad=True), every batch checked
    against the host records."""
    samples, want = token_records(seed, vocab, **shape)
    record_bytes = want.shape[1]
    batch = shape.get("batch", FEED_BATCH)

    async def stream():
        for s in samples:
            yield s

    async def collect(feed):
        return [b async for b in feed.batches(stream())]

    feed = DeviceFeed("tokens", record_bytes, batch, pad=True, device=device)
    hbm, numpy_ = DEVICE_BATCHES.value("hbm"), DEVICE_BATCHES.value("numpy")
    if _on_card(device):
        torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    batches = asyncio.run(collect(feed))
    if _on_card(device):
        torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    launches = checksum.launch_counts()
    paths = {"hbm": DEVICE_BATCHES.value("hbm") - hbm,
             "numpy": DEVICE_BATCHES.value("numpy") - numpy_}

    sizes = [len(b.keys) for b in batches]
    want_sizes = [batch] * (len(samples) // batch) + (
        [len(samples) % batch] if len(samples) % batch else [])
    if sizes != want_sizes:
        raise AssertionError(f"batch sizes {sizes} != {want_sizes}")
    row = 0
    for b in batches:
        if not b.on_device or b.array.device.type != device.type:
            raise AssertionError("a batch did not land on the device")
        got = b.array.cpu().numpy()
        if not np.array_equal(got, want[row:row + len(b.keys)]):
            raise AssertionError(f"batch at record {row} differs from the "
                                 "host records")
        row += len(b.keys)
    if _on_card(device) and launches["land_and_checksum"] != len(batches):
        raise AssertionError(f"land_and_checksum launched "
                             f"{launches['land_and_checksum']} times for "
                             f"{len(batches)} batches")
    if paths != {"hbm": len(batches), "numpy": 0}:
        raise AssertionError(f"batches by path {paths}")
    nbytes = len(samples) * record_bytes
    return {"batches": len(batches), "records": len(samples),
            "record_bytes": record_bytes,
            "padded_records": int(sum(len(s["tokens"]) < record_bytes
                                      for s in samples)),
            "feed_s": feed_s, "batches_per_s": len(batches) / feed_s,
            "gb_per_s": nbytes / feed_s / 1e9, "paths": paths,
            "launches": launches}


def profile_feed(seed: int, vocab: int, device: torch.device,
                 batches: int = 4) -> dict:
    """A short feed window under ``torch.profiler``: the device
    operations the window queued, by name and count (each batch is one
    sink flush), and K2's kernel time by name, a cross-check of
    ``device_time`` at the feed's shape."""
    from torch.profiler import ProfilerActivity, profile

    samples, _ = token_records(seed, vocab, batches=batches, tail=0)
    feed = DeviceFeed("tokens", SEQ_TOKENS * 4, FEED_BATCH, pad=True,
                      device=device)

    async def run():
        async def stream():
            for s in samples:
                yield s
        return [b async for b in feed.batches(stream())]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        asyncio.run(run())
        torch.cuda.synchronize()
    ops: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = e.name[:60]
            ops[name] = ops.get(name, 0) + 1
    k2 = [e for e in prof.key_averages() if "land_checksum_kernel" in e.key]
    launches = sum(e.count for e in k2)
    device_us = sum(getattr(e, "device_time_total", 0) for e in k2)
    return {"batches": batches, "device_ops": ops, "k2_launches": launches,
            "k2_kernel_us": device_us / launches if launches else None}


# --------------------------------------------------------------------- #
# The dataset plane over the object gateway
# --------------------------------------------------------------------- #

class StandInGateway:
    """The object gateway's routes that the dataset plane and
    ``fetch_or_build_manifest`` use, answered as the reference gateway
    (``dragonfly2_tpu/daemon/objectstorage.py``) answers them, over objects
    held in host memory and served without copies:

    - ``HEAD`` of an object: 200 with ``Content-Length``,
      ``X-Dragonfly-Digest``, ``ETag`` and ``Content-Type`` when known;
      404 for a missing object;
    - ``GET`` of an object, whole (200) or with ``Range`` (206 with
      ``Content-Range``; 416 when unsatisfiable); 502 for a missing one;
    - ``GET ...?ranged_task=1`` with ``Range``: the span as a ranged task
      of its own, 200 with ``X-Dragonfly-Task-Id`` (the span's task id)
      and ``X-Dragonfly-From-Reuse`` (1 once the span was served before);
    - ``PUT`` of an object with a ``Content-Length`` body: 200 with
      ``{"ok": true, "digest": "sha256:..."}``.

    HTTP/1.1 with keep-alive, one thread a connection. ``counts`` holds
    the requests and body bytes served, by kind."""

    def __init__(self):
        self._mu = threading.Lock()
        self._objects: dict[tuple[str, str], dict] = {}
        self._served: set[str] = set()
        self.counts: dict[str, list[int]] = {}
        self._server = None
        self._thread = None

    def put(self, bucket: str, key: str, data, *, digest: str = "",
            content_type: str = "") -> None:
        """Hold ``data`` (bytes-like, not copied) as an object."""
        with self._mu:
            self._objects[(bucket, key)] = {
                "data": memoryview(data).cast("B"), "digest": digest,
                "content_type": content_type,
                "etag": f"{time.time_ns() // 1000:x}"}

    def object_bytes(self, bucket: str, key: str) -> bytes | None:
        obj = self._get(bucket, key)
        return None if obj is None else bytes(obj["data"])

    def start(self) -> str:
        """Serve on 127.0.0.1 at a free port; returns the endpoint."""
        self._server = _GatewayServer(("127.0.0.1", 0), _GatewayHandler)
        self._server.gateway = self
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="df-standin-gateway",
                                        daemon=True)
        self._thread.start()
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=10)
            self._server = None

    def requests(self) -> dict:
        with self._mu:
            return {k: tuple(v) for k, v in self.counts.items()}

    def _count(self, kind: str, nbytes: int) -> None:
        with self._mu:
            c = self.counts.setdefault(kind, [0, 0])
            c[0] += 1
            c[1] += nbytes

    def _get(self, bucket: str, key: str):
        with self._mu:
            return self._objects.get((bucket, key))

    def _served_before(self, task_id: str) -> bool:
        with self._mu:
            seen = task_id in self._served
            self._served.add(task_id)
            return seen


class _GatewayServer(ThreadingHTTPServer):
    # The reference gateway's listen backlog (aiohttp's default): a loader
    # opens one connection a worker thread at once.
    request_queue_size = 128

    def handle_error(self, request, client_address):
        # A client that cancels a read cuts its connection mid-body.
        if not isinstance(sys.exc_info()[1], ConnectionError):
            super().handle_error(request, client_address)


class _GatewayHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, *args):
        pass

    def _route(self):
        parts = urlsplit(self.path)
        segs = parts.path.split("/", 4)
        if len(segs) != 5 or segs[1] != "buckets" or segs[3] != "objects":
            return None
        return unquote(segs[2]), unquote(segs[4]), parse_qs(parts.query)

    def _reply(self, status: int, body=b"", headers=None, *,
               content_type: str = "text/plain; charset=utf-8") -> None:
        self.send_response(status)
        hdrs = {"Content-Type": content_type, **(headers or {})}
        hdrs.setdefault("Content-Length", str(len(body)))
        for k, v in hdrs.items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD" and len(body):
            self.wfile.write(body)

    def do_HEAD(self):
        route = self._route()
        obj = None if route is None else self.server.gateway._get(*route[:2])
        if obj is None:
            self._reply(404)
            return
        self.server.gateway._count("head", 0)
        headers = {"Content-Length": str(len(obj["data"])),
                   "X-Dragonfly-Digest": obj["digest"], "ETag": obj["etag"]}
        if obj["content_type"]:
            headers["Content-Type"] = obj["content_type"]
        self._reply(200, headers=headers)

    def do_GET(self):
        route = self._route()
        if route is None:
            self._reply(404, b"404: Not Found")
            return
        bucket, key, query = route
        gw = self.server.gateway
        obj = gw._get(bucket, key)
        rng_header = self.headers.get("Range", "")
        if rng_header and query.get("ranged_task"):
            self._ranged_task(gw, bucket, key, obj, rng_header)
            return
        if obj is None:
            self._reply(502, f"p2p fetch failed: no object {bucket}/{key}"
                        .encode())
            return
        data = obj["data"]
        if not rng_header:
            gw._count("get", len(data))
            self._reply(200, data, content_type="application/octet-stream")
            return
        try:
            r = Range.parse_http(rng_header, len(data))
        except ValueError as e:
            self._reply(502, f"p2p fetch failed: {e}".encode())
            return
        n = min(r.length, max(len(data) - r.start, 0))
        if n <= 0:
            self._reply(416, b"416: Range Not Satisfiable",
                        {"Content-Range": f"bytes */{len(data)}"})
            return
        gw._count("get_range", n)
        self._reply(206, data[r.start:r.start + n],
                    {"Content-Range":
                     f"bytes {r.start}-{r.start + n - 1}/{len(data)}"},
                    content_type="application/octet-stream")

    def _ranged_task(self, gw, bucket: str, key: str, obj,
                     rng_header: str) -> None:
        try:
            rng = Range.normalize_header(rng_header)
        except ValueError as e:
            self._reply(400, f"bad range {rng_header!r}: {e}".encode())
            return
        r = Range.parse_http(rng)
        if obj is None or r.length < 0 or r.start + r.length > len(
                obj["data"]):
            self._reply(502, f"ranged task failed: no span {rng} of "
                        f"{bucket}/{key}".encode())
            return
        task_id = idgen.task_id_v1(f"standin://{bucket}/{key}", tag=bucket,
                                   range_header=rng)
        reuse = gw._served_before(task_id)
        gw._count("ranged_task", r.length)
        self._reply(200, obj["data"][r.start:r.start + r.length],
                    {"X-Dragonfly-Task-Id": task_id,
                     "X-Dragonfly-From-Reuse": "1" if reuse else "0"},
                    content_type="application/octet-stream")

    def do_PUT(self):
        route = self._route()
        length = self.headers.get("Content-Length")
        if route is None or length is None:
            self._reply(404 if route is None else 411)
            return
        bucket, key, _ = route
        body = self.rfile.read(int(length))
        digest = "sha256:" + hashlib.sha256(body).hexdigest()
        gw = self.server.gateway
        gw.put(bucket, key, body, digest=digest,
               content_type=self.headers.get("Content-Type")
               or "application/octet-stream")
        gw._count("put", 0)
        self._reply(200, json.dumps({"ok": True, "digest": digest}).encode(),
                    content_type="application/json; charset=utf-8")


class StandInProcess:
    """A ``StandInGateway`` in a child process of its own, as the daemon's
    gateway is in a deployment: its request handling does not share the
    client's interpreter lock. The child is spawned (it inherits no thread
    or device state) and makes its objects itself, ``make(*args)`` ->
    {(bucket, key): bytes-like}, from a seed: the objects never cross the
    pipe."""

    def __init__(self, make, *args):
        self._make, self._args = make, args
        self._conn = self._proc = None

    def start(self) -> None:
        """Spawn the child; it makes its objects while the caller goes on."""
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_stand_in_child,
                                 args=(child, self._make, self._args),
                                 daemon=True, name="df-standin-gateway")
        self._proc.start()
        child.close()

    def endpoint(self) -> str:
        """Wait until the child serves; its endpoint."""
        if not self._conn.poll(600):
            raise RuntimeError("the stand-in gateway's process did not start")
        return self._conn.recv()

    def _ask(self, *msg):
        self._conn.send(msg)
        return self._conn.recv()

    def requests(self) -> dict:
        return self._ask("requests")

    def cpu_s(self) -> float:
        """The child's CPU seconds so far, all its threads."""
        return self._ask("cpu")

    def object_bytes(self, bucket: str, key: str) -> bytes | None:
        return self._ask("object", bucket, key)

    def close(self) -> None:
        if self._proc is None:
            return
        try:
            self._ask("stop")
        except (OSError, EOFError):
            pass
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=10)
        self._conn.close()
        self._proc = None


def _stand_in_child(conn, make, args) -> None:
    """The body of ``StandInProcess``'s child: make the objects, serve
    them, answer the parent until told to stop."""
    gw = StandInGateway()
    for (bucket, key), data in make(*args).items():
        gw.put(bucket, key, data)
    conn.send(gw.start())
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                conn.send(None)
                return
            conn.send(gw.requests() if msg[0] == "requests"
                      else time.process_time() if msg[0] == "cpu"
                      else gw.object_bytes(*msg[1:]))
    finally:
        gw.close()


# BASELINE.json's config4_webdataset (4 shards, loader readahead 16) as
# token shards: img2dataset's default 10,000 samples a shard, each a
# `<key>.tokens` of up to SEQ_TOKENS int32 ids and a `<key>.json`.
WDS_BUCKET = "wds"
WDS_SHARDS = 4
WDS_PER_SHARD = 10_000
WDS_READAHEAD = 16
WDS_INTERLEAVE = 4
# The loader alone, timed over this many samples of epoch 1, then cut.
WDS_ALONE = 4096


def wds_shards(seed: int, vocab: int, shards: int = WDS_SHARDS,
               per_shard: int = WDS_PER_SHARD, tokens: int = SEQ_TOKENS
               ) -> tuple[dict, np.ndarray]:
    """USTAR webdataset shards written with ``tarfile`` from ``seed``:
    sample ``<shard:05d><i:04d>`` holds ``.tokens`` (int32 ids of
    ``vocab``; every seventh cut short, as in ``token_records``) and
    ``.json`` (~100 B). Returns ({shard key: tar bytes}, the ids zero-padded
    to ``tokens``, shaped (shards, per_shard, tokens))."""
    rng = np.random.default_rng([seed, 4])
    ids = rng.integers(0, vocab, (shards, per_shard, tokens), dtype=np.int32)
    out = {}
    for s in range(shards):
        lengths = np.full(per_shard, tokens)
        lengths[::7] = rng.integers(1, tokens, lengths[::7].size)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w",
                          format=tarfile.USTAR_FORMAT) as tar:
            for i in range(per_shard):
                n = int(lengths[i])
                ids[s, i, n:] = 0
                key = f"{s:05d}{i:04d}"
                meta = json.dumps({"key": key, "shard": s, "tokens": n,
                                   "vocab": vocab, "seed": seed,
                                   "source": "chip_smoke"}).encode()
                for name, data in ((f"{key}.tokens", ids[s, i, :n].tobytes()),
                                   (f"{key}.json", meta)):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
        out[f"{s:05d}.tar"] = buf.getbuffer()
    return out, ids


def wds_objects(seed: int, vocab: int, shape: dict) -> dict:
    """``wds_shards``' shards as the stand-in gateway's objects."""
    return {(WDS_BUCKET, key): data
            for key, data in wds_shards(seed, vocab, **shape)[0].items()}


def _on_loop_wait(samples, waits: list, depth: list):
    """``samples`` passed on, with the seconds the consumer waited for each
    added to ``waits[0]`` and the readahead depth at each yield summed in
    ``depth[0]``."""
    async def gen():
        it = samples.__aiter__()
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    s = await anext(it)
                except StopAsyncIteration:
                    return
                finally:
                    waits[0] += time.perf_counter() - t0
                depth[0] += READAHEAD_DEPTH.value()
                yield s
        finally:
            await it.aclose()
    return gen()


async def _wds(endpoint: str, gw: StandInProcess, shard_keys: list,
               ids: np.ndarray, seed: int, device: torch.device,
               batch: int, alone: int) -> dict:
    opts = LoaderOptions(seed=seed, num_hosts=1, interleave=WDS_INTERLEAVE,
                         readahead=WDS_READAHEAD)
    store = Dfstore(endpoint)
    try:
        before = {r: INDEX_FETCHES.value(r)
                  for r in ("built", "hit", "stale", "corrupt")}
        # prepare(): every index built by streaming its shard; the seconds
        # in TarIndexer.feed (on the loop) are the index time.
        index_s = [0.0]
        index_feed = tar_index.TarIndexer.feed

        def timed_feed(self, chunk):
            t0 = time.perf_counter()
            try:
                index_feed(self, chunk)
            finally:
                index_s[0] += time.perf_counter() - t0

        tar_index.TarIndexer.feed = timed_feed
        try:
            t0 = time.perf_counter()
            await PodShardedLoader(store, WDS_BUCKET, shard_keys,
                                   options=opts).prepare()
            prepare_s = time.perf_counter() - t0
        finally:
            tar_index.TarIndexer.feed = index_feed
        built = {r: INDEX_FETCHES.value(r) - v for r, v in before.items()}
        t0 = time.perf_counter()
        loader = await PodShardedLoader(store, WDS_BUCKET, shard_keys,
                                        options=opts).prepare()
        hit_s = time.perf_counter() - t0
        fetched = {r: INDEX_FETCHES.value(r) - before[r] - built[r]
                   for r in before}
        n_shards = len(shard_keys)
        if built != {"built": n_shards, "hit": 0, "stale": 0, "corrupt": 0} \
                or fetched != {"built": 0, "hit": n_shards, "stale": 0,
                               "corrupt": 0}:
            raise AssertionError(f"wds: index resolutions {built} then "
                                 f"{fetched}, want {n_shards} built then "
                                 f"{n_shards} hits")
        plan = [k for _, k in loader.plan(0)]
        if len(plan) != ids.shape[0] * ids.shape[1]:
            raise AssertionError(f"wds: plan of {len(plan)} samples")

        # The loader alone, cut after `alone` samples (its readahead
        # cancelled with its span buffers in flight).
        t0 = time.perf_counter()
        n_alone = 0
        async with contextlib.aclosing(loader.epoch(1)) as samples:
            async for _ in samples:
                n_alone += 1
                if n_alone == alone:
                    break
        alone_s = time.perf_counter() - t0
        if loader.pool.stats()["outstanding"]:
            raise AssertionError(f"wds: {loader.pool.stats()} after a cut "
                                 "epoch")

        record_bytes = ids.shape[2] * 4
        feed = DeviceFeed("tokens", record_bytes, batch, pad=True,
                          device=device)
        got = torch.empty((len(plan), record_bytes), dtype=torch.uint8,
                          pin_memory=_on_card(device))
        keys, row, on_device = [], 0, True
        waits, depth = [0.0], [0.0]
        reqs = gw.requests()
        paths0 = {p: DEVICE_BATCHES.value(p) for p in ("hbm", "numpy")}
        if _on_card(device):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        zero_launches()
        cpu0, gw_cpu0 = time.process_time(), gw.cpu_s()
        t0 = time.perf_counter()
        async for b in feed.batches(_on_loop_wait(loader.epoch(0), waits,
                                                   depth)):
            on_device &= b.on_device and b.array.device.type == device.type
            got[row:row + len(b.keys)].copy_(b.array, non_blocking=True)
            keys += b.keys
            row += len(b.keys)
        if _on_card(device):
            torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        cpu_s, gw_cpu_s = time.process_time() - cpu0, gw.cpu_s() - gw_cpu0
        launches = checksum.launch_counts()
        peak = (torch.cuda.max_memory_allocated() if _on_card(device)
                else None)
        paths = {p: DEVICE_BATCHES.value(p) - v for p, v in paths0.items()}
        after = gw.requests()
    finally:
        await store.close()

    n = len(plan)
    batches = -(-n // batch)
    if keys != plan:
        raise AssertionError("wds: the batches' samples are not in plan(0)'s "
                             "order")
    if not on_device:
        raise AssertionError("wds: a batch did not land on the device")
    if paths != {"hbm": batches, "numpy": 0}:
        raise AssertionError(f"wds: batches by path {paths}")
    order = np.array([[int(k[:5]), int(k[5:])] for k in keys])
    for lo in range(0, n, 4096):
        want = ids[order[lo:lo + 4096, 0], order[lo:lo + 4096, 1]]
        if not np.array_equal(got[lo:lo + 4096].numpy(), want.view(np.uint8)):
            raise AssertionError(f"wds: a batch in samples {lo}-{lo + 4096} "
                                 "differs from the host records")
    served = {k: (v[0] - reqs.get(k, (0, 0))[0], v[1] - reqs.get(k, (0, 0))[1])
              for k, v in after.items()}
    sent = sum(v[1] for v in served.values())
    requests = sum(v[0] for v in served.values())
    nbytes = n * record_bytes
    return {"shards": n_shards, "samples": n, "batches": batches,
            "record_bytes": record_bytes, "prepare_s": prepare_s,
            "index_s": index_s[0], "stream_and_rest_s": prepare_s - index_s[0],
            "prepare_hit_s": hit_s, "indexes": {"first": built,
                                                "second": fetched},
            "epoch_s": epoch_s, "samples_per_s": n / epoch_s,
            "batches_per_s": batches / epoch_s,
            "gb_per_s": nbytes / epoch_s / 1e9,
            "loader_wait_s": waits[0], "feed_s": epoch_s - waits[0],
            "cpu_s": cpu_s, "gateway_cpu_s": gw_cpu_s,
            "mean_readahead_depth": depth[0] / n,
            "loader_alone": {"samples": n_alone, "s": alone_s,
                             "samples_per_s": n_alone / alone_s},
            "requests": requests, "request_bytes": sent,
            "mean_request_bytes": sent / max(requests, 1),
            "requests_by_kind": served, "paths": paths,
            "peak_device_bytes": peak, "launches": launches}


def phase_wds(seed: int, vocab: int, device: torch.device, *,
              batch: int = FEED_BATCH, alone: int = WDS_ALONE,
              **shape) -> dict:
    """Webdataset token shards through the whole dataset plane: the
    shards in a stand-in gateway -> ``Dfstore`` -> ``prepare()`` (every
    index built by streaming, then a fresh loader's all hits) ->
    ``PodShardedLoader.epoch(0)`` with ranged reads -> ``DeviceFeed`` ->
    one K2 launch a batch. Checks the order against ``plan(0)``, every
    batch against the host records and the launches of the epoch."""
    # The gateway's process makes the same shards from the seed while this
    # one makes them for the host records (the epoch's check compares
    # every record it served with them).
    gw = StandInProcess(wds_objects, seed, vocab, shape)
    try:
        t0 = time.perf_counter()
        gw.start()
        shards, ids = wds_shards(seed, vocab, **shape)
        endpoint = gw.endpoint()
        make_s = time.perf_counter() - t0
        out = asyncio.run(_wds(endpoint, gw, sorted(shards), ids, seed,
                               device, batch, alone))
    finally:
        gw.close()
    if _on_card(device) and out["launches"] != {
            "chunk_checksums": 0, "land_and_checksum": out["batches"],
            "gear_candidates": 0}:
        raise AssertionError(f"wds: launches {out['launches']}")
    return {"shard_bytes": sum(len(d) for d in shards.values()),
            "make_s": make_s, **out}


GATEWAY_BUCKET = "ckpt"
GATEWAY_KEY = "model-00001-of-00004.safetensors"


async def _gateway_manifest(endpoint: str, gw: StandInGateway,
                            total: int, base_ref: DeltaManifest,
                            device: torch.device) -> dict:
    store = Dfstore(endpoint)
    try:
        before = {r: MANIFEST_FETCHES.value(r)
                  for r in ("built", "hit", "stale", "corrupt")}
        stats: dict = {}
        if _on_card(device):
            torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        m = await fetch_or_build_manifest(store, GATEWAY_BUCKET, GATEWAY_KEY,
                                          params=base_ref.params,
                                          device=device, stats=stats)
        manifest_s = time.perf_counter() - t0
        built = checksum.launch_counts()
        zero_launches()
        hit_stats: dict = {}
        t0 = time.perf_counter()
        again = await fetch_or_build_manifest(
            store, GATEWAY_BUCKET, GATEWAY_KEY, params=base_ref.params,
            device=device, stats=hit_stats)
        hit_s = time.perf_counter() - t0
        hit = checksum.launch_counts()
        counts = {r: MANIFEST_FETCHES.value(r) - v for r, v in before.items()}
    finally:
        await store.close()
    want = dataclasses.replace(base_ref, name=GATEWAY_KEY).to_json_bytes()
    if m.to_json_bytes() != want:
        raise AssertionError("gateway manifest: JSON differs from "
                             "manifest_from_store's over the same content")
    if gw.object_bytes(GATEWAY_BUCKET,
                       manifest_object_key(GATEWAY_KEY)) != want:
        raise AssertionError("gateway manifest: the published object differs")
    if again.to_json_bytes() != want or hit_stats != {"result": "hit"}:
        raise AssertionError(f"gateway manifest: second call {hit_stats}")
    sizes = span_sizes(total, STREAM_CHUNK)
    if (stats["result"] != "built" or stats["feeds"] != len(sizes)
            or counts != {"built": 1, "hit": 1, "stale": 0, "corrupt": 0}):
        raise AssertionError(f"gateway manifest: {stats['result']} over "
                             f"{stats['feeds']} chunks, {counts}; want built "
                             f"over {len(sizes)}, then a hit")
    if _on_card(device) and (built["gear_candidates"] != planned_k3(sizes)
                             or hit["gear_candidates"]):
        raise AssertionError(f"gateway manifest: K3 launched "
                             f"{built['gear_candidates']} times building, "
                             f"{hit['gear_candidates']} on the hit; want "
                             f"{planned_k3(sizes)}, then 0")
    return {"bytes": total, "chunks": m.num_chunks, "manifest_s": manifest_s,
            **stats, "hit_s": hit_s, "resolutions": counts,
            "planned_k3": planned_k3(sizes),
            "launches": {k: built[k] + hit[k] for k in built}}


def phase_gateway_manifest(content: np.ndarray, base_ref: DeltaManifest,
                           device: torch.device) -> dict:
    """``fetch_or_build_manifest`` over the stand-in gateway serving
    generation 1 of the shard: a miss that streams the object through the
    card's chunker (K3 once a stream chunk) and publishes
    ``.dfdelta/<key>.json``, equal to ``manifest_from_store``'s manifest of
    the same content but for its name; then a hit with no K3 launch."""
    gw = StandInGateway()
    gw.put(GATEWAY_BUCKET, GATEWAY_KEY, content)
    try:
        return asyncio.run(_gateway_manifest(gw.start(), gw, content.size,
                                             base_ref, device))
    finally:
        gw.close()


# --------------------------------------------------------------------- #
# The daemon's back-to-source piece path: an origin in a process of its
# own -> the port's TaskManager -> PieceManager -> LocalTaskStore (CRC-32C
# fused into the write) -> on_piece -> DeviceSinkManager (K2) -> finalize
# --------------------------------------------------------------------- #

ORIGIN_BUCKET = "origin"


def origin_objects(path: str) -> dict:
    """The stand-in origin's one object: the shard's file, mapped (the
    bytes never cross the pipe)."""
    with open(path, "rb") as f:
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return {(ORIGIN_BUCKET, GATEWAY_KEY): data}


class TimedSinks(DeviceSinkManager):
    """The daemon's device sink manager, with the host times of a
    request's landing: its first sink call (a piece, or a finalize that
    backfills), the return of its last piece's landing, the start of its
    last finalize and that finalize's return; and the seconds the
    manager's own ``busy_s`` counted on its one ``df-device-sink`` worker
    meanwhile (each piece read back from the store, its host checksum,
    staging, the K2 launches)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.reset()

    def reset(self) -> None:
        self.first = self.last_piece = self.finalize_start = None
        self.finalized = None
        self.busy_from = self.busy_s

    async def on_piece(self, task_id, store, rec) -> None:
        if self.first is None:
            self.first = time.perf_counter()
        await super().on_piece(task_id, store, rec)
        self.last_piece = time.perf_counter()

    async def finalize(self, task_id, store):
        self.finalize_start = time.perf_counter()
        if self.first is None:
            self.first = self.finalize_start
        try:
            return await super().finalize(task_id, store)
        finally:
            self.finalized = time.perf_counter()


class StandInDaemon:
    """The daemon as the client's entry points reach it (``task_manager``),
    its parts built as ``dragonfly2_tpu/daemon/daemon.py`` builds them:
    a ``StorageManager`` over ``data_dir`` (reloaded), a ``PieceManager``
    under an unbounded limiter, the device sink manager, and the
    ``TaskManager`` over them (the process-wide flight recorder, its own
    quarantine); with ``scheduler`` (an address), a ``SchedulerClient`` on
    it and the port's conductor factory over the task manager (each
    conductor built is kept in ``conductors``, each gated by ``wfq`` when
    given), else no scheduler; with ``pex``, a ``PeerExchange`` the caller
    starts. ``serve_download()``
    serves its download service (``DaemonRpcServer``) on loopback and
    gives a drpc client to it."""

    def __init__(self, data_dir: str, device: torch.device,
                 scheduler: str = "", pex: PeerExchange | None = None,
                 wfq: WFQGate | None = None):
        self.storage = StorageManager(StorageOption(data_dir=data_dir))
        self.storage.reload()
        self.piece_manager = PieceManager(PieceManagerOption(),
                                          limiter=Limiter())
        self.device_sinks = TimedSinks(batch_pieces=BATCH_PIECES,
                                       device=device)
        self.scheduler_client = None
        self.conductors: list = []
        self.rpc = None
        if scheduler:
            self.scheduler_client = SchedulerClient([scheduler])
        self.task_manager = TaskManager(
            self.storage, self.piece_manager,
            scheduler_client=self.scheduler_client, pex=pex,
            device_sinks=self.device_sinks)
        if scheduler:
            make = conductor_factory(
                scheduler_client=self.scheduler_client,
                piece_manager=self.piece_manager,
                host_wire=lambda: host_record("chip-child"),
                task_manager=self.task_manager, wfq=wfq)

            def factory(**kw):
                self.conductors.append(make(**kw))
                return self.conductors[-1]
            self.task_manager.conductor_factory = factory

    async def serve_download(self) -> Client:
        self.rpc = DaemonRpcServer(self.task_manager)
        await self.rpc.serve_download(NetAddr.tcp(P2P_HOST, 0))
        return Client(NetAddr.tcp(P2P_HOST, self.rpc.download_server.port()))

    def close(self) -> None:
        self.device_sinks.close()
        self.storage.close()


def quarter_names(layout) -> list[str]:
    """The first quarter of the shard's tensors by bytes, in file order
    (at least one): those ending within a quarter of all tensor bytes."""
    sizes = [(name, int(np.prod(shape)) * 2) for name, shape in layout]
    quarter = sum(n for _, n in sizes) // 4
    names, end = [], 0
    for name, n in sizes:
        end += n
        if names and end > quarter:
            break
        names.append(name)
    return names


def sharded_k2(content_length: int, names: list[str], spans: dict,
               prefix_guess: int = PREFIX_GUESS) -> int:
    """K2 launches of ``download_sharded(names)``: the header's ranged
    task (its guessed prefix) and one ranged task for the selected
    tensors, which lie back to back: each lands in batches of
    BATCH_PIECES."""
    def launches(n: int) -> int:
        pieces = compute_piece_count(n, compute_piece_size(n))
        return -(-pieces // BATCH_PIECES)

    lo, hi = spans[names[0]][0], spans[names[-1]][1]
    return launches(min(prefix_guess, content_length)) + launches(hi - lo)


def _quantiles(xs: list) -> dict:
    """Sum, p50 and p99 of a list of seconds."""
    if not xs:
        return {"sum_s": 0.0, "p50_s": None, "p99_s": None}
    a = np.asarray(xs, np.float64)
    return {"sum_s": float(a.sum()), "p50_s": float(np.percentile(a, 50)),
            "p99_s": float(np.percentile(a, 99))}


async def flight_summary(cli: Client, tm, task_id: str,
                         n_pieces: int) -> dict:
    """A finished task's flight: ``Daemon.FlightReport`` over the port's
    drpc (``cli``, the daemon's download service) for the phase fold, the
    state and the events dropped; and, from the recorder's ring (this
    process holds it), each piece's device landing (``EV_HBM_START`` ->
    ``EV_HBM_LANDED``) and its wait from the store write (``EV_STORED``;
    ``EV_SOURCE_LANDED`` for an origin piece, recorded after its write)
    to ``EV_HBM_START``. Checks the state is ``done``, no event was
    dropped, and every piece has ``EV_LANDED`` (or ``EV_SOURCE_LANDED``)
    and ``EV_HBM_LANDED``."""
    answer = await cli.call("Daemon.FlightReport", {"task_id": task_id},
                            timeout=30.0)
    report = answer["report"]
    marks: dict[int, dict] = {}
    for t, code, piece, _aux, _note in tm.flight.get(task_id).events():
        if piece >= 0:
            marks.setdefault(piece, {})[code] = t
    landed = {n for n, m in marks.items()
              if flight.EV_LANDED in m or flight.EV_SOURCE_LANDED in m}
    hbm = {n for n, m in marks.items() if flight.EV_HBM_LANDED in m}
    if (report["state"] != "done" or report["events_dropped"]
            or landed != set(range(n_pieces)) or hbm != landed):
        raise AssertionError(
            f"flight of {task_id[:16]}: state {report['state']}, "
            f"{report['events_dropped']} events dropped, {len(landed)} "
            f"pieces landed and {len(hbm)} on the device of {n_pieces}")
    stored_mark = (flight.EV_STORED if any(flight.EV_STORED in m
                                           for m in marks.values())
                   else flight.EV_SOURCE_LANDED)
    device_s, wait_s = [], []
    for m in marks.values():
        device_s.append(m[flight.EV_HBM_LANDED] - m[flight.EV_HBM_START])
        if stored_mark in m:
            wait_s.append(m[flight.EV_HBM_START] - m[stored_mark])
    return {"state": report["state"], "wall_s": report["wall_s"],
            "phases": report["phases"], "other_s": report["other_s"],
            "dominant_phase": report["dominant_phase"],
            "events": report["events"],
            "events_dropped": report["events_dropped"],
            "event_counts": report["event_counts"],
            "waterfall_lines": len(answer["text"].splitlines()),
            "digest_bytes": answer["digest"]["bytes"],
            "hbm": _quantiles(device_s),
            "wait_from": flight.EVENT_NAMES[stored_mark],
            "stored_to_hbm": _quantiles(wait_s)}


def flight_line(what: str, f: dict) -> str:
    """One printed line of a flight summary."""
    ph = ", ".join(f"{k} {v:.4f} s" for k, v in f["phases"].items())
    h, w = f["hbm"], f["stored_to_hbm"]
    return (f"{what} flight: {f['state']}, wall {f['wall_s']:.4f} s = {ph}, "
            f"other {f['other_s']:.4f} s (dominant {f['dominant_phase']}); "
            f"EV_HBM_START -> EV_HBM_LANDED a piece: sum {h['sum_s']:.4f} s,"
            f" p50 {h['p50_s'] * 1e3:.3f} ms, p99 {h['p99_s'] * 1e3:.3f} ms; "
            f"{f['wait_from']} -> EV_HBM_START: sum {w['sum_s']:.4f} s, p50 "
            f"{w['p50_s'] * 1e3:.3f} ms, p99 {w['p99_s'] * 1e3:.3f} ms; "
            f"{f['events']} events, {f['events_dropped']} dropped")


def _origin_delta(before: dict, after: dict) -> dict:
    out = {}
    for kind, (n, b) in after.items():
        n0, b0 = before.get(kind, (0, 0))
        if n != n0:
            out[kind] = [n - n0, b - b0]
    return out


async def _daemon_requests(d: StandInDaemon, url: str, sha: str,
                           gw: StandInProcess, host: torch.Tensor,
                           spans: dict, layout, names: list[str],
                           device) -> dict:
    """Cold, warm, sharded and digest requests through the client's entry
    points; each checked, counted and timed. The cold request carries no
    digest, so that it is the local parent of the sharded request's
    ranged tasks (which carry none); the digest request carries the
    shard's sha256, a task of its own fetched from the origin again, with
    the store's prefix hasher beside the landing and the completion
    re-hash before the finalize."""
    sinks, pm = d.device_sinks, d.piece_manager
    out = {}
    result = u8 = None
    cli = await d.serve_download()

    def check_tensors(tensors: dict, want: list[str], what: str) -> None:
        if set(tensors) != set(want):
            raise AssertionError(f"daemon {what}: tensors {sorted(tensors)}")
        for name in want:
            t = tensors[name]
            b, e = spans[name]
            if t.dtype != torch.bfloat16 or not torch.equal(
                    t.reshape(-1).view(torch.uint8), host[b:e]):
                raise AssertionError(f"daemon {what}: {name} differs from "
                                     "the shard")

    for what in ("cold", "warm", "sharded", "digest"):
        # One turn of the loop drops the last landing's sink (a finished
        # executor future still holds it), so each request's peak counts
        # its own memory only.
        await asyncio.sleep(0)
        sinks.reset()
        rehash_before = COMPLETION_REHASH.value("hashed")
        pm_before = dict(pm.timings)
        origin_before = gw.requests()
        _sync(device)
        base = _memory_mark(device)
        zero_launches()
        t0 = time.perf_counter()
        if what == "sharded":
            tensors = await download_sharded(d, url, names=names)
            _sync(device)
            wall = time.perf_counter() - t0
            peak = _memory_mark(device, peak=True) - base
            sink = None
            check_tensors(tensors, names, what)
            rec = {"tensors": len(tensors),
                   "bytes": spans[names[-1]][1] - spans[names[0]][0]}
        else:
            result = await download_to_device(
                d, url, digest=sha if what == "digest" else "")
            sink = result.sink
            u8 = result.as_bytes_array()
            # The gate a consumer runs after take (K1 over the pieces).
            verify_u8_against_host(u8, sink.sink.piece_size,
                                   sink.sink.host_checksums)
            tensors = result.load_safetensors()
            _sync(device)
            wall = time.perf_counter() - t0
            peak = _memory_mark(device, peak=True) - base
            if not torch.equal(u8, host):
                raise AssertionError(f"daemon {what}: landed bytes differ "
                                     "from the shard")
            check_tensors(tensors, [n for n, _ in layout], what)
            if result.from_reuse != (what == "warm"):
                raise AssertionError(f"daemon {what}: from_reuse "
                                     f"{result.from_reuse}")
            rec = {"tensors": len(tensors), "bytes": int(u8.numel()),
                   "task_id": result.task_id,
                   "from_reuse": result.from_reuse}
        launches = checksum.launch_counts()
        rec.update({
            "wall_s": wall, "launches": launches,
            "peak_device_bytes": peak,
            "origin": _origin_delta(origin_before, gw.requests()),
            "land_s": sinks.finalized - sinks.first,
            # From the last piece landed to the finalize: the completion
            # re-hash of a request with a digest.
            "last_piece_to_finalize_s": (
                None if sinks.last_piece is None
                else sinks.finalize_start - sinks.last_piece),
            "rehash": COMPLETION_REHASH.value("hashed") - rehash_before,
            "sink_busy_s": sinks.busy_s - sinks.busy_from,
            "origin_wait_s": pm.timings["origin_wait_s"]
            - pm_before["origin_wait_s"],
            "store_write_s": pm.timings["store_write_s"]
            - pm_before["store_write_s"]})
        if sink is not None:
            rec.update({key: getattr(sink.sink, key) for key in (
                "host_checksum_s", "stage_s", "stage_wait_s")})
        out[what] = rec
        tensors = sink = result = u8 = None   # each landing goes in turn
    n_pieces = compute_piece_count(host.numel(),
                                   compute_piece_size(host.numel()))
    out["flight"] = await flight_summary(cli, d.task_manager,
                                         out["cold"]["task_id"], n_pieces)
    await cli.close()
    await d.rpc.close()
    return out


def _sync(device: torch.device) -> None:
    if _on_card(device):
        torch.cuda.synchronize()


def _memory_mark(device: torch.device, peak: bool = False) -> int:
    """Device bytes allocated now, its peak reset from here; with
    ``peak``, the peak since the last mark. 0 off the card."""
    if not _on_card(device):
        return 0
    if peak:
        return torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def phase_daemon(content: np.ndarray, spans: dict, layout,
                 device: torch.device) -> dict:
    """The shard served over HTTP from a process of its own (the phase's
    temporary directory holds its file and the daemon's store), fetched
    through the port's daemon piece path: a cold request (every piece
    from the origin, landed by K2 as it arrives), a warm one (the
    completed task reused, the sink backfilled from the store, no origin
    request) and a sharded one (the first quarter of the tensors as
    ranged tasks that import from the local parent, no origin request).
    Checks every byte and tensor, the store's digest against the shard's
    sha256, the origin's requests and each request's launches."""
    tmp = tempfile.mkdtemp(prefix="df-chip-daemon-")
    gw = d = None
    try:
        # The origin's file, the cold and the digest request's stores, and
        # the sharded request's ranged stores, with a GiB to spare.
        need = 3 * content.size + content.size // 4 + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(
                f"the daemon phase needs {need} B free under {tmp} (the "
                f"origin's file and the daemon's stores); {free} B are")
        path = os.path.join(tmp, GATEWAY_KEY)
        t0 = time.perf_counter()
        content.tofile(path)
        origin_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sha = "sha256:" + hashlib.sha256(memoryview(content)).hexdigest()
        sha_s = time.perf_counter() - t0
        gw = StandInProcess(origin_objects, path)
        gw.start()
        url = (f"{gw.endpoint()}/buckets/{ORIGIN_BUCKET}/objects/"
               f"{GATEWAY_KEY}")
        d = StandInDaemon(os.path.join(tmp, "data"), device)
        host = torch.from_numpy(content).to(device)
        names = quarter_names(layout)
        out = asyncio.run(_daemon_requests(d, url, sha, gw, host, spans,
                                           layout, names, device))
        del host
        cold_store = d.storage.find_completed_task(out["cold"]["task_id"])
        t0 = time.perf_counter()
        got = cold_store.validate_digest(sha)
        validate_s = time.perf_counter() - t0
        store_bytes = d.storage.total_disk_usage()
        cold = out["cold"]
        piece_size = compute_piece_size(content.size)
        n_pieces = compute_piece_count(content.size, piece_size)
        k2 = -(-n_pieces // BATCH_PIECES)
        want = {"cold": (2, k2), "warm": (2, k2),
                "sharded": (0, sharded_k2(content.size, names, spans)),
                "digest": (2, k2)}
        # The origin: one probe and one ranged GET a piece group for each
        # fetch, nothing for the others.
        groups = min(PieceManagerOption().concurrency, n_pieces)
        for what in ("cold", "digest"):
            if out[what]["origin"] != {"get_range": [1 + groups,
                                                     1 + content.size]}:
                raise AssertionError(f"daemon {what}: origin saw "
                                     f"{out[what]['origin']}")
        for what in ("warm", "sharded"):
            if out[what]["origin"]:
                raise AssertionError(f"daemon {what}: origin saw "
                                     f"{out[what]['origin']}")
        # The completion re-hash runs for the digest request only.
        rehash = {w: out[w]["rehash"] for w in want}
        if rehash != {"cold": 0, "warm": 0, "sharded": 0, "digest": 1}:
            raise AssertionError(f"daemon: completion re-hashes {rehash}")
        digest_store = d.storage.find_completed_task(
            out["digest"]["task_id"])
        if digest_store is None or digest_store.metadata.digest != sha:
            raise AssertionError("daemon digest: the store holds no "
                                 "checked digest")
        if _on_card(device):
            for what, (k1_n, k2_n) in want.items():
                if out[what]["launches"] != {"chunk_checksums": k1_n,
                                             "land_and_checksum": k2_n,
                                             "gear_candidates": 0}:
                    raise AssertionError(
                        f"daemon {what}: launches {out[what]['launches']}, "
                        f"want K1 {k1_n}, K2 {k2_n}")
        launches = {k: sum(out[w]["launches"][k] for w in want)
                    for k in cold["launches"]}
        return {**out, "launches": launches, "sha256": sha, "validated": got,
                "sharded_names": len(names), "origin_write_s": origin_write_s,
                "sha256_s": sha_s, "validate_s": validate_s,
                "origin_file_bytes": content.size, "store_bytes": store_bytes,
                "piece_size": piece_size,
                "pieces": n_pieces, "want_k2": {w: v[1] for w, v in
                                                want.items()}}
    finally:
        if gw is not None:
            gw.close()
        if d is not None:
            d.close()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# The P2P half: the shard pulled from a parent daemon in a process of its
# own (stand-in origin, the port's daemon with its upload server and
# DaemonRpcServer, a stand-in scheduler) -> the port's PeerTaskConductor
# -> PieceTaskSynchronizer -> PieceDispatcher -> PieceDownloader ->
# LocalTaskStore -> DeviceSinkManager (K2) -> certification -> finalize
# --------------------------------------------------------------------- #

P2P_HOST = "127.0.0.1"


def host_record(name: str, port: int = 0, upload_port: int = 0,
                host_type: int = 0) -> dict:
    """A daemon's host record as the JAX scheduler's ``Host.to_wire``
    gives it (its id is the JAX announcer's: hostname-port)."""
    return {"id": f"{name}-{port}", "hostname": name, "ip": P2P_HOST,
            "port": port, "upload_port": upload_port, "type": host_type,
            "idc": "", "location": "", "tpu_slice": "",
            "tpu_worker_index": -1}


class StandInScheduler:
    """``Scheduler.AnnouncePeer`` on the port's drpc server: a stand-in for
    the JAX scheduler (``dragonfly2_tpu/scheduler/service.py``), not a port
    of it. A registration (or a reschedule) for a task that ``storage``
    holds complete is answered with ``normal_task`` naming that store's
    peer as the one parent, in the JAX scheduler's wire shape: the task's
    wire form, the parent's id, host record, state, finished pieces and
    its first 512 piece digests, ``sched_wall`` and ``packed_reports``
    (True, as the JAX scheduler stamps it: batches may come packed); any
    other with ``need_back_source``. Each message is checked against the
    JAX scheduler's schema (``proto/wire.validate_stream_msg``) and
    recorded by task id: its kind, the pieces reported (a packed batch
    decoded by ``proto/reportcodec.decode_packed``) and the batches that
    came packed, whether the peer registered as a seed, and the terminal
    message's flight digest; the pieces' ``timings`` (and the failures'
    reasons, against the parent) feed a ``PodAggregator`` by host, as the
    JAX scheduler's reports feed its ``pod_flight`` (the digests go to
    its pod lens, which has no stand-in here). ``Scheduler.AnnounceHost``
    (checked against its schema) records the host by id and answers as
    the JAX scheduler answers a host it keeps no scorecard of,
    ``{ok, sched_wall}``; ``Scheduler.LeaveHost`` drops it, ``{ok}``
    false for a host it does not know. ``hosts`` holds the announced
    hosts, ``announces`` each announce's body and ``left`` the ids that
    left."""

    def __init__(self, storage, host: dict):
        self.storage = storage
        self.host = host
        self.server = Server("standin.scheduler")
        self.server.register_stream("Scheduler.AnnouncePeer", self._announce)
        self.server.register_unary("Scheduler.AnnounceHost",
                                   self._announce_host)
        self.server.register_unary("Scheduler.LeaveHost", self._leave_host)
        self.records: dict[str, dict] = {}
        self.pod = flight.PodAggregator()
        self._ended: dict[str, asyncio.Event] = {}
        self.hosts: dict[str, dict] = {}
        self.announces: list[dict] = []
        self.left: list[str] = []

    async def serve(self) -> str:
        await self.server.serve(NetAddr.tcp(P2P_HOST, 0))
        return f"{P2P_HOST}:{self.server.port()}"

    async def _announce_host(self, body, ctx) -> dict:
        self.announces.append(dict(body))
        self.hosts[body["id"]] = {k: v for k, v in body.items()
                                  if k not in ("telemetry", "clock")}
        return {"ok": True, "sched_wall": flight.anchored_wall()}

    async def _leave_host(self, body, ctx) -> dict:
        host_id = (body or {}).get("id", "")
        self.left.append(host_id)
        return {"ok": self.hosts.pop(host_id, None) is not None}

    def answer(self, body: dict) -> dict:
        task_id = body["task_id"]
        task = {"id": task_id, "url": body.get("url", ""),
                "tag": body.get("tag", ""),
                "application": body.get("application", ""),
                "tenant": body.get("tenant", ""), "state": "pending",
                "content_length": -1, "piece_size": 0,
                "total_piece_count": -1, "peer_count": 1,
                "size_scope": "unknow"}
        store = self.storage.find_completed_task(task_id)
        if store is None:
            return {"type": "need_back_source", "reason": "no parent",
                    "task": task, "sched_wall": flight.anchored_wall(),
                    "packed_reports": True}
        m = store.metadata
        nums = sorted(m.pieces)
        task.update(state="succeeded", content_length=m.content_length,
                    piece_size=m.piece_size,
                    total_piece_count=m.total_piece_count, peer_count=2,
                    size_scope="normal")
        parent = {"id": m.peer_id, "task_id": task_id, "host": self.host,
                  "state": "succeeded", "finished_pieces": nums,
                  "piece_digests": {n: m.pieces[n].digest for n in nums[:512]
                                    if m.pieces[n].digest},
                  "is_seed": True, "priority": 3}
        return {"type": "normal_task", "task": task, "parents": [parent],
                "sched_wall": flight.anchored_wall(), "packed_reports": True}

    async def _announce(self, stream, ctx) -> None:
        body = stream.open_body or {}
        task_id = body.get("task_id", "")
        host_id = (body.get("host") or {}).get("id", "")
        rec = self.records.setdefault(task_id, {
            "messages": {}, "reported": 0, "pieces": set(), "packed": 0,
            "timed": 0, "digested": 0, "flight": None})
        rec["is_seed"] = bool(body.get("is_seed"))
        while True:
            msg = await stream.recv()
            if msg is None:
                return
            wire.validate_stream_msg("Scheduler.AnnouncePeer", msg)
            kind = msg.get("type", "")
            rec["messages"][kind] = rec["messages"].get(kind, 0) + 1
            reported = []
            if kind == "piece_finished":
                reported = [msg["piece"]]
            elif kind == "pieces_finished" and msg.get("packed"):
                batch = reportcodec.decode_packed(msg["packed"])
                reported = batch.to_dicts()
                rec["packed"] += 1
                self.pod.note_pieces(task_id, host_id, batch.n,
                                     batch.phase_ms)
            elif kind == "pieces_finished":
                reported = msg.get("pieces") or []
            if kind == "piece_finished" or (kind == "pieces_finished"
                                            and not msg.get("packed")):
                for p in reported:
                    self.pod.note_piece(task_id, host_id, p.get("timings"),
                                        p.get("download_cost_ms", 0))
            if kind == "piece_failed":
                # The one parent this stand-in names is the failing one.
                self.pod.note_failure(task_id, self.host["id"],
                                      msg.get("reason", ""))
            rec["reported"] += len(reported)
            rec["timed"] += sum(1 for p in reported if p.get("timings"))
            rec["digested"] += sum(1 for p in reported if p.get("digest"))
            rec["pieces"].update(p["piece_num"] for p in reported)
            if kind in ("register", "reschedule"):
                await stream.send(self.answer(body))
            elif kind in ("download_finished", "download_failed"):
                rec["flight"] = msg.get("flight")
                self._ended.setdefault(task_id, asyncio.Event()).set()
                return

    async def summary(self, task_id: str = "",
                      timeout: float = 10.0) -> dict:
        """What was recorded, by task id. With ``task_id``, once that task's
        terminal message has been read (or ``timeout`` passed): a child's
        last messages are sent, not yet read here, when its request
        returns."""
        if task_id:
            ended = self._ended.setdefault(task_id, asyncio.Event())
            try:
                await asyncio.wait_for(ended.wait(), timeout)
            except asyncio.TimeoutError:
                pass
        out = {}
        for t, r in self.records.items():
            fl = r["flight"] or {}
            out[t] = {"messages": dict(r["messages"]),
                      "reported": r["reported"], "pieces": len(r["pieces"]),
                      "is_seed": r["is_seed"], "packed": r["packed"],
                      "timed": r["timed"], "digested": r["digested"],
                      "pod": self.pod.report(t),
                      "flight": {key: fl.get(key) for key in (
                          "state", "wall_s", "phases", "other_s",
                          "dominant_phase", "pieces_total", "events_total",
                          "events_dropped", "bytes")} if fl else None,
                      "clock_samples": len(fl.get("clock") or [])}
        return out


# The tenants the p2p phase's pulls carry: the first two untagged, the
# gated pull's a trainer's.
P2P_TENANTS = ("default", "trainer")


class P2PParentDaemon:
    """The parent's daemon: the port's ``StorageManager``, ``PieceManager``
    and ``TaskManager`` (no scheduler: it fetches back-to-source), its
    ``UploadManager`` (with unlimited tenant buckets, which account the
    bytes served by tenant) and ``DaemonRpcServer``, and the stand-in
    scheduler over its storage; with ``pex_secret``, a ``PeerExchange`` on
    loopback
    sealed with it (started before the fetches, so each completed task is
    gossiped)."""

    async def start(self, data_dir: str, pex_secret: str = "") -> str:
        self.storage = StorageManager(StorageOption(data_dir=data_dir))
        self.task_manager = TaskManager(
            self.storage, PieceManager(PieceManagerOption(),
                                       limiter=Limiter()))
        # Unlimited tenant buckets: pure accounting of the bytes served
        # by tenant (peer_upload_bytes_total{tenant}).
        self.upload = UploadManager(self.storage,
                                    qos_buckets=TenantBuckets())
        upload_port = self.upload.serve(P2P_HOST)
        self.rpc = DaemonRpcServer(self.task_manager)
        await self.rpc.serve_peer(NetAddr.tcp(P2P_HOST, 0))
        self.pex = None
        if pex_secret:
            self.pex = PeerExchange(ip=P2P_HOST,
                                    peer_port=self.rpc.peer_server.port(),
                                    upload_port=upload_port,
                                    secret=pex_secret)
            await self.pex.start(0)
            self.task_manager.pex = self.pex
        self.scheduler = StandInScheduler(self.storage, host_record(
            "chip-parent", self.rpc.peer_server.port(), upload_port,
            host_type=1))
        return await self.scheduler.serve()

    async def fetch(self, url: str, digest: str) -> float:
        t0 = time.perf_counter()
        req = FileTaskRequest(url=url, output="", meta=UrlMeta(digest=digest))
        last = [p async for p in self.task_manager.start_file_task(req)][-1]
        if last.state != "done" or last.from_p2p:
            raise AssertionError(f"p2p parent: fetch {last.to_wire()}")
        return time.perf_counter() - t0

    async def close(self) -> None:
        if self.pex is not None:
            await self.pex.stop()
        await self.scheduler.server.close()
        await self.rpc.close()
        self.upload.close()
        self.storage.close()


def _p2p_parent(conn, path: str, data_dir: str, sha: str,
                pex_secret: str = "") -> None:
    """The body of ``P2PParent``'s process: a stand-in origin over the
    shard's file, the parent's daemon fetching the shard from it twice
    (with no digest and with ``sha``: two tasks, both done, their piece
    digests their own; with no ``sha``, once), then answers to the
    measured process until told to stop. Its event loop runs on a thread
    of its own; the pipe is served here."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="df-p2p-parent",
                              daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result()

    gw = StandInGateway()
    for (bucket, key), data in origin_objects(path).items():
        gw.put(bucket, key, data)
    url = f"{gw.start()}/buckets/{ORIGIN_BUCKET}/objects/{GATEWAY_KEY}"
    daemon = P2PParentDaemon()
    try:
        scheduler = run(daemon.start(data_dir, pex_secret))
        fetch_s = [run(daemon.fetch(url, digest))
                   for digest in (("", sha) if sha else ("",))]
        conn.send({"url": url, "scheduler": scheduler, "fetch_s": fetch_s,
                   "pex": f"{P2P_HOST}:{daemon.pex.port}" if daemon.pex
                   else ""})
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                conn.send(None)
                return
            scheduler = run(daemon.scheduler.summary(msg[1]))
            conn.send({"origin": gw.requests(),
                       "upload_bytes": UPLOAD_BYTES.value(),
                       "upload_requests": UPLOAD_REQUESTS.value("ok"),
                       "tenant_bytes": {t: TENANT_UPLOAD_BYTES.value(t)
                                        for t in P2P_TENANTS},
                       "scheduler": scheduler,
                       "cpu_s": time.process_time()})
    finally:
        run(daemon.close())
        gw.close()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)


class P2PParent(StandInProcess):
    """``P2PParentDaemon`` and its stand-in origin in a process of its own
    (spawned), as a parent is another host: its serving does not share the
    measured child's interpreter lock. ``endpoint()`` waits for its
    fetches and gives the origin's URL, the scheduler's address and, with
    ``pex_secret``, its gossip address; ``stats()`` the origin's
    requests, the upload server's served bytes and requests, and what the
    stand-in scheduler recorded."""

    def __init__(self, path: str, data_dir: str, sha: str,
                 pex_secret: str = ""):
        super().__init__(None, path, data_dir, sha, pex_secret)

    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_p2p_parent,
                                 args=(child, *self._args), daemon=True,
                                 name="df-p2p-parent")
        self._proc.start()
        child.close()

    def stats(self, task_id: str = "") -> dict:
        """With ``task_id``, once the scheduler has read that task's
        terminal message."""
        return self._ask("stats", task_id)


async def _p2p_requests(d: StandInDaemon, url: str, sha: str,
                        parent: P2PParent, host: torch.Tensor, spans: dict,
                        layout, device) -> dict:
    """The two requests of the P2P phase through ``download_to_device``:
    with no digest, then with the shard's sha256; each checked, counted
    and timed."""
    sinks = d.device_sinks
    out = {}
    cli = await d.serve_download()
    for what in ("plain", "digest"):
        await asyncio.sleep(0)
        sinks.reset()
        rehash = (COMPLETION_REHASH.value("skipped"),
                  COMPLETION_REHASH.value("hashed"))
        before = parent.stats()
        _sync(device)
        base = _memory_mark(device)
        zero_launches()
        t0 = time.perf_counter()
        result = await download_to_device(
            d, url, digest=sha if what == "digest" else "")
        u8 = result.as_bytes_array()
        verify_u8_against_host(u8, result.sink.sink.piece_size,
                               result.sink.sink.host_checksums)
        tensors = result.load_safetensors()
        _sync(device)
        wall = time.perf_counter() - t0
        peak = _memory_mark(device, peak=True) - base
        launches = checksum.launch_counts()
        after = parent.stats(result.task_id)
        if not torch.equal(u8, host):
            raise AssertionError(f"p2p {what}: landed bytes differ from the "
                                 "shard")
        if set(tensors) != {n for n, _ in layout}:
            raise AssertionError(f"p2p {what}: tensors {sorted(tensors)}")
        for name, t in tensors.items():
            b, e = spans[name]
            if t.dtype != torch.bfloat16 or not torch.equal(
                    t.reshape(-1).view(torch.uint8), host[b:e]):
                raise AssertionError(f"p2p {what}: {name} differs from the "
                                     "shard")
        if not result.from_p2p or result.from_reuse:
            raise AssertionError(f"p2p {what}: from_p2p {result.from_p2p}, "
                                 f"from_reuse {result.from_reuse}")
        timings = d.conductors[-1].downloader.timings
        out[what] = {
            "task_id": result.task_id, "bytes": int(u8.numel()),
            "tensors": len(tensors), "wall_s": wall, "launches": launches,
            "peak_device_bytes": peak,
            "origin": _origin_delta(before["origin"], after["origin"]),
            "upload_bytes": after["upload_bytes"] - before["upload_bytes"],
            "upload_requests": after["upload_requests"]
            - before["upload_requests"],
            "tenant_bytes": {t: after["tenant_bytes"][t]
                             - before["tenant_bytes"][t]
                             for t in P2P_TENANTS},
            "scheduler": after["scheduler"].get(result.task_id, {}),
            "rehash": {"skipped": COMPLETION_REHASH.value("skipped")
                       - rehash[0],
                       "hashed": COMPLETION_REHASH.value("hashed")
                       - rehash[1]},
            "land_s": sinks.finalized - sinks.first,
            "last_piece_to_finalize_s": sinks.finalize_start
            - sinks.last_piece,
            "sink_busy_s": sinks.busy_s - sinks.busy_from,
            "get_wait_s": timings["get_wait_s"],
            "store_write_s": timings["store_write_s"],
            "parent_cpu_s": after["cpu_s"] - before["cpu_s"],
            **{key: getattr(result.sink.sink, key) for key in (
                "host_checksum_s", "stage_s", "stage_wait_s")}}
        tensors = result = u8 = None   # each landing goes in turn
    out["flight"] = await flight_summary(
        cli, d.task_manager, out["plain"]["task_id"],
        compute_piece_count(host.numel(), compute_piece_size(host.numel())))
    await cli.close()
    await d.rpc.close()
    await d.scheduler_client.close()
    return out


async def _p2p_gated(d: StandInDaemon, url: str, parent: P2PParent,
                     host: torch.Tensor, gate: WFQGate, device) -> dict:
    """The gated pull: ``Daemon.Download`` (``device: "tpu"``) with the
    tenant ``trainer`` from a fresh child whose piece workers pass the
    QoS gate; the verified buffer taken from the sink manager, gated by K1
    and held to every byte."""
    sinks = d.device_sinks
    cli = await d.serve_download()
    task_id = FileTaskRequest(url=url, output="").task_id()
    try:
        await asyncio.sleep(0)
        sinks.reset()
        before = parent.stats()
        grants = {c: GRANTS.value(c) for c in ("interactive", "normal",
                                              "background")}
        _sync(device)
        zero_launches()
        t0 = time.perf_counter()
        stream = await cli.open_stream("Daemon.Download", {
            "url": url, "device": "tpu", "meta": {"tenant": "trainer"}})
        frames = []
        while (msg := await stream.recv(timeout=600.0)) is not None:
            frames.append(msg)
        last = frames[-1]
        if (last["state"] != "done" or not last["from_p2p"]
                or not last["device_verified"]):
            raise AssertionError(f"p2p gated: the download ended {last}")
        sink = sinks.take(task_id)
        u8 = sink.as_bytes_array()
        verify_u8_against_host(u8, sink.sink.piece_size,
                               sink.sink.host_checksums)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = checksum.launch_counts()
        equal = bool(torch.equal(u8, host))
        after = parent.stats(task_id)
        out = {"task_id": task_id, "bytes": int(u8.numel()), "equal": equal,
               "wall_s": wall, "launches": launches,
               "land_s": sinks.finalized - sinks.first,
               "sink_busy_s": sinks.busy_s - sinks.busy_from,
               "grants": {c: GRANTS.value(c) - n for c, n in grants.items()},
               "gate_active": gate.active, "gate_capacity": gate.capacity,
               "conductors": len(d.conductors),
               "tenant": d.conductors[-1].tenant if d.conductors else "",
               "origin": _origin_delta(before["origin"], after["origin"]),
               "upload_bytes": after["upload_bytes"] - before["upload_bytes"],
               "tenant_bytes": {t: after["tenant_bytes"][t]
                                - before["tenant_bytes"][t]
                                for t in P2P_TENANTS},
               "parent_cpu_s": after["cpu_s"] - before["cpu_s"]}
        sink = u8 = None
        return out
    finally:
        await cli.close()
        await d.rpc.close()
        await d.scheduler_client.close()


def phase_p2p(content: np.ndarray, spans: dict, layout,
              device: torch.device) -> dict:
    """The shard pulled from a parent on this host, in a process of its
    own, through the port's P2P path: two ``download_to_device`` requests
    (no digest; the shard's sha256), each registered with the stand-in
    scheduler, every piece fetched from the parent's upload server in
    runs and landed by K2 as it arrives. Checks every byte and tensor, no
    origin request, the bytes the parent served, the reports the
    scheduler saw, each request's launches, the digest request's skipped
    re-hash, and (after the timed window) that store's digest against the
    shard's sha256. Then the first child's stores go, and a fresh child
    whose piece workers pass a ``WFQGate`` of 2 x the parent concurrency
    pulls the shard again as the tenant ``trainer`` (``gated``): every
    byte, its launches, the gate's grants, and the parent's bytes served
    by tenant (its upload server accounts them in unlimited
    ``TenantBuckets``), each pull's tenant the content's size."""
    tmp = tempfile.mkdtemp(prefix="df-chip-p2p-")
    parent = d = None
    try:
        # The origin's file, the parent's two stores and the child's two,
        # with a GiB to spare.
        need = 5 * content.size + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(
                f"the p2p phase needs {need} B free under {tmp} (the "
                f"origin's file and four stores); {free} B are")
        path = os.path.join(tmp, GATEWAY_KEY)
        content.tofile(path)
        sha = "sha256:" + hashlib.sha256(memoryview(content)).hexdigest()
        parent = P2PParent(path, os.path.join(tmp, "parent"), sha)
        parent.start()
        info = parent.endpoint()
        d = StandInDaemon(os.path.join(tmp, "child"), device,
                          scheduler=info["scheduler"])
        host = torch.from_numpy(content).to(device)
        out = asyncio.run(_p2p_requests(d, info["url"], sha, parent, host,
                                        spans, layout, device))
        del host
        n_pieces = compute_piece_count(content.size,
                                       compute_piece_size(content.size))
        k2 = -(-n_pieces // BATCH_PIECES)
        for what in ("plain", "digest"):
            r = out[what]
            if r["origin"]:
                raise AssertionError(f"p2p {what}: origin saw {r['origin']}")
            if r["upload_bytes"] != content.size:
                raise AssertionError(f"p2p {what}: the parent served "
                                     f"{r['upload_bytes']} B")
            sched = r["scheduler"]
            msgs = sched.get("messages", {})
            # Every piece reported with its digest, at least one batch
            # packed (the stand-in stamps packed_reports), and the flight
            # digest
            if (sched.get("reported") != n_pieces
                    or sched.get("pieces") != n_pieces
                    or sched.get("digested") != n_pieces
                    or sched.get("packed", 0) < 1
                    # shipped with the terminal message, before the task
                    # manager finishes the flight: still "running"
                    or (sched.get("flight") or {}).get("state") != "running"
                    or msgs.get("download_finished") != 1
                    or msgs.get("register") != 1
                    or "download_failed" in msgs or "reschedule" in msgs):
                raise AssertionError(f"p2p {what}: the scheduler saw {sched}")
            want_rehash = {"skipped": int(what == "digest"), "hashed": 0}
            if r["rehash"] != want_rehash:
                raise AssertionError(f"p2p {what}: completion re-hash "
                                     f"{r['rehash']}, want {want_rehash}")
            if _on_card(device) and r["launches"] != {
                    "chunk_checksums": 2, "land_and_checksum": k2,
                    "gear_candidates": 0}:
                raise AssertionError(f"p2p {what}: launches {r['launches']}, "
                                     f"want K1 2, K2 {k2}")
        store = d.storage.find_completed_task(out["digest"]["task_id"])
        t0 = time.perf_counter()
        got = store.validate_digest(sha)
        validate_s = time.perf_counter() - t0
        if got != sha or store.metadata.digest != sha:
            raise AssertionError(f"p2p digest: the child's store holds {got}")
        for what in ("plain", "digest"):
            if out[what]["tenant_bytes"] != {"default": content.size,
                                             "trainer": 0}:
                raise AssertionError(f"p2p {what}: the parent served by "
                                     f"tenant {out[what]['tenant_bytes']}")
        launches = {k: sum(out[w]["launches"][k] for w in ("plain", "digest"))
                    for k in out["plain"]["launches"]}

        # The gated pull, from a fresh child: the first one's stores go.
        store = None
        d.close()
        d = None
        shutil.rmtree(os.path.join(tmp, "child"))
        gate = WFQGate(2 * PIECE_WORKERS)
        d = StandInDaemon(os.path.join(tmp, "child2"), device,
                          scheduler=info["scheduler"], wfq=gate)
        host = torch.from_numpy(content).to(device)
        gated = asyncio.run(_p2p_gated(d, info["url"], parent, host, gate,
                                       device))
        del host
        if not gated["equal"] or gated["bytes"] != content.size:
            raise AssertionError(f"p2p gated: landed bytes differ {gated}")
        if (gated["origin"] or gated["upload_bytes"] != content.size
                or gated["tenant_bytes"] != {"default": 0,
                                             "trainer": content.size}
                or gated["tenant"] != "trainer"):
            raise AssertionError(f"p2p gated: the parent saw {gated}")
        if (gated["gate_active"] != 0 or gated["grants"]["normal"] < 1
                or gated["grants"]["interactive"]
                or gated["grants"]["background"]):
            raise AssertionError(f"p2p gated: the gate {gated}")
        if _on_card(device) and gated["launches"] != {
                "chunk_checksums": 2, "land_and_checksum": k2,
                "gear_candidates": 0}:
            raise AssertionError(f"p2p gated: launches {gated['launches']}, "
                                 f"want K1 2, K2 {k2}")
        return {**out, "launches": launches, "sha256": sha,
                "validated": got, "validate_s": validate_s,
                "parent_fetch_s": info["fetch_s"], "pieces": n_pieces,
                "want_k2": 2 * k2, "gated": gated}
    finally:
        if d is not None:
            d.close()
        if parent is not None:
            parent.close()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# PEX: the shard pulled with no scheduler anywhere. A holder daemon in a
# process of its own gossips its task over UDP (a shared secret); the
# measured child finds it (PeerExchange) -> TaskManager._pex_download ->
# PieceTaskSynchronizer -> PieceDispatcher -> pull_one_piece ->
# LocalTaskStore -> DeviceSinkManager (K2) -> finalize (K1)
# --------------------------------------------------------------------- #

PEX_SECRET = "chip-smoke-pod"


async def _pex_request(data_dir: str, info: dict, holder: P2PParent,
                       host: torch.Tensor, spans: dict, layout,
                       device) -> dict:
    """The measured child: the port's ``TaskManager`` with no scheduler
    and a ``PeerExchange`` seeded with the holder, its download service on
    loopback. Gossip starts, the holder is found, then ``Daemon.Download``
    (``device: "tpu"``, ``disable_back_source``) pulls every piece from
    it; the verified buffer is taken from the sink manager, gated by K1
    and held to every byte and tensor."""
    url = info["url"]
    pex = PeerExchange(ip=P2P_HOST, secret=PEX_SECRET)
    d = StandInDaemon(data_dir, device, pex=pex)
    cli = await d.serve_download()
    sinks = d.device_sinks
    task_id = FileTaskRequest(url=url, output="").task_id()
    try:
        t0 = time.perf_counter()
        await pex.start(0, [info["pex"]])
        deadline = time.monotonic() + 30.0
        while not pex.find_holders(task_id):
            if time.monotonic() > deadline:
                raise AssertionError("pex: gossip found no holder in 30 s")
            await asyncio.sleep(0.001)
        found_s = time.perf_counter() - t0
        holders = [(m.ip, m.peer_port, m.upload_port)
                   for m in pex.find_holders(task_id)]
        await asyncio.sleep(0)
        sinks.reset()
        before = holder.stats()
        _sync(device)
        base = _memory_mark(device)
        zero_launches()
        t0 = time.perf_counter()
        stream = await cli.open_stream("Daemon.Download", {
            "url": url, "device": "tpu", "disable_back_source": True})
        frames = []
        while (msg := await stream.recv(timeout=600.0)) is not None:
            frames.append(msg)
        last = frames[-1]
        if (last["state"] != "done" or not last["from_p2p"]
                or not last["device_verified"]):
            raise AssertionError(f"pex: the download ended {last}")
        sink = sinks.take(task_id)
        u8 = sink.as_bytes_array()
        verify_u8_against_host(u8, sink.sink.piece_size,
                               sink.sink.host_checksums)
        tensors = load_from_sink(sink)
        _sync(device)
        wall = time.perf_counter() - t0
        peak = _memory_mark(device, peak=True) - base
        launches = checksum.launch_counts()
        after = holder.stats()
        if not torch.equal(u8, host):
            raise AssertionError("pex: landed bytes differ from the shard")
        if set(tensors) != {n for n, _ in layout}:
            raise AssertionError(f"pex: tensors {sorted(tensors)}")
        for name, t in tensors.items():
            b, e = spans[name]
            if t.dtype != torch.bfloat16 or not torch.equal(
                    t.reshape(-1).view(torch.uint8), host[b:e]):
                raise AssertionError(f"pex: {name} differs from the shard")
        n_pieces = compute_piece_count(host.numel(),
                                       compute_piece_size(host.numel()))
        fl = await flight_summary(cli, d.task_manager, task_id, n_pieces)
        # Every piece asked of the holder's upload server: the PEX pull
        # ran (with no scheduler, from_p2p comes from it alone).
        requests = [note for _t, code, _p, _a, note
                    in d.task_manager.flight.get(task_id).events()
                    if code == flight.EV_REQUEST]
        out = {"task_id": task_id, "bytes": int(u8.numel()),
               "tensors": len(tensors), "frames": len(frames),
               "from_p2p": last["from_p2p"], "holders": holders,
               "gossip_to_holder_s": found_s, "wall_s": wall,
               "launches": launches, "peak_device_bytes": peak,
               "origin": _origin_delta(before["origin"], after["origin"]),
               "upload_bytes": after["upload_bytes"] - before["upload_bytes"],
               "upload_requests": after["upload_requests"]
               - before["upload_requests"],
               "piece_requests": len(requests),
               "requested_from": sorted(set(requests)),
               "land_s": sinks.finalized - sinks.first,
               "sink_busy_s": sinks.busy_s - sinks.busy_from,
               "holder_cpu_s": after["cpu_s"] - before["cpu_s"],
               "conductors": len(d.conductors), "flight": fl,
               **{key: getattr(sink.sink, key) for key in (
                   "host_checksum_s", "stage_s", "stage_wait_s")}}
        tensors = sink = u8 = None
        return out
    finally:
        await cli.close()
        await d.rpc.close()
        await pex.stop()
        d.close()


def phase_pex(content: np.ndarray, spans: dict, layout,
              device: torch.device) -> dict:
    """The shard pulled over PEX with no scheduler anywhere: a holder
    (``P2PParent`` with a ``PeerExchange``, its one task fetched from its
    own stand-in origin) in a process of its own, the measured child in
    this one (``_pex_request``). Checks every byte and tensor, that the
    child's pull went through ``_pex_download`` (from_p2p, no conductor,
    every piece requested of the holder's upload server, its bytes served
    once), no origin request, the flight, and the launches."""
    tmp = tempfile.mkdtemp(prefix="df-chip-pex-")
    holder = None
    try:
        # The origin's file, the holder's store and the child's, with a
        # GiB to spare.
        need = 3 * content.size + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(
                f"the pex phase needs {need} B free under {tmp} (the "
                f"origin's file and two stores); {free} B are")
        path = os.path.join(tmp, GATEWAY_KEY)
        content.tofile(path)
        holder = P2PParent(path, os.path.join(tmp, "holder"), "",
                           pex_secret=PEX_SECRET)
        holder.start()
        info = holder.endpoint()
        host = torch.from_numpy(content).to(device)
        out = asyncio.run(_pex_request(os.path.join(tmp, "child"), info,
                                       holder, host, spans, layout, device))
        del host
        n_pieces = compute_piece_count(content.size,
                                       compute_piece_size(content.size))
        k2 = -(-n_pieces // BATCH_PIECES)
        if out["origin"]:
            raise AssertionError(f"pex: origin saw {out['origin']}")
        if out["upload_bytes"] != content.size or out["conductors"] != 0:
            raise AssertionError(
                f"pex: the holder served {out['upload_bytes']} B, "
                f"{out['conductors']} conductors")
        if (out["piece_requests"] != n_pieces
                or out["requested_from"] != sorted(
                    {f"{ip}:{up}" for ip, _pp, up in out["holders"]})
                or not out["from_p2p"]):
            raise AssertionError(f"pex: {out['piece_requests']} piece "
                                 f"requests to {out['requested_from']}")
        if _on_card(device) and out["launches"] != {
                "chunk_checksums": 2, "land_and_checksum": k2,
                "gear_candidates": 0}:
            raise AssertionError(f"pex: launches {out['launches']}, want "
                                 f"K1 2, K2 {k2}")
        return {**out, "holder_fetch_s": info["fetch_s"][0],
                "pieces": n_pieces, "want_k2": k2}
    finally:
        if holder is not None:
            holder.close()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# The swarm: the port's own scheduler (scheduler/) in a process of its
# own picks the parents of a small swarm of the port's daemons: a seed
# daemon in a process of its own, triggered by the scheduler, and
# children in this process landing on the card. Fan-out (the seed
# trigger, a child on a running parent) and the striped slice broadcast
# --------------------------------------------------------------------- #

SWARM_SLICE = "chip-swarm-slice"
SWARM_QUARTER_KEY = "swarm-quarter/" + GATEWAY_KEY


def swarm_origin_objects(path: str) -> dict:
    """The swarm's origin: the shard's file, mapped, and its first quarter
    of bytes as a second object (a view of the same mapping)."""
    data = origin_objects(path)[(ORIGIN_BUCKET, GATEWAY_KEY)]
    quarter = memoryview(data)[:len(data) // 4]
    return {(ORIGIN_BUCKET, GATEWAY_KEY): data,
            (ORIGIN_BUCKET, SWARM_QUARTER_KEY): quarter}


def swarm_scheduler_config() -> dict:
    """The port's scheduler on loopback, its defaults otherwise (the
    fleet observatory fed from every report, as the JAX defaults have
    it): the pod lens off (as the swarm has run since it was added; the
    observe path reads it), no metrics server, no GC pass during the
    run."""
    return {"server": {"host": P2P_HOST, "port": 0},
            "podlens": {"enabled": False},
            "metrics_port": -1, "gc": {"interval": 3600.0}}


def swarm_daemon_config(root: str, name: str, scheduler: str, *,
                        seed: bool = False, tpu_slice: str = "",
                        worker: int = -1, sink: bool = False) -> dict:
    """A swarm daemon's config: its own work home, socket and ports on
    loopback, the scheduler's address; a seed announces as a super seed
    and lands nothing on the card unless ``sink`` (the manager's preheat
    target), a child lands on it at the main path's batch."""
    home = os.path.join(root, name)
    d = {"work_home": home,
         "host": {"hostname": f"chip-swarm-{name}", "ip": P2P_HOST,
                  "tpu_slice": tpu_slice, "tpu_worker_index": worker},
         "download": {"unix_sock": os.path.join(home, "d.sock")},
         "scheduler": {"addrs": [scheduler]},
         "metrics_port": -1, "gc_interval": 3600.0}
    if seed:
        d["seed_peer"] = True
    if sink or not seed:
        d["tpu_sink"] = {"enabled": True, "batch_pieces": BATCH_PIECES}
    return d


def _swarm_child(conn, role: str, args: tuple) -> None:
    """The body of a ``SwarmProcess``: the port's ``SchedulerServer``
    (``role`` "scheduler"; with a manager's drpc address in ``args``,
    registered with it), its ``ManagerServer`` ("manager") or a seed
    ``Daemon`` ("seed") on an event loop of its own thread, then answers
    to the measured process until told to stop. A start that raises
    sends its traceback instead of the endpoint."""
    from dragonfly2_tpu_torch.manager import ManagerConfig, ManagerServer
    from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
    from dragonfly2_tpu_torch.scheduler.server import SchedulerServer

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever,
                              name=f"df-swarm-{role}", daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result()

    server = daemon = manager = None
    try:
        try:
            if role == "scheduler":
                cfg = swarm_scheduler_config()
                if args:
                    cfg.update(manager_addr=args[0],
                               manager_keepalive_interval=1.0)
                server = SchedulerServer(SchedulerConfig.from_dict(cfg))
                run(server.start())
                conn.send({"addr": f"{P2P_HOST}:{server.port()}"})
            elif role == "manager":
                manager = ManagerServer(ManagerConfig.from_dict(
                    manager_config()))
                run(manager.start())
                conn.send({"rest": manager.rest_port,
                           "grpc": f"{P2P_HOST}:{manager.grpc_port()}"})
            else:
                root, scheduler, device = args
                daemon = Daemon(DaemonConfig.from_dict(swarm_daemon_config(
                    root, "seed", scheduler, seed=True)), device=device)
                run(daemon.start())
                conn.send({"host_id": daemon.announcer.host_id,
                           "upload_port": daemon.upload.port})
        except Exception:
            conn.send({"error": traceback.format_exc()})
            raise
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                conn.send(None)
                return
            if msg[0] == "hosts":
                # Pieces served by each host, as the reports' parents
                # booked them at the scheduler.
                conn.send({h.id: {"upload_count": h.upload_count,
                                  "type": int(h.type)}
                           for h in server.service.hosts.all()})
            else:
                conn.send({"upload_bytes": UPLOAD_BYTES.value(),
                           "upload_requests": UPLOAD_REQUESTS.value("ok"),
                           "cpu_s": time.process_time()})
    finally:
        if server is not None:
            run(server.stop())
        if daemon is not None:
            run(daemon.stop())
        if manager is not None:
            run(manager.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)


class SwarmProcess(StandInProcess):
    """The swarm's scheduler, manager or seed in a process of its own
    (spawned), as each is another host; ``endpoint()`` waits for it to
    serve and gives what it serves (the scheduler's address; the
    manager's REST port and drpc address; the seed's host id and upload
    port), or raises with the child's traceback, ``stats()`` the seed's
    upload counters, ``hosts()`` the scheduler's pieces served by host."""

    def __init__(self, role: str, *args):
        super().__init__(None, *args)
        self._role = role

    def endpoint(self):
        if not self._conn.poll(600):
            raise RuntimeError(f"the swarm's {self._role} process did not "
                               f"start")
        try:
            got = self._conn.recv()
        except EOFError:
            raise RuntimeError(f"the swarm's {self._role} process ended "
                               f"before it served (exit code "
                               f"{self._proc.exitcode})") from None
        if isinstance(got, dict) and "error" in got:
            raise RuntimeError(f"the swarm's {self._role} process failed "
                               f"to start:\n{got['error']}")
        return got

    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_swarm_child,
                                 args=(child, self._role, self._args),
                                 daemon=True, name=f"df-swarm-{self._role}")
        self._proc.start()
        child.close()

    def stats(self) -> dict:
        return self._ask("stats")

    def hosts(self) -> dict:
        return self._ask("hosts")


class SwarmChild:
    """One swarm child: the port's ``Daemon`` from ``swarm_daemon_config``
    on the card, its own flight recorder (two children of one task in one
    process would otherwise share a flight), a ``SinkClock`` on its sink
    manager, and every conductor it builds kept with the scheduler answers
    it acted on (``answers``: the time, kind, parents and stripe of each;
    ``stripes``: each stripe plan applied)."""

    def __init__(self, root: str, name: str, scheduler: str, device, *,
                 config: DaemonConfig | None = None, **kw):
        self.name = name
        if config is None:
            config = DaemonConfig.from_dict(swarm_daemon_config(
                root, name, scheduler, **kw))
        self.daemon = Daemon(config, device=device)
        tm = self.daemon.task_manager
        tm.flight = flight.FlightRecorder()
        self.clock = SinkClock(tm.device_sinks)
        self.answers: list[dict] = []
        self.stripes: list = []
        self.conductors: list = []
        make = tm.conductor_factory

        def factory(**kw):
            c = make(**kw)
            self.conductors.append(c)
            dispatch, apply_stripe = c._dispatch_schedule, c._apply_stripe

            async def recorded_dispatch(msg):
                self.answers.append({
                    "t": time.perf_counter(), "type": msg.get("type"),
                    "parents": [p["id"] for p in msg.get("parents") or []],
                    "stripe": msg.get("stripe")})
                return await dispatch(msg)

            def recorded_stripe(stripe):
                self.stripes.append(None if not stripe else {
                    k: stripe[k] for k in ("slice_size", "slice_rank",
                                           "members")})
                return apply_stripe(stripe)

            c._dispatch_schedule, c._apply_stripe = (recorded_dispatch,
                                                     recorded_stripe)
            return c

        # A daemon that finds its scheduler through a manager builds its
        # conductors only at start: nothing to record then.
        if make is not None:
            tm.conductor_factory = factory

    async def start(self) -> None:
        await self.daemon.start()
        self.cli = Client(NetAddr.unix(self.daemon.config.unix_sock))

    @property
    def host_id(self) -> str:
        return self.daemon.announcer.host_id

    async def download(self, body: dict) -> dict:
        """``Daemon.Download`` over the child's socket; the last frame,
        with the perf_counter time it arrived."""
        stream = await self.cli.open_stream("Daemon.Download", body)
        frames = []
        while (msg := await stream.recv(timeout=600.0)) is not None:
            frames.append(msg)
        return {**frames[-1], "t_done": time.perf_counter()}

    def registration(self, task_id: str) -> dict:
        """Register to the first ``normal_task`` in the child's flight,
        and the flight's ``sched_wait`` fold."""
        tf = self.daemon.task_manager.flight.get(task_id)
        events = tf.events()
        reg = next(t for t, code, *_ in events if code == flight.EV_REGISTER)
        first = next(t for t, code, _p, _a, note in events
                     if code in (flight.EV_SCHEDULED, flight.EV_SCHED_PUSH)
                     and note == "normal_task")
        return {"register_to_normal_task_s": first - reg,
                "sched_wait_s": flight.analyze(tf)["phases"]["sched_wait"]}

    def take_and_gate(self, task_id: str, host: torch.Tensor) -> dict:
        """The child's verified buffer taken from its sink manager, gated
        by K1 and held to every byte of ``host``; the sink is released."""
        sink = self.daemon.task_manager.device_sinks.take(task_id)
        u8 = sink.as_bytes_array()
        verify_u8_against_host(u8, sink.sink.piece_size,
                               sink.sink.host_checksums)
        equal = bool(torch.equal(u8, host))
        sinks = self.daemon.task_manager.device_sinks
        return {"bytes": int(u8.numel()), "equal": equal,
                "land_s": self.clock.finalized - self.clock.first,
                "sink_busy_s": sinks.busy_s - self.clock.busy_from,
                "host_checksum_s": sink.sink.host_checksum_s,
                "stage_s": sink.sink.stage_s,
                "pieces_landed": self.clock.pieces}

    async def stop(self) -> None:
        await self.cli.close()
        await self.daemon.stop()


def seed_origin_reads(size: int) -> dict:
    """The origin's reads for one back-to-source fetch of ``size`` bytes
    by a daemon of the default config: a 1-byte probe, then one ranged
    GET a piece group, or one whole GET under the concurrent minimum."""
    opt = DaemonConfig().download
    if size < opt.concurrent_min_length:
        return {"get_range": [1, 1], "get": [1, size]}
    groups = min(opt.piece_concurrency,
                 compute_piece_count(size, compute_piece_size(size)))
    return {"get_range": [1 + groups, 1 + size]}


def _scheduler_client(addr: str) -> Client:
    ip, port = addr.rsplit(":", 1)
    return Client(NetAddr.tcp(ip, int(port)))


async def _swarm_scheduler_view(addr: str, task_id: str) -> dict:
    """``Scheduler.StatTask`` and ``Scheduler.ListHosts`` over the port's
    drpc."""
    cli = _scheduler_client(addr)
    try:
        return {"stat_task": await cli.call("Scheduler.StatTask",
                                            {"task_id": task_id},
                                            timeout=10.0),
                "hosts": (await cli.call("Scheduler.ListHosts", {},
                                         timeout=10.0))["hosts"]}
    finally:
        await cli.close()


def _check_download(what: str, last: dict) -> None:
    if (last["state"] != "done" or not last["from_p2p"]
            or not last["device_verified"]):
        raise AssertionError(f"swarm {what}: the download ended {last}")


async def _swarm_fanout(root: str, sched: SwarmProcess, addr: str, url: str,
                        sha: str, host: torch.Tensor, gw: StandInProcess,
                        seed: SwarmProcess, device) -> dict:
    """Fan-out: child 1 pulls the shard (with its sha256) onto the card;
    the scheduler triggers the seed and hands it out. Child 2 registers
    once child 1 has landed a quarter of its pieces, so a running parent
    can be handed to it. Both buffers are taken, gated by K1, held to
    every byte and released."""
    n_pieces = compute_piece_count(host.numel(),
                                   compute_piece_size(host.numel()))
    kids = [SwarmChild(root, name, addr, device) for name in ("c1", "c2")]
    for c in kids:
        await c.start()
    c1, c2 = kids
    body = {"url": url, "device": "tpu", "meta": {"digest": sha}}
    task_id = FileTaskRequest(url=url, output="",
                              meta=UrlMeta(digest=sha)).task_id()
    try:
        origin0, seed0 = gw.requests(), seed.stats()
        uploads0, hosts0 = UPLOAD_BYTES.value(), sched.hosts()
        rehash0 = {r: COMPLETION_REHASH.value(r)
                   for r in ("skipped", "hashed")}
        t0 = time.perf_counter()
        first = asyncio.ensure_future(c1.download(dict(body)))
        while c1.clock.pieces < n_pieces // 4:
            if first.done():
                raise AssertionError(f"swarm: child 1 ended before a "
                                     f"quarter of its pieces landed: "
                                     f"{first.result()}")
            await asyncio.sleep(0.002)
        t_c2 = time.perf_counter()
        at_c2 = c1.clock.pieces
        second = asyncio.ensure_future(c2.download(dict(body)))
        last1, last2 = await asyncio.gather(first, second)
        wall = time.perf_counter() - t0
        _check_download("fan-out child 1", last1)
        _check_download("fan-out child 2", last2)
        out = {"task_id": task_id, "wall_s": wall,
               "c2_registered_after_s": t_c2 - t0,
               "c1_pieces_at_c2": at_c2, "children": {}}
        for c in kids:
            out["children"][c.name] = {
                **c.take_and_gate(task_id, host), **c.registration(task_id),
                "host_id": c.host_id,
                "upload_addr": f"{P2P_HOST}:{c.daemon.upload.port}",
                "answers": [{k: a[k] for k in ("type", "parents")}
                            for a in c.answers]}
        out["rehash"] = {r: COMPLETION_REHASH.value(r) - v
                         for r, v in rehash0.items()}
        out["c2_last_piece_to_finalize_s"] = (c2.clock.finalized
                                              - c2.clock.last_piece)
        # Child 2's first handout, and whether child 1 was in it while
        # child 1 was still downloading.
        a2 = next(a for a in c2.answers if a["type"] == "normal_task")
        c1_peer = c1.conductors[0].peer_id
        out["c2_handout"] = a2["parents"]
        out["c2_handed_running_c1"] = (c1_peer in a2["parents"]
                                       and a2["t"] < last1["t_done"])
        out["origin"] = _origin_delta(origin0, gw.requests())
        out["seed_upload_bytes"] = (seed.stats()["upload_bytes"]
                                    - seed0["upload_bytes"])
        # Both children serve from this process: the counter is theirs
        # together (child 2 has no later registrant to serve).
        out["children_upload_bytes"] = UPLOAD_BYTES.value() - uploads0
        hosts1 = sched.hosts()
        out["pieces_served_by_host"] = {
            h: v["upload_count"] - hosts0.get(h, {}).get("upload_count", 0)
            for h, v in hosts1.items()}
        out.update(await _swarm_scheduler_view(addr, task_id))
        out["n_pieces"] = n_pieces
        return out
    finally:
        for c in kids:
            await c.stop()


async def _swarm_stripe(root: str, sched: SwarmProcess, addr: str, url: str,
                        host: torch.Tensor, gw: StandInProcess,
                        seed: SwarmProcess, device) -> dict:
    """The striped slice broadcast: two fresh children on one
    ``tpu_slice`` pull the quarter object with ``pod_broadcast`` at once;
    each is handed the seed and a stripe plan, pulls its stripe from the
    seed and the rest from its mate. Both buffers taken, gated and held
    to every byte."""
    kids = [SwarmChild(root, f"s{i}", addr, device, tpu_slice=SWARM_SLICE,
                       worker=i) for i in range(2)]
    for c in kids:
        await c.start()
    body = {"url": url, "device": "tpu", "pod_broadcast": True}
    task_id = FileTaskRequest(url=url, output="").task_id()
    try:
        origin0, seed0 = gw.requests(), seed.stats()
        t0 = time.perf_counter()
        lasts = await asyncio.gather(*[c.download(dict(body)) for c in kids])
        wall = time.perf_counter() - t0
        for c, last in zip(kids, lasts):
            _check_download(f"stripe {c.name}", last)
        out = {"task_id": task_id, "wall_s": wall, "children": {}}
        for c in kids:
            out["children"][c.name] = {
                **c.take_and_gate(task_id, host), **c.registration(task_id),
                "host_id": c.host_id,
                "upload_addr": f"{P2P_HOST}:{c.daemon.upload.port}",
                "stripes": c.stripes}
        out["origin"] = _origin_delta(origin0, gw.requests())
        out["seed_upload_bytes"] = (seed.stats()["upload_bytes"]
                                    - seed0["upload_bytes"])
        out.update(await _swarm_scheduler_view(addr, task_id))
        return out
    finally:
        for c in kids:
            await c.stop()


def phase_swarm(content: np.ndarray, device: torch.device) -> dict:
    """The port's scheduler picks the card's parents. In processes of
    their own: the scheduler (``SchedulerServer``), the origin (the
    shard's file and its first quarter) and a seed daemon
    (``seed_peer``, no device sink); in this one, children landing on the
    card. Fan-out (``_swarm_fanout``), then, the fan-out's children
    stopped and their stores removed, the stripe (``_swarm_stripe``).
    Checks: the seed triggered and handed out, the origin served each
    object once, every buffer verified and held to every byte, the task
    succeeded with 3 peers at the scheduler and ListHosts shows the seed,
    child 2 handed the running child 1, each stripe child received a plan
    of 2 and the seed served near one copy of the quarter, and the
    launches."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="df-chip-swarm-")
    procs = []
    try:
        # The origin's file, the seed's stores (the shard and its
        # quarter) and two children's stores at a time, with a GiB to
        # spare.
        need = 4 * content.size + content.size // 4 + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(f"the swarm phase needs {need} B free under "
                               f"{tmp}; {free} B are")
        path = os.path.join(tmp, GATEWAY_KEY)
        content.tofile(path)
        t0 = time.perf_counter()
        sha = "sha256:" + hashlib.sha256(memoryview(content)).hexdigest()
        gw = StandInProcess(swarm_origin_objects, path)
        sched = SwarmProcess("scheduler")
        for p in (gw, sched):
            p.start()
            procs.append(p)
        endpoint = gw.endpoint()
        addr = sched.endpoint()["addr"]
        seed = SwarmProcess("seed", os.path.join(tmp, "seed-home"), addr,
                            str(device))
        seed.start()
        procs.append(seed)
        seed_info = seed.endpoint()
        start_s = time.perf_counter() - t0
        url = f"{endpoint}/buckets/{ORIGIN_BUCKET}/objects/{GATEWAY_KEY}"
        quarter_url = (f"{endpoint}/buckets/{ORIGIN_BUCKET}/objects/"
                       f"{SWARM_QUARTER_KEY}")
        quarter = content.size // 4
        host = torch.from_numpy(content).to(device)
        zero_launches()
        fan = asyncio.run(_swarm_fanout(os.path.join(tmp, "fanout"), sched,
                                        addr, url, sha, host, gw, seed,
                                        device))
        shutil.rmtree(os.path.join(tmp, "fanout"), ignore_errors=True)
        host = host[:quarter]
        stripe = asyncio.run(_swarm_stripe(os.path.join(tmp, "stripe"),
                                           sched, addr, quarter_url, host,
                                           gw, seed, device))
        _sync(device)
        launches = checksum.launch_counts()
        del host
    finally:
        for p in reversed(procs):
            p.close()
        shutil.rmtree(tmp, ignore_errors=True)
    n_full = fan["n_pieces"]
    n_quarter = compute_piece_count(quarter, compute_piece_size(quarter))
    for what, r, size in (("fan-out", fan, content.size),
                          ("stripe", stripe, quarter)):
        if r["origin"] != seed_origin_reads(size):
            raise AssertionError(f"swarm {what}: origin saw {r['origin']}, "
                                 f"want {seed_origin_reads(size)}")
    seed_id = seed_info["host_id"]
    for what, r, n in (("fan-out", fan, n_full), ("stripe", stripe,
                                                  n_quarter)):
        for name, c in r["children"].items():
            if not c["equal"] or c["pieces_landed"] != n:
                raise AssertionError(f"swarm {what} {name}: {c}")
        st = r["stat_task"]
        if (st["state"], st["peer_count"]) != ("succeeded", 3):
            raise AssertionError(f"swarm {what}: StatTask {st}")
        hosts = {h["id"]: h["type"] for h in r["hosts"]}
        want_hosts = {seed_id, *(c["host_id"]
                                 for c in r["children"].values())}
        if set(hosts) != want_hosts or hosts[seed_id] != 1:
            raise AssertionError(f"swarm {what}: ListHosts {hosts}")
    # The seed was triggered by the scheduler and handed out: child 1's
    # first answer names the seed's peer.
    c1 = fan["children"]["c1"]
    if c1["answers"][0]["type"] != "normal_task" or not any(
            pid.endswith("_Seed") for pid in c1["answers"][0]["parents"]):
        raise AssertionError(f"swarm: child 1 was answered "
                             f"{c1['answers']}")
    # Every byte each child landed came from a peer: the seed and the
    # children served at least two copies together.
    if fan["seed_upload_bytes"] + fan["children_upload_bytes"] < \
            2 * content.size:
        raise AssertionError(
            f"swarm fan-out: the seed served {fan['seed_upload_bytes']} B "
            f"and the children {fan['children_upload_bytes']} B, less than "
            f"{2 * content.size} B together")
    # One completion decision a child (skipped when a done parent's
    # digests certified it, else hashed).
    if sum(fan["rehash"].values()) != 2:
        raise AssertionError(f"swarm fan-out: completion re-hashes "
                             f"{fan['rehash']}")
    for name, c in stripe["children"].items():
        plans = [p for p in c["stripes"] if p]
        if not plans or plans[-1]["slice_size"] != 2:
            raise AssertionError(f"swarm stripe {name}: plans {c['stripes']}")
    ranks = sorted(c["stripes"][-1]["slice_rank"]
                   for c in stripe["children"].values())
    if ranks != [0, 1]:
        raise AssertionError(f"swarm stripe: ranks {ranks}")
    stripe["seed_bytes_over_content"] = stripe["seed_upload_bytes"] / quarter
    if stripe["seed_bytes_over_content"] >= 1.5:
        raise AssertionError(
            f"swarm stripe: the seed served {stripe['seed_upload_bytes']} B "
            f"for a {quarter} B object (two unstriped children draw 2x)")
    k2 = 2 * -(-n_full // BATCH_PIECES) + 2 * -(-n_quarter // BATCH_PIECES)
    if _on_card(device) and launches != {"chunk_checksums": 8,
                                         "land_and_checksum": k2,
                                         "gear_candidates": 0}:
        raise AssertionError(f"swarm: launches {launches}, want K1 8, "
                             f"K2 {k2}")
    return {"fanout": fan, "stripe": stripe, "launches": launches,
            "want_k2": k2, "start_s": start_s,
            "phase_s": time.perf_counter() - t_phase,
            "quarter_bytes": quarter,
            "seed_host": seed_id, "quarter_pieces": n_quarter}


def swarm_lines(swm: dict, content_bytes: int) -> list[str]:
    """The swarm phase's printed lines."""
    fan, stripe = swm["fanout"], swm["stripe"]
    c1, c2 = fan["children"]["c1"], fan["children"]["c2"]
    origin = fan["origin"].get("get_range", [0, 0])
    out = [
        f"swarm fan-out: the port's scheduler triggered the seed and "
        f"handed it to child 1 ({len(c1['answers'][0]['parents'])} parent); "
        f"the origin served {origin[0]} GETs, {origin[1]} B for a "
        f"{content_bytes} B shard; child 2 registered "
        f"{fan['c2_registered_after_s']:.3f} s in, at child 1's "
        f"{fan['c1_pieces_at_c2']} of {fan['n_pieces']} pieces, and was "
        f"handed {len(fan['c2_handout'])} parents, the running child 1 "
        f"{'among them' if fan['c2_handed_running_c1'] else 'NOT among them'}"
        f"; registration (register -> first normal_task): child 1 "
        f"{c1['register_to_normal_task_s'] * 1e3:.3f} ms (sched_wait "
        f"{c1['sched_wait_s'] * 1e3:.3f} ms), child 2 "
        f"{c2['register_to_normal_task_s'] * 1e3:.3f} ms (sched_wait "
        f"{c2['sched_wait_s'] * 1e3:.3f} ms); "
        f"land_s child 1 {c1['land_s']:.4f} s (its sink worker busy "
        f"{c1['sink_busy_s']:.4f} s), child 2 {c2['land_s']:.4f} s (busy "
        f"{c2['sink_busy_s']:.4f} s), both in this process; both buffers "
        f"verified by K1 and equal to the shard; wall {fan['wall_s']:.3f} s; "
        f"the phase {swm['phase_s']:.1f} s, of it {swm['start_s']:.1f} s "
        f"writing the origin's file, its sha256 and the three processes' "
        f"start",
        f"swarm fan-out uploads: the seed {fan['seed_upload_bytes']:.0f} B "
        f"(its process's upload_bytes_total), the children "
        f"{fan['children_upload_bytes']:.0f} B (this process's); pieces "
        f"served by host at the scheduler "
        f"{json.dumps(fan['pieces_served_by_host'])}; child 2's last piece "
        f"to finalize (the certification wait) "
        f"{fan['c2_last_piece_to_finalize_s']:.4f} s, "
        f"peer_completion_rehash_total over both children "
        f"{json.dumps(fan['rehash'])}; StatTask {fan['stat_task']['state']} "
        f"with {fan['stat_task']['peer_count']} peers; ListHosts "
        f"{len(fan['hosts'])} hosts, types "
        f"{sorted(h['type'] for h in fan['hosts'])}",
        f"swarm stripe: two children on one slice pulled the "
        f"{swm['quarter_bytes']} B quarter with pod_broadcast; plans "
        + "; ".join(f"{name} {c['stripes'][-1]['slice_rank']} of "
                    f"{c['stripes'][-1]['slice_size']} ({len(c['stripes'])} "
                    f"applied), land_s {c['land_s']:.4f} s, register -> "
                    f"normal_task {c['register_to_normal_task_s'] * 1e3:.3f} "
                    f"ms" for name, c in stripe["children"].items())
        + f"; the seed served {stripe['seed_upload_bytes']:.0f} B = "
        f"{stripe['seed_bytes_over_content']:.3f}x the object; StatTask "
        f"{stripe['stat_task']['state']} with "
        f"{stripe['stat_task']['peer_count']} peers; K2 "
        f"{swm['launches']['land_and_checksum']}, K1 "
        f"{swm['launches']['chunk_checksums']} over both sub-cases"]
    return out


# --------------------------------------------------------------------- #
# The manager's preheat: a job posted to the port's manager over REST
# reaches the port's scheduler through the manager's job queue, and the
# scheduler's job worker triggers a seed daemon that lands the shard on
# the card (REST job -> job queue -> PollJob -> Peer.TriggerDownloadTask
# -> K2 landings -> K1 gate -> verified buffer)
# --------------------------------------------------------------------- #

MANAGER_USER = ("root", "dragonfly")
POLL_S = 0.02      # the job poll's interval


def manager_config() -> dict:
    """The port's manager on loopback, its defaults otherwise (an
    in-memory database, the default clusters and root user), no metrics
    server."""
    return {"server": {"host": P2P_HOST, "port": 0},
            "grpc": {"host": P2P_HOST, "port": 0}, "metrics_port": -1}


def rest_call(port: int, method: str, path: str, body=None,
              token: str = "") -> tuple[int, dict]:
    """One REST call to the manager on loopback: (status, JSON body)."""
    c = http.client.HTTPConnection(P2P_HOST, port, timeout=60)
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    try:
        c.request(method, path, headers=headers,
                  body=None if body is None else json.dumps(body))
        r = c.getresponse()
        return r.status, json.loads(r.read() or b"null")
    finally:
        c.close()


async def _rest(port: int, method: str, path: str, body=None,
                token: str = "") -> dict:
    status, got = await asyncio.to_thread(rest_call, port, method, path,
                                          body, token)
    if status != 200:
        raise AssertionError(f"manager preheat: {method} {path} answered "
                             f"{status} {got}")
    return got


async def _manager_preheat(root: str, rest_port: int, sched: SwarmProcess,
                           addr: str, url: str, host: torch.Tensor,
                           gw: StandInProcess, device) -> dict:
    """The seed daemon (``seed_peer`` with the device sink) announced to
    the scheduler; once the manager lists the scheduler as active and the
    scheduler holds the seed, root signs in and posts the preheat (scope
    ``all_seed_peers``, ``device: "tpu"``); the job is polled to
    ``SUCCESS``, the seed's verified buffer taken from its sink manager,
    gated by K1 and held to every byte. Launches are counted from 0 at
    the POST."""
    seed = SwarmChild(root, "seed", addr, device, seed=True, sink=True)
    await seed.start()
    tm = seed.daemon.task_manager
    task_id = FileTaskRequest(url=url, output="").task_id()
    try:
        t_wait = time.perf_counter()
        token = (await _rest(rest_port, "POST", "/api/v1/users/signin",
                             {"name": MANAGER_USER[0],
                              "password": MANAGER_USER[1]}))["token"]
        while True:
            schedulers = await _rest(rest_port, "GET", "/api/v1/schedulers",
                                     token=token)
            hosts = await asyncio.to_thread(sched.hosts)
            if (any(r["state"] == "active" for r in schedulers)
                    and hosts.get(seed.host_id, {}).get("type") == 1):
                break
            if time.perf_counter() - t_wait > 120:
                raise AssertionError(f"manager preheat: schedulers "
                                     f"{schedulers}, hosts {hosts}")
            await asyncio.sleep(0.05)
        registered_s = time.perf_counter() - t_wait
        seed.clock.reset()
        origin0 = gw.requests()
        failures0 = [SEED_DEVICE_FAILURES.value(r)
                     for r in ("device", "kernel")]
        _sync(device)
        zero_launches()
        t0 = time.perf_counter()
        job = await _rest(rest_port, "POST", "/api/v1/jobs", {
            "type": "preheat",
            "args": {"type": "file", "url": url, "scope": "all_seed_peers",
                     "device": "tpu", "timeout": 600.0}}, token=token)
        polls = 0
        while True:
            row = await _rest(rest_port, "GET", f"/api/v1/jobs/{job['id']}",
                              token=token)
            polls += 1
            if row["state"] == "SUCCESS":
                t_success = time.perf_counter()
                break
            if row["state"] == "FAILURE" or time.perf_counter() - t0 > 600:
                raise AssertionError(f"manager preheat: the job ended {row}")
            # Each poll is Python work on this process's interpreter
            # beside the seed's sink worker: 50 a second, not more.
            await asyncio.sleep(POLL_S)
        await _until_seeded(tm, seed.clock, task_id)
        gate = seed.take_and_gate(task_id, host)
        _sync(device)
        t_verified = time.perf_counter()
        launches = checksum.launch_counts()
        return {"task_id": task_id, "job": row, "gate": gate,
                "registered_s": registered_s,
                "post_to_success_s": t_success - t0,
                "post_to_verified_s": t_verified - t0, "polls": polls,
                "launches": launches,
                "device_failures": [
                    SEED_DEVICE_FAILURES.value(r) - f
                    for r, f in zip(("device", "kernel"), failures0)],
                "origin": _origin_delta(origin0, gw.requests()),
                "seed_host": seed.host_id}
    finally:
        await seed.stop()


def phase_manager_preheat(content: np.ndarray, device: torch.device) -> dict:
    """A preheat job through the port's manager onto the card. In
    processes of their own: the origin (the shard's file), the port's
    ``ManagerServer`` and its ``SchedulerServer`` with ``manager_addr`` at
    that manager; in this one, the seed daemon with the device sink
    (``_manager_preheat``). Checks: every byte of the verified buffer,
    K2 once a batch and K1 twice in the gate, no device-copy failure, the
    origin served the shard once, and the job's result names one target,
    triggered and succeeded."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="df-chip-manager-")
    procs = []
    try:
        # The origin's file and the seed's store, with a GiB to spare.
        need = 2 * content.size + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(f"the manager preheat phase needs {need} B "
                               f"free under {tmp}; {free} B are")
        path = os.path.join(tmp, GATEWAY_KEY)
        t0 = time.perf_counter()
        content.tofile(path)
        gw = StandInProcess(origin_objects, path)
        mgr = SwarmProcess("manager")
        for p in (gw, mgr):
            p.start()
            procs.append(p)
        endpoint = gw.endpoint()
        minfo = mgr.endpoint()
        sched = SwarmProcess("scheduler", minfo["grpc"])
        sched.start()
        procs.append(sched)
        addr = sched.endpoint()["addr"]
        start_s = time.perf_counter() - t0
        url = f"{endpoint}/buckets/{ORIGIN_BUCKET}/objects/{GATEWAY_KEY}"
        host = torch.from_numpy(content).to(device)
        out = asyncio.run(_manager_preheat(
            os.path.join(tmp, "daemons"), minfo["rest"], sched, addr, url,
            host, gw, device))
        del host
    finally:
        for p in reversed(procs):
            p.close()
        shutil.rmtree(tmp, ignore_errors=True)
    n_pieces = compute_piece_count(content.size,
                                   compute_piece_size(content.size))
    k2 = -(-n_pieces // BATCH_PIECES)
    gate = out["gate"]
    if not gate["equal"] or gate["pieces_landed"] != n_pieces:
        raise AssertionError(f"manager preheat: the buffer {gate}")
    if out["device_failures"] != [0, 0]:
        raise AssertionError(f"manager preheat: device-copy failures "
                             f"{out['device_failures']}")
    if out["origin"] != seed_origin_reads(content.size):
        raise AssertionError(f"manager preheat: origin saw {out['origin']}, "
                             f"want {seed_origin_reads(content.size)}")
    results = out["job"]["result"]["group_results"]
    per_url = [u for r in results for u in r["preheat"]]
    if (len(results) != 1 or len(per_url) != 1
            or (per_url[0]["targets"], per_url[0]["triggered"],
                per_url[0]["succeeded"], per_url[0]["task_id"])
            != (1, 1, True, out["task_id"])):
        raise AssertionError(f"manager preheat: the job's result {results}")
    if _on_card(device) and out["launches"] != {
            "chunk_checksums": 2, "land_and_checksum": k2,
            "gear_candidates": 0}:
        raise AssertionError(f"manager preheat: launches {out['launches']}, "
                             f"want K1 2, K2 {k2}")
    return {**out, "want_k2": k2, "pieces": n_pieces, "start_s": start_s,
            "phase_s": time.perf_counter() - t_phase}


def manager_preheat_line(mp: dict, cold_s: float) -> str:
    """The manager preheat's printed line, beside the same call's cold
    back-to-source landing (``daemon``)."""
    gate, origin = mp["gate"], mp["origin"].get("get_range", [0, 0])
    ratio = mp["post_to_verified_s"] / cold_s
    return (
        f"manager preheat: POST /api/v1/jobs (preheat, all_seed_peers, "
        f"device tpu) -> job SUCCESS {mp['post_to_success_s']:.3f} s, -> "
        f"the seed's buffer verified {mp['post_to_verified_s']:.3f} s, "
        f"beside the daemon phase's cold back-to-source landing "
        f"{cold_s:.3f} s in this call ({ratio:.3f}x; PERF.md's preheat "
        f"limit 1.1x {'held' if ratio <= 1.1 else 'MISSED'}; the job "
        f"polled {mp['polls']} times, every {POLL_S * 1e3:.0f} ms); land_s "
        f"{gate['land_s']:.4f} s, the sink's worker busy "
        f"{gate['sink_busy_s']:.4f} s (host checksum "
        f"{gate['host_checksum_s']:.4f} s, staging {gate['stage_s']:.4f} s)"
        f"; the origin served {origin[0]} GETs, "
        f"{origin[1]} B; K2 {mp['launches']['land_and_checksum']}, K1 "
        f"{mp['launches']['chunk_checksums']}; device-copy failures "
        f"{sum(mp['device_failures'])}; the job's result "
        f"{json.dumps(mp['job']['result']['group_results'][0]['preheat'][0])}"
        f"; the scheduler listed active and the seed held "
        f"{mp['registered_s']:.3f} s after the seed started; the phase "
        f"{mp['phase_s']:.1f} s, of it {mp['start_s']:.1f} s writing the "
        f"origin's file and the three processes' start")


# --------------------------------------------------------------------- #
# The port's own CLI: every role a ``python -m
# dragonfly2_tpu_torch.cli.main <cmd>`` process of its own (manager,
# scheduler with the fleet on, a seed that finds its scheduler through
# the manager), a child built from the CLI's own argv mapping in this
# process that ``dfget --device tpu --no-daemon`` lands on, then a cold
# host whose ``dfget`` spawns the port's daemon, the gateway PUT
# replicated to the seed the manager lists, the cache, and the fleet
# --------------------------------------------------------------------- #

CLI = (sys.executable, "-m", "dragonfly2_tpu_torch.cli.main")
CLI_ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_SEED = "chip-cli-seed"
CLI_CHILD = "chip-cli-child"
CLI_BUCKET = "cli"
CLI_PUT_BYTES = 64 << 20
CLI_CACHE_BYTES = 1 << 20
CLI_STOP_S = 60.0        # SIGTERM to exit, for every role


def free_ports(n: int) -> list[int]:
    """``n`` distinct loopback ports free now (bound together, then
    released)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind((P2P_HOST, 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def cli_role(log_dir: str, name: str, args: list,
             env: dict | None = None) -> subprocess.Popen:
    """One role through the CLI, in a session of its own, its output in
    ``<log_dir>/<name>.log``; ``env`` added to this process's
    environment."""
    with open(os.path.join(log_dir, f"{name}.log"), "ab") as logf:
        return subprocess.Popen([*CLI, *args], cwd=CLI_ROOT, stdout=logf,
                                stderr=logf, start_new_session=True,
                                env={**os.environ, **(env or {})})


def stop_role(proc: subprocess.Popen) -> int:
    """SIGTERM, then the exit code (killed past ``CLI_STOP_S``: -9)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(CLI_STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            return -9
    return proc.returncode


async def cli_run(*args: str, timeout: float = 900.0,
                  env: dict | None = None) -> dict:
    """One CLI command to its end, off this process's loop: its exit
    code, output, errors and wall time; ``env`` added to this process's
    environment."""
    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        *CLI, *args, cwd=CLI_ROOT, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE, env={**os.environ, **(env or {})})
    try:
        out, err = await asyncio.wait_for(proc.communicate(), timeout)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise AssertionError(f"cli: {' '.join(args)} ran past {timeout} s")
    return {"rc": proc.returncode, "out": out.decode(), "err": err.decode(),
            "wall_s": time.perf_counter() - t0}


def _ran(what: str, r: dict) -> dict:
    if r["rc"] != 0:
        raise AssertionError(f"cli {what}: exit {r['rc']}\n{r['err'][-3000:]}")
    return r


def dfget_summary(err: str) -> dict:
    """The fields of dfget's ``downloaded ... reuse= p2p=
    device_verified=`` line."""
    return dfget_parts(err)[0]


def dfget_parts(err: str) -> tuple[dict, str]:
    """The fields of dfget's ``downloaded ...`` line and the text after it
    (``--pod``'s timeline)."""
    lines = err.strip().splitlines()
    at = max(i for i, line in enumerate(lines) if "downloaded " in line)
    fields = dict(re.findall(r"(\w+)=(\S+)", lines[at].split("\r")[-1]))
    return fields, "\n".join(lines[at + 1:])


async def _until(what: str, probe, timeout: float = 120.0):
    """``await probe()`` until it returns something true."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            got = await probe()
        except (DfError, OSError):
            got = None
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"cli: {what} within {timeout} s")
        await asyncio.sleep(0.1)


def _metric(text: str, name: str) -> dict:
    """``{labels: value}`` of one family in a Prometheus text body."""
    out = {}
    for m in re.finditer(rf"^{name}(\{{[^}}]*\}})? (\S+)$", text, re.M):
        out[m.group(1) or ""] = float(m.group(2))
    return out


def _http_json(port: int, path: str):
    c = http.client.HTTPConnection(P2P_HOST, port, timeout=60)
    try:
        c.request("GET", path)
        r = c.getresponse()
        body = r.read()
        if r.status != 200:
            raise AssertionError(f"cli: GET {path} answered {r.status}")
        return json.loads(body) if path != "/metrics" else body.decode()
    finally:
        c.close()


async def _cli(root: str, content: np.ndarray, url: str, gw: StandInProcess,
               device) -> dict:
    from dragonfly2_tpu_torch.cli import main as cli_main
    from dragonfly2_tpu_torch.manager.client import ManagerClient
    from dragonfly2_tpu_torch.pkg.objectstorage import new_client

    torch_device = "cuda" if _on_card(device) else "cpu"
    logs = os.path.join(root, "logs")
    os.makedirs(logs)
    rest, grpc, sched_port, sched_metrics = free_ports(4)
    maddr = f"{P2P_HOST}:{grpc}"
    saddr = f"{P2P_HOST}:{sched_port}"
    roles = {}
    out: dict = {}
    split = out["split"] = {}
    mc = ManagerClient(NetAddr.tcp(P2P_HOST, grpc))
    child = None
    try:
        # A CLI process's own start (the interpreter, the package, torch).
        out["cli_start_s"] = _ran("--help", await cli_run("--help"))["wall_s"]
        # 1. The control plane: the manager, its scheduler (no --config:
        #    the fleet on), a seed that resolves the scheduler through it.
        t0 = time.perf_counter()
        roles["manager"] = cli_role(logs, "manager", [
            "manager", "--host", P2P_HOST, "--port", str(rest),
            "--grpc-port", str(grpc), "--metrics-port", "-1"])
        async def manager_up():
            await mc.list_applications()
            return True

        await _until("the manager serving", manager_up)
        roles["scheduler"] = cli_role(logs, "scheduler", [
            "scheduler", "--host", P2P_HOST, "--port", str(sched_port),
            "--manager", maddr, "--metrics-port", str(sched_metrics)])

        async def scheduler_active():
            return any(s["port"] == sched_port and s["state"] == "active"
                       for s in await mc.list_schedulers(
                           hostname=CLI_CHILD, ip=P2P_HOST))

        await _until("the manager listing the scheduler", scheduler_active)
        seed_home = os.path.join(root, "seed")
        roles["seed"] = cli_role(logs, "seed", [
            "daemon", "--seed-peer", "--manager", maddr, "--work-home",
            seed_home, "--hostname", CLI_SEED, "--metrics-port", "-1",
            "--torch-device", torch_device])

        async def seed_host():
            hosts = await _list_hosts(saddr)
            return next((h for h in hosts if h["hostname"] == CLI_SEED
                         and h["type"] == 1), None)

        seed = await _until("the seed announced", seed_host, timeout=300)
        out["control_plane_s"] = split["control_plane"] = \
            time.perf_counter() - t0
        # The seed registered at the manager, as an operator registers one.
        await mc.update_seed_peer(hostname=CLI_SEED, ip=seed["ip"],
                                  port=seed["port"],
                                  download_port=seed["upload_port"],
                                  type="super")
        listed = await mc.list_seed_peers(1)
        if [s["hostname"] for s in listed] != [CLI_SEED]:
            raise AssertionError(f"cli: ListSeedPeers {listed}")

        # 2. A child in this process, built from the CLI's argv mapping.
        t0 = time.perf_counter()
        child_home = os.path.join(root, "child")
        cfg = cli_main.daemon_config(cli_main.build_parser().parse_args([
            "daemon", "--manager", maddr, "--device-sink",
            "--object-storage-port", "0", "--work-home", child_home,
            "--hostname", CLI_CHILD, "--metrics-port", "-1"]))
        child = SwarmChild(root, "child", "", device, config=cfg)
        await child.start()
        d = child.daemon
        members = sorted(d.scheduler_client._ring.members())
        known = [s["hostname"] for s in d._known_seed_peers()]
        if members != [saddr] or known != [CLI_SEED]:
            raise AssertionError(f"cli: the child resolved {members}, "
                                 f"seeds {known}")
        task_id = FileTaskRequest(url=url, output="").task_id()
        host = torch.from_numpy(content).to(device)
        origin0 = gw.requests()
        child.clock.reset()
        _sync(device)
        zero_launches()
        got = _ran("dfget child", await cli_run(
            "dfget", url, "--device", "tpu", "--no-daemon", "--work-home",
            child_home))
        summary = dfget_summary(got["err"])
        if (summary.get("p2p"), summary.get("device_verified")) != (
                "True", "True"):
            raise AssertionError(f"cli: the child's dfget ended {summary}")
        gate = child.take_and_gate(task_id, host)
        del host
        _sync(device)
        out["child"] = {"dfget_wall_s": got["wall_s"], "summary": summary,
                        "gate": gate, **child.registration(task_id),
                        "host_id": child.host_id}
        out["origin"] = _origin_delta(origin0, gw.requests())
        if _on_card(device):
            torch.cuda.empty_cache()
        split["child"] = time.perf_counter() - t0

        # 6 (read here, before more handouts). The fleet's decisions and
        #    host reports at the scheduler's /debug/fleet*.
        decisions = await asyncio.to_thread(
            _http_json, sched_metrics,
            f"/debug/fleet/decisions?task={task_id}&kind=handout")
        hosts_report = await asyncio.to_thread(
            _http_json, sched_metrics, "/debug/fleet/hosts")
        out["fleet"] = {"decisions": decisions["decisions"],
                        "hosts": [h["host"] for h in hosts_report["hosts"]],
                        "seed_host": seed["id"]}

        # 3. A cold host: dfget spawns the port's daemon, which resolves
        #    the scheduler through the manager and lands in its own process.
        t0 = time.perf_counter()
        cold_home = os.path.join(root, "cold")
        cold_out = os.path.join(root, "cold.bin")
        origin1 = gw.requests()
        got = _ran("dfget cold", await cli_run(
            "dfget", url, "-O", cold_out, "--device", "tpu", "--manager",
            maddr, "--work-home", cold_home, "--torch-device",
            torch_device))
        pid = int(re.search(r"spawned daemon .*pid=(\d+)",
                            got["err"]).group(1))
        alive_s = float(re.search(r"spawned daemon alive wait_s=(\S+)",
                                  got["err"]).group(1))
        summary = dfget_summary(got["err"])
        spawn_log = os.path.join(cold_home, "logs", "daemon-spawn.log")
        try:
            with open(spawn_log) as f:
                port = int(re.search(r"metrics server up port=(\d+)",
                                     f.read()).group(1))
            text = await asyncio.to_thread(_http_json, port, "/metrics")
            t_sig = time.perf_counter()
        finally:
            os.kill(pid, signal.SIGTERM)
        while True:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            if time.perf_counter() - t_sig > CLI_STOP_S:
                raise AssertionError(f"cli: the spawned daemon {pid} did not "
                                     f"exit {CLI_STOP_S} s after SIGTERM")
            await asyncio.sleep(0.05)
        stop_s = time.perf_counter() - t_sig
        with open(spawn_log) as f:
            spawn_text = f.read()
        t_sha = time.perf_counter()
        sha = await asyncio.to_thread(
            lambda: hashlib.sha256(open(cold_out, "rb").read()).hexdigest())
        split["cold_output_sha256"] = time.perf_counter() - t_sha
        os.unlink(cold_out)
        out["cold"] = {
            "dfget_wall_s": got["wall_s"], "summary": summary,
            "alive_s": alive_s, "stop_s": stop_s, "sha256": sha,
            "landed_bytes": _metric(text, "device_sink_landed_bytes_total"),
            "verify": _metric(text, "device_sink_verify_total"),
            "device_failures": _metric(text,
                                       "peer_seed_device_failures_total"),
            "stopped": "stopped role=Daemon" in spawn_text,
            "traceback": "Traceback" in spawn_text,
            "origin": _origin_delta(origin1, gw.requests())}
        split["cold"] = time.perf_counter() - t0

        # 4. The gateway PUT, replicated to the seed the manager lists.
        # The gateway serves on the host's address (no --config: the
        # address the daemon found for itself).
        endpoint = f"http://{d.config.host.ip}:{d.object_storage.port}"
        t0 = time.perf_counter()
        put_file = os.path.join(root, "put.bin")
        content[:CLI_PUT_BYTES].tofile(put_file)
        _ran("dfstore mb", await cli_run(
            "dfstore", "mb", f"df://{CLI_BUCKET}", "--endpoint", endpoint))
        put = _ran("dfstore cp", await cli_run(
            "dfstore", "cp", put_file, f"df://{CLI_BUCKET}/put.bin",
            "--endpoint", endpoint))
        fs = new_client("fs", **cfg.object_storage.backend_options)
        put_task = idgen.task_id_v1(fs.object_url(CLI_BUCKET, "put.bin"),
                                    tag=CLI_BUCKET)
        seed_cli = Client(NetAddr.unix(os.path.join(seed_home, "run",
                                                    "dfdaemon.sock")))
        try:
            async def seeded():
                st = await seed_cli.call("Daemon.StatTask",
                                         {"task_id": put_task}, timeout=10.0)
                return st if st.get("done") else None

            t_put = time.perf_counter()
            replica = await _until("the seed holding the PUT", seeded)
            out["put"] = {"stdout": put["out"].strip(), "replica": replica,
                          "replicated_s": time.perf_counter() - t_put,
                          "cp_wall_s": put["wall_s"]}
        finally:
            await seed_cli.close()
        split["put"] = time.perf_counter() - t0

        # 5. The cache on the child: import, stat, export, delete.
        cache_file = os.path.join(root, "cache.bin")
        cache_bytes = content[-CLI_CACHE_BYTES:]
        cache_bytes.tofile(cache_file)
        export = os.path.join(root, "export.bin")
        home = ["--work-home", child_home]
        t0 = time.perf_counter()
        cache = {}
        for op, extra in (("import", ["--path", cache_file]), ("stat", []),
                          ("export", ["--output", export]), ("delete", [])):
            r = _ran(f"dfcache {op}", await cli_run(
                "dfcache", op, "chip-cli-cache", *extra, *home))
            cache[op] = json.loads(r["out"].strip().splitlines()[-1])
        gone = await cli_run("dfcache", "stat", "chip-cli-cache", *home)
        with open(export, "rb") as f:
            cache["exported_equal"] = f.read() == cache_bytes.tobytes()
        cache["stat_after_delete_rc"] = gone["rc"]
        out["cache"] = cache
        split["cache"] = time.perf_counter() - t0
        out["launches"] = checksum.launch_counts()
        return out
    finally:
        t0 = time.perf_counter()
        if child is not None:
            await child.stop()
        await mc.close()
        out["role_exit"] = {name: stop_role(p) for name, p in
                            reversed(list(roles.items()))}
        split["stop"] = time.perf_counter() - t0


async def _list_hosts(addr: str) -> list:
    cli = _scheduler_client(addr)
    try:
        return (await cli.call("Scheduler.ListHosts", {},
                               timeout=10.0))["hosts"]
    finally:
        await cli.close()


@contextlib.contextmanager
def cli_origin(content: np.ndarray):
    """The origin of the ``cli`` and ``observe`` paths: the shard's file in
    a temporary directory, served by ``StandInProcess`` (written and
    hashed once for both); yields ``{"tmp", "url", "gw", "sha256",
    "origin_s"}`` and, at exit, stops the origin, removes the directory
    and adds ``cleanup_s``."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="df-chip-cli-")
    gw = None
    origin: dict = {"tmp": tmp}
    try:
        # The origin's file, the seed's, child's and cold host's stores,
        # the cold host's output, with a GiB to spare.
        need = 5 * content.size + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(f"the cli phase needs {need} B free under "
                               f"{tmp}; {free} B are")
        path = os.path.join(tmp, GATEWAY_KEY)
        content.tofile(path)
        gw = StandInProcess(origin_objects, path)
        gw.start()
        origin.update(
            gw=gw, url=(f"{gw.endpoint()}/buckets/{ORIGIN_BUCKET}/objects/"
                        f"{GATEWAY_KEY}"),
            sha256=hashlib.sha256(memoryview(content)).hexdigest(),
            origin_s=time.perf_counter() - t0)
        yield origin
    finally:
        t0 = time.perf_counter()
        if gw is not None:
            gw.close()
        shutil.rmtree(tmp, ignore_errors=True)
        origin["cleanup_s"] = time.perf_counter() - t0


def phase_cli(content: np.ndarray, device: torch.device,
              origin: dict) -> dict:
    """The cold-host sequence through the port's CLI (``_cli``), over the
    origin (the shard's file) in a process of its own. Checks: the child's
    landing device-verified, from P2P, every byte of its buffer, K2 once a
    batch and K1 twice in the gate, the origin read once (by the seed);
    the cold host's landing device-verified, its output's sha256, its
    daemon's ``device_sink_landed_bytes_total`` the content length with
    one verification and no device-copy failure, no origin read, its
    clean stop; the PUT in the seed's store, complete; the cache's
    answers and bytes; the fleet's handouts to the child and the seed and
    child scored; every role's exit code 0. The hosts' stores are removed
    after (``cleanup`` in the split)."""
    t_phase = time.perf_counter()
    hosts = os.path.join(origin["tmp"], "hosts")
    try:
        out = asyncio.run(_cli(hosts, content, origin["url"], origin["gw"],
                               device))
    finally:
        t0 = time.perf_counter()
        shutil.rmtree(hosts, ignore_errors=True)
        cleanup_s = time.perf_counter() - t0
    sha = origin["sha256"]
    out["split"].update(origin_file_and_sha256=origin["origin_s"],
                        cleanup=cleanup_s)
    n_pieces = compute_piece_count(content.size,
                                   compute_piece_size(content.size))
    k2 = -(-n_pieces // BATCH_PIECES)
    gate = out["child"]["gate"]
    if not gate["equal"] or gate["pieces_landed"] != n_pieces:
        raise AssertionError(f"cli: the child's buffer {gate}")
    if out["origin"] != seed_origin_reads(content.size):
        raise AssertionError(f"cli: origin saw {out['origin']}, want "
                             f"{seed_origin_reads(content.size)}")
    cold = out["cold"]
    if (cold["summary"].get("device_verified") != "True"
            or cold["sha256"] != sha
            or cold["landed_bytes"] != {"": float(content.size)}
            or cold["verify"] != {'{result="ok"}': 1.0}
            or any(cold["device_failures"].values())
            or cold["origin"] or not cold["stopped"] or cold["traceback"]):
        raise AssertionError(f"cli: the cold host {cold}")
    replica = out["put"]["replica"]
    if (replica["content_length"] != min(CLI_PUT_BYTES, content.size)
            or not replica["done"]):
        raise AssertionError(f"cli: the seed's replica {replica}")
    cache = out["cache"]
    if (cache["import"]["content_length"] != CLI_CACHE_BYTES
            or not cache["stat"]["done"]
            or cache["export"]["state"] != "done"
            or not cache["exported_equal"]
            or cache["stat_after_delete_rc"] == 0):
        raise AssertionError(f"cli: the cache {cache}")
    fleet = out["fleet"]
    child_host = out["child"]["host_id"]
    handouts = [x for x in fleet["decisions"] if x["host"] == child_host]
    if (not handouts or fleet["seed_host"] not in handouts[0]["chosen"]
            or not {child_host, fleet["seed_host"]} <= set(fleet["hosts"])):
        raise AssertionError(f"cli: the fleet {fleet}")
    if any(out["role_exit"].values()):
        raise AssertionError(f"cli: the roles exited {out['role_exit']}")
    if _on_card(device) and out["launches"] != {
            "chunk_checksums": 2, "land_and_checksum": k2,
            "gear_candidates": 0}:
        raise AssertionError(f"cli: launches {out['launches']}, want K1 2, "
                             f"K2 {k2}")
    # The phase as PR 17 timed it: the origin's file and sha256 included.
    return {**out, "want_k2": k2, "pieces": n_pieces,
            "phase_s": time.perf_counter() - t_phase + origin["origin_s"]}


def cli_line(c: dict) -> str:
    """The cli path's printed line."""
    child, cold, gate = c["child"], c["cold"], c["child"]["gate"]
    return (
        f"cli: every role through python -m dragonfly2_tpu_torch.cli.main "
        f"(manager, scheduler with the fleet on, a seed resolving it "
        f"through the manager: up in {c['control_plane_s']:.3f} s); the "
        f"child's dfget --device tpu --no-daemon {child['dfget_wall_s']:.3f}"
        f" s wall (p2p={child['summary'].get('p2p')}, device_verified="
        f"{child['summary'].get('device_verified')}), land_s "
        f"{gate['land_s']:.4f} s, the sink's worker busy "
        f"{gate['sink_busy_s']:.4f} s, register to normal_task "
        f"{child['register_to_normal_task_s'] * 1e3:.2f} ms (sched_wait "
        f"{child['sched_wait_s'] * 1e3:.2f} ms); K2 "
        f"{c['launches']['land_and_checksum']}, K1 "
        f"{c['launches']['chunk_checksums']}; the origin served "
        f"{c['origin'].get('get_range', [0, 0])[1]} B, to the seed; the "
        f"cold host's dfget -O --device tpu --manager "
        f"{cold['dfget_wall_s']:.3f} s wall, its spawned daemon alive after "
        f"{cold['alive_s']:.3f} s, device_verified="
        f"{cold['summary'].get('device_verified')}, "
        f"{cold['landed_bytes']['']:.0f} B landed, stopped "
        f"{cold['stop_s']:.3f} s after SIGTERM; the PUT's replica on the "
        f"seed {c['put']['replicated_s']:.3f} s after it; the fleet "
        f"recorded {len(c['fleet']['decisions'])} handouts of the task; "
        f"the phase {c['phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in c["split"].items())
        + f"; a CLI process's start alone {c['cli_start_s']:.2f} s)")


# --------------------------------------------------------------------- #
# The observability plane on a landing (observe): the evaluator plugin,
# the pod lens and SLO engine, the runtime observatory, tracing from
# dfget to a parent's upload server, the /debug/* routes; then the same
# landing with the observatory and the pod lens off, for the pair
# --------------------------------------------------------------------- #

OBSERVE_PLUGIN = "chip-counting"
# The evaluator plugin the observe path's schedulers load from
# DRAGONFLY_PLUGIN_DIR: the port's default evaluator, each call's order
# of parents appended to calls.jsonl beside the file.
OBSERVE_PLUGIN_SOURCE = '''"""An evaluator plugin: the default evaluator, each call recorded."""
import json
import os

PLUGIN_TYPE = "evaluator"
PLUGIN_NAME = "chip-counting"
LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "calls.jsonl")


def create(config=None):
    from dragonfly2_tpu_torch.scheduler.scheduling.evaluator import (
        Evaluator,
    )

    class Counting(Evaluator):
        def evaluate_parents(self, parents, child, total_piece_count):
            ordered = super().evaluate_parents(parents, child,
                                               total_piece_count)
            with open(LOG, "a") as f:
                f.write(json.dumps({"host": child.host.id,
                                    "order": [p.id for p in ordered]})
                        + "\\n")
            return ordered

    return Counting(config)
'''
OBSERVE_SERVICES = {"dfget": "chip-observe-dfget",
                    "child": "chip-observe-child",
                    "scheduler": "chip-observe-scheduler",
                    "seed": "chip-observe-seed"}
# The spans one landing's trace must hold: (service, span name).
OBSERVE_TRACE = (("dfget", "dfget.download"),
                 ("child", "rpc.Daemon.Download"),
                 ("scheduler", "rpc.Scheduler.AnnouncePeer"),
                 ("seed", "rpc.Peer.TriggerDownloadTask"),
                 ("seed", "upload.serve"))


def _collector_child(conn, port: int) -> None:
    """The body of ``StandInCollector``: an OTLP/HTTP JSON collector
    (``POST /v1/traces``) on ``port``, answering the parent with every
    span received until told to stop."""
    payloads: list = []
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            ok = self.path == "/v1/traces"
            if ok:
                with lock:
                    payloads.append(json.loads(body))
            out = b'{"partialSuccess": {}}' if ok else b"404: Not Found"
            self.send_response(200 if ok else 404)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    server = ThreadingHTTPServer((P2P_HOST, port), Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="df-otlp-collector", daemon=True)
    thread.start()
    conn.send(f"http://{P2P_HOST}:{port}")
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                conn.send(None)
                return
            spans = []
            with lock:
                for p in payloads:
                    for rs in p["resourceSpans"]:
                        svc = next((a["value"]["stringValue"] for a in
                                    rs["resource"]["attributes"]
                                    if a["key"] == "service.name"), "")
                        for ss in rs["scopeSpans"]:
                            spans += [{
                                "service": svc, "name": sp["name"],
                                "trace": sp["traceId"], "span": sp["spanId"],
                                "parent": sp.get("parentSpanId", ""),
                                "attrs": {a["key"]: next(iter(
                                    a["value"].values()))
                                    for a in sp["attributes"]}}
                                for sp in ss["spans"]]
            conn.send(spans)
    finally:
        server.shutdown()
        server.server_close()


class StandInCollector(StandInProcess):
    """A stand-in OTLP collector in a process of its own (spawned) on a
    port the caller chose, so the roles can be told its endpoint before
    it serves; ``spans()`` every span it received, flattened."""

    def __init__(self, port: int):
        super().__init__(None, port)

    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_collector_child,
                                 args=(child, *self._args), daemon=True,
                                 name="df-otlp-collector")
        self._proc.start()
        child.close()

    def spans(self) -> list:
        return self._ask("spans")


def _masked(text: str) -> str:
    """A timeline's text less its alignment bounds, which age with the
    time between two reads of one report."""
    return re.sub(r"(align_err<=|±)[0-9.]+ms", r"\1#ms", text)


def _sink_profile(report: dict, top: int = 5) -> dict:
    """The sink workers' sampled threads of a ``/debug/prof`` report:
    their samples and top self-time frames."""
    return {name: {"samples": t["samples"], "top_self": t["top_self"][:top]}
            for name, t in report["threads"].items()
            if name.startswith("df-device-sink")}


async def _observe_landing(root: str, name: str, content: np.ndarray,
                           url: str, gw: StandInProcess, device,
                           scheduler: str, env: dict, on: bool) -> dict:
    """One landing onto the card for ``dfget --device tpu --pod`` on a
    child in this process, built from the CLI's argv mapping: the runtime
    observatory on or off (``prof.enabled``), tracing to the collector.
    Returns its numbers and, with ``on``, what the child serves at
    ``/debug/prof*`` and ``/debug/flight/<task>``."""
    from dragonfly2_tpu_torch.cli import main as cli_main
    from dragonfly2_tpu_torch.pkg import tracing

    home = os.path.join(root, name)
    cfg = cli_main.daemon_config(cli_main.build_parser().parse_args([
        "daemon", "--scheduler", scheduler, "--device-sink", "--work-home",
        home, "--hostname", f"chip-observe-{name}"]))
    cfg.prof.enabled = on
    tracing.exporter().set_otlp(
        env["DF_TRACE_OTLP_ENDPOINT"], flush_interval=0.2,
        service_name=OBSERVE_SERVICES["child"] + ("" if on else "-off"))
    child = SwarmChild(root, name, "", device, config=cfg)
    out: dict = {}
    try:
        await child.start()
        task_id = FileTaskRequest(url=url, output="").task_id()
        host = torch.from_numpy(content).to(device)
        origin0 = gw.requests()
        child.clock.reset()
        _sync(device)
        zero_launches()
        got = _ran(f"observe dfget {name}", await cli_run(
            "dfget", url, "--device", "tpu", "--pod", "--no-daemon",
            "--work-home", home, env={
                **env, "DF_SERVICE_NAME": OBSERVE_SERVICES["dfget"]}))
        gate = child.take_and_gate(task_id, host)
        del host
        _sync(device)
        out["launches"] = checksum.launch_counts()
        summary, pod_text = dfget_parts(got["err"])
        out.update(
            task_id=task_id, host_id=child.host_id, summary=summary,
            pod_text=pod_text, dfget_wall_s=got["wall_s"], gate=gate,
            origin=_origin_delta(origin0, gw.requests()),
            handouts=[a["parents"] for a in child.answers
                      if a["type"] == "normal_task"],
            **child.registration(task_id))
        if on:
            port = child.daemon.metrics.port
            out["prof"] = await asyncio.to_thread(
                _http_json, port, "/debug/prof?topn=10")
            out["runtime"] = await asyncio.to_thread(
                _http_json, port, "/debug/prof/runtime")
            out["flight"] = await asyncio.to_thread(
                _http_json, port, f"/debug/flight/{task_id}")
        out["observatory"] = child.daemon.prof_obs is not None
        if _on_card(device):
            torch.cuda.empty_cache()
        return out
    finally:
        await child.stop()
        otlp = tracing.exporter().otlp
        if otlp is not None:
            await asyncio.to_thread(otlp.flush)


async def _observe(root: str, content: np.ndarray, url: str,
                   gw: StandInProcess, device) -> dict:
    """The observe path's roles and both landings. Two schedulers (the
    CLI's ``scheduler --config``: the evaluator plugin by name from
    ``DRAGONFLY_PLUGIN_DIR``; one on the defaults, the pod lens, the SLO
    engine and the runtime observatory on; one with ``podlens`` and
    ``prof`` off), a seed on each (``daemon --seed-peer``; the second with
    ``prof`` off) and the OTLP collector each in a process of its own,
    started together. Then the landing with everything on, its reads
    (the scheduler's ``/debug/pod/<task>/timeline`` and ``/debug/slo``,
    the plugin's calls, the collector's spans), its seed stopped and both
    stores removed; then the landing with everything off."""
    logs = os.path.join(root, "logs")
    plugins = os.path.join(root, "plugins")
    os.makedirs(logs)
    os.makedirs(plugins)
    with open(os.path.join(plugins, "df_plugin_chip_counting.py"),
              "w") as f:
        f.write(OBSERVE_PLUGIN_SOURCE)
    sched_on, sched_off, metrics_on, collector_port = free_ports(4)
    endpoint = f"http://{P2P_HOST}:{collector_port}"
    env = {"DRAGONFLY_PLUGIN_DIR": plugins,
           "DF_TRACE_OTLP_ENDPOINT": endpoint}
    out: dict = {}
    split = out["split"] = {}
    roles: dict = {}
    collector = StandInCollector(collector_port)
    try:
        t0 = time.perf_counter()
        collector.start()
        for which, port, over in (
                ("on", sched_on, {}),
                ("off", sched_off, {"podlens": {"enabled": False},
                                    "prof": {"enabled": False}})):
            cfg = os.path.join(root, f"scheduler-{which}.json")
            with open(cfg, "w") as f:
                json.dump({"scheduling": {"algorithm": OBSERVE_PLUGIN},
                           **over}, f)
            args = ["scheduler", "--config", cfg, "--host", P2P_HOST,
                    "--port", str(port)]
            args += (["--metrics-port", str(metrics_on)] if which == "on"
                     else [])
            roles[f"scheduler-{which}"] = cli_role(logs, f"scheduler-{which}",
                                                   args, env={
                **env, "DF_SERVICE_NAME": OBSERVE_SERVICES["scheduler"]
                + ("" if which == "on" else "-off")})
            seed_args = ["daemon", "--seed-peer", "--scheduler",
                         f"{P2P_HOST}:{port}", "--work-home",
                         os.path.join(root, f"seed-{which}"), "--hostname",
                         f"chip-observe-seed-{which}", "--metrics-port",
                         "-1", "--torch-device", "cpu"]
            if which == "off":
                seed_cfg = os.path.join(root, "seed-off.json")
                with open(seed_cfg, "w") as f:
                    json.dump({"prof": {"enabled": False}}, f)
                seed_args += ["--config", seed_cfg]
            roles[f"seed-{which}"] = cli_role(logs, f"seed-{which}",
                                              seed_args, env={
                **env, "DF_SERVICE_NAME": OBSERVE_SERVICES["seed"]
                + ("" if which == "on" else "-off")})
        await asyncio.to_thread(collector.endpoint)
        seeds = {}
        for which, port in (("on", sched_on), ("off", sched_off)):
            addr = f"{P2P_HOST}:{port}"

            async def seed_host(addr=addr, which=which):
                hosts = await _list_hosts(addr)
                return next((h for h in hosts if h["hostname"] ==
                             f"chip-observe-seed-{which}"
                             and h["type"] == 1), None)

            seeds[which] = await _until(f"observe: the {which} seed "
                                        f"announced", seed_host,
                                        timeout=300)
        split["roles_up"] = time.perf_counter() - t0

        # 1. Everything on.
        t0 = time.perf_counter()
        on = await _observe_landing(root, "child-on", content, url, gw,
                                    device, f"{P2P_HOST}:{sched_on}", env,
                                    True)
        split["landing_on"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        task_id = on["task_id"]
        on["timeline"] = await asyncio.to_thread(
            _http_json, metrics_on, f"/debug/pod/{task_id}/timeline")
        on["slo"] = await asyncio.to_thread(_http_json, metrics_on,
                                            "/debug/slo")
        with open(os.path.join(plugins, "calls.jsonl")) as f:
            on["plugin_calls"] = [json.loads(line) for line in f]

        async def traced():
            spans = await asyncio.to_thread(collector.spans)
            roots = [s for s in spans if s["name"] == "dfget.download"]
            if not roots:
                return None
            trace = roots[0]["trace"]
            mine = [s for s in spans if s["trace"] == trace]
            have = {(s["service"], s["name"]) for s in mine}
            want = {(OBSERVE_SERVICES[r], n) for r, n in OBSERVE_TRACE}
            return mine if want <= have else None

        trace = await _until("observe: the landing's trace at the "
                             "collector", traced, timeout=30)
        counts: dict = {}
        for s in trace:
            key = f"{s['service']} {s['name']}"
            counts[key] = counts.get(key, 0) + 1
        on["trace"] = {"trace_id": trace[0]["trace"], "spans": counts,
                       "parents": {s["span"]: s["parent"] for s in trace},
                       "by_id": {s["span"]: f"{s['service']} {s['name']}"
                                 for s in trace}}
        on["seed_host"] = seeds["on"]["id"]
        split["reads"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["seed_on_exit"] = stop_role(roles.pop("seed-on"))
        for name in ("seed-on", "child-on"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        split["stop_and_remove_on"] = time.perf_counter() - t0

        # 2. The pair: the observatory and the pod lens off.
        t0 = time.perf_counter()
        off = await _observe_landing(root, "child-off", content, url, gw,
                                     device, f"{P2P_HOST}:{sched_off}", env,
                                     False)
        split["landing_off"] = time.perf_counter() - t0
        out.update(on=on, off=off)
        return out
    finally:
        from dragonfly2_tpu_torch.pkg import tracing

        t0 = time.perf_counter()
        tracing.exporter().set_otlp("")
        out["role_exit"] = {name: stop_role(p) for name, p in
                            reversed(list(roles.items()))}
        collector.close()
        split["stop"] = time.perf_counter() - t0


def phase_observe(content: np.ndarray, device: torch.device,
                  origin: dict) -> dict:
    """The observe path (``_observe``) over the ``cli`` path's origin.
    Checks, for the landing with everything on: every byte of the child's
    buffer and every piece landed, K2 once a batch and K1 twice in the
    gate, ``device_verified`` and ``p2p``, the origin read once (by the
    seed); the plugin evaluator called for the child and the handout its
    order's head; the scheduler's ``/debug/pod/<task>/timeline`` with rows
    for the seed and the child, each with a clock sample, the child's row
    with every piece and its device landings (the ``ici`` phase the
    flight folds ``hbm_start`` -> ``hbm_landed`` into); ``dfget --pod``'s
    text that report's ``render_timeline`` (its alignment bounds masked:
    they age between the two reads); ``/debug/slo`` over at least two
    completions; the child's ``/debug/prof`` naming a ``df-device-sink``
    thread, ``/debug/prof/runtime`` with the daemon loop's lag histogram
    and the GC counts, ``/debug/flight/<task>`` with the device-landing
    events; one trace at the collector from ``dfget.download`` through
    the child's ``rpc.Daemon.Download``, the scheduler's
    ``rpc.Scheduler.AnnouncePeer`` and the seed's
    ``rpc.Peer.TriggerDownloadTask`` to the seed's ``upload.serve``, each
    upload span a child of the child's download span. For the landing
    with everything off: the same bytes, launches and origin reads, and
    no observatory. Every role's exit code 0."""
    from dragonfly2_tpu_torch.pkg.podlens import render_timeline

    t_phase = time.perf_counter()
    out = asyncio.run(_observe(os.path.join(origin["tmp"], "observe"),
                               content, origin["url"], origin["gw"],
                               device))
    n_pieces = compute_piece_count(content.size,
                                   compute_piece_size(content.size))
    k2 = -(-n_pieces // BATCH_PIECES)
    on, off = out["on"], out["off"]
    # Every check runs; the failures are raised together.
    failed = []
    for which, run in (("on", on), ("off", off)):
        gate = run["gate"]
        if not gate["equal"] or gate["pieces_landed"] != n_pieces:
            failed.append(f"observe {which}: the buffer {gate}")
        if (run["summary"].get("p2p"), run["summary"].get(
                "device_verified")) != ("True", "True"):
            failed.append(f"observe {which}: dfget {run['summary']}")
        if run["origin"] != seed_origin_reads(content.size):
            failed.append(f"observe {which}: origin saw {run['origin']}")
        if _on_card(device) and run["launches"] != {
                "chunk_checksums": 2, "land_and_checksum": k2,
                "gear_candidates": 0}:
            failed.append(f"observe {which}: launches {run['launches']}, "
                          f"want K1 2, K2 {k2}")
        if run["observatory"] != (which == "on"):
            failed.append(f"observe {which}: observatory "
                          f"{run['observatory']}")
    calls = [c["order"] for c in on["plugin_calls"]
             if c["host"] == on["host_id"]]
    handout = on["handouts"][0] if on["handouts"] else []
    if not handout or not any(o[:len(handout)] == handout for o in calls):
        failed.append(f"observe: the plugin's calls {calls}, the handout "
                      f"{on['handouts']}")
    # A shipped digest carries at most flight.digest's max_pieces rows.
    rows_cap = inspect.signature(flight.digest).parameters[
        "max_pieces"].default
    rows = {h["host"]: h for h in on["timeline"]["hosts"]}
    child_row = rows.get(on["host_id"], {})
    if (not {on["seed_host"], on["host_id"]} <= set(rows)
            or any(rows[h]["clock_samples"] < 1
                   for h in (on["seed_host"], on["host_id"]))
            or child_row["pieces"] != min(n_pieces, rows_cap)
            or child_row["phases"]["ici"] <= 0
            or not any(seg[2] == "ici" for seg in child_row["segments"])):
        failed.append(f"observe: the timeline {on['timeline']}")
    if _masked(on["pod_text"]) != _masked(render_timeline(on["timeline"])):
        failed.append(f"observe: dfget --pod printed\n{on['pod_text']}\n"
                      f"the scheduler serves\n"
                      f"{render_timeline(on['timeline'])}")
    if on["slo"]["completions_total"] < 2:
        failed.append(f"observe: /debug/slo {on['slo']}")
    runtime = on["runtime"]
    loops = {p["name"]: p for p in runtime["loops"]}
    if (not _sink_profile(on["prof"])
            or sum(loops.get("daemon", {}).get("histogram", {}).get(
                "counts", [])) < 1
            or len(runtime["gc"]["collections"]) != 3):
        failed.append(f"observe: /debug/prof threads "
                      f"{sorted(on['prof']['threads'])}, runtime {runtime}")
    counts = on["flight"]["event_counts"]
    if (counts.get("hbm_start", 0) < 1
            or counts.get("hbm_landed", 0) != counts.get("hbm_start", 0)):
        failed.append(f"observe: /debug/flight {counts}")
    tr = on["trace"]
    child_dl = [i for i, n in tr["by_id"].items()
                if n == f"{OBSERVE_SERVICES['child']} rpc.Daemon.Download"]
    uploads = [i for i, n in tr["by_id"].items()
               if n == f"{OBSERVE_SERVICES['seed']} upload.serve"]
    if not child_dl or any(tr["parents"][u] not in child_dl
                           for u in uploads):
        failed.append(f"observe: the trace {tr['spans']}")
    if out["seed_on_exit"] or any(out["role_exit"].values()):
        failed.append(f"observe: the roles exited {out['seed_on_exit']}, "
                      f"{out['role_exit']}")
    if failed:
        raise AssertionError("\n".join(failed))
    for run in (on, off):
        run.pop("pod_text", None)
    on["trace"] = {"trace_id": tr["trace_id"], "spans": tr["spans"]}
    on["flight"] = {k: on["flight"][k] for k in (
        "state", "wall_s", "phases", "dominant_phase", "event_counts",
        "runtime")}
    on["plugin_calls"] = len(on["plugin_calls"])
    on["prof"] = {"samples": on["prof"]["samples"],
                  "sink": _sink_profile(on["prof"])}
    return {**out, "want_k2": k2, "pieces": n_pieces,
            "phase_s": time.perf_counter() - t_phase}


def observe_line(o: dict) -> str:
    """The observe path's printed line: the pair and what was read."""
    on, off = o["on"], o["off"]
    g_on, g_off = on["gate"], off["gate"]
    sink = ", ".join(
        f"{name} {t['samples']} samples: " + "; ".join(
            f"{f['frame']} {f['frac'] * 100:.1f}%" for f in t["top_self"])
        for name, t in on["prof"]["sink"].items())
    return (
        f"observe: dfget --device tpu --pod on a child in this process, "
        f"the plugin evaluator ({on['plugin_calls']} calls) at a "
        f"scheduler with the pod lens, SLO engine and observatory on; "
        f"land_s on {g_on['land_s']:.4f} s / off {g_off['land_s']:.4f} s "
        f"= {g_on['land_s'] / g_off['land_s']:.3f}; the sink's worker busy "
        f"{g_on['sink_busy_s']:.4f} / {g_off['sink_busy_s']:.4f} s (host "
        f"checksum {g_on['host_checksum_s']:.4f} / "
        f"{g_off['host_checksum_s']:.4f} s, staging "
        f"{g_on['stage_s']:.4f} / {g_off['stage_s']:.4f} s); dfget wall "
        f"{on['dfget_wall_s']:.3f} / {off['dfget_wall_s']:.3f} s; register "
        f"to normal_task {on['register_to_normal_task_s'] * 1e3:.2f} / "
        f"{off['register_to_normal_task_s'] * 1e3:.2f} ms; K2 "
        f"{on['launches']['land_and_checksum']} / "
        f"{off['launches']['land_and_checksum']}, K1 "
        f"{on['launches']['chunk_checksums']} / "
        f"{off['launches']['chunk_checksums']}; the timeline "
        f"{on['timeline']['hosts_total']} hosts, span "
        f"{on['timeline']['span_s']:.3f} s, align_err <= "
        f"{on['timeline']['align_err_max_s'] * 1e3:.1f} ms; /debug/slo "
        f"{on['slo']['completions_total']} completions; one trace of "
        f"{sum(on['trace']['spans'].values())} spans "
        f"({', '.join(f'{k} {v}' for k, v in on['trace']['spans'].items())})"
        f"; the sampler {on['prof']['samples']} passes, the sink worker: "
        f"{sink}; the phase {o['phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in o["split"].items()) + ")")


# --------------------------------------------------------------------- #
# The daemon's other task kinds: a delta task through the port's own
# daemon (generation 1 -> 2: the base manifest built by K3 inside the
# task, the swap gated by K1), and a scheduler's seed trigger onto the
# card (Peer.TriggerDownloadTask -> start_seed_task -> K2 per batch)
# --------------------------------------------------------------------- #

GENERATION_KEYS = ("generation-1/" + GATEWAY_KEY, "generation-2/" + GATEWAY_KEY)


def origin_generations(path1: str, path2: str) -> dict:
    """The stand-in origin's two objects: both generations' files, mapped
    (the bytes never cross the pipe)."""
    out = {}
    for key, path in zip(GENERATION_KEYS, (path1, path2)):
        with open(path, "rb") as f:
            out[(ORIGIN_BUCKET, key)] = mmap.mmap(f.fileno(), 0,
                                                  access=mmap.ACCESS_READ)
    return out


class _NoParent:
    """The stand-in scheduler's view for a seed: no parent holds any task,
    so every registration is answered with ``need_back_source``, as the
    JAX scheduler answers a seed peer."""

    @staticmethod
    def find_completed_task(task_id: str):
        return None


async def _daemon_delta(d: StandInDaemon, urls: list[str], new_m, base_ref,
                        plan, gw: StandInProcess, gen2: np.ndarray,
                        spans: dict, layout, tmp: str, device) -> dict:
    """Generation 1 landed with ``download_to_device`` and live in a
    ``DoubleBuffer``; generation 2's manifest imported as a publishing
    peer's; generation 1's left unpublished. Then ``download_delta`` under
    a snapshot reader, its launches counted from 0 just before it. Its
    peak device memory is read above what other phases hold: above the
    memory allocated when the swap starts (``peak_device_bytes``) and
    above the memory allocated before generation 1 landed
    (``resident_peak_bytes``: both generations); each is held to
    ``PERF.md`` section 2's hot-swap limit, 2 x content (padded to whole
    pieces, as a sink holds it) + one piece."""
    tm = d.task_manager
    _sync(device)
    held = _memory_mark(device)
    t0 = time.perf_counter()
    first = await download_to_device(d, urls[0])
    gen1_s = time.perf_counter() - t0
    hot = DoubleBuffer()
    hot.flip(first.as_bytes_array(), first.load_safetensors())
    gen2_id = FileTaskRequest(url=urls[1], output="").task_id()
    path = os.path.join(tmp, "generation-2.manifest.json")
    with open(path, "wb") as f:
        f.write(new_m.to_json_bytes())
    await tm.import_task(path, manifest_request(gen2_id))
    os.unlink(path)
    if tm.storage.find_completed_task(
            manifest_request(first.task_id).task_id()) is not None:
        raise AssertionError("daemon delta: generation 1's manifest is "
                             "published before the task")
    origin_before = gw.requests()
    loop = asyncio.get_running_loop()

    def swap():
        return asyncio.run_coroutine_threadsafe(download_delta(
            d, urls[1], base=first, hot=hot, device=device), loop).result()

    _sync(device)
    at_swap = _memory_mark(device)
    result, launches, swap_s, peak, seen, mixed = await asyncio.to_thread(
        swap_under_reader, hot, swap, device)
    origin = _origin_delta(origin_before, gw.requests())
    check_generation2(result, hot, gen2, layout, spans, seen, mixed)
    # A sink holds the content padded to whole pieces.
    piece = compute_piece_size(gen2.size)
    limit = 2 * piece * compute_piece_count(gen2.size, piece) + piece
    swap_peak = peak - at_swap if _on_card(device) else 0
    resident_peak = peak - held if _on_card(device) else 0
    if max(swap_peak, resident_peak) > limit:
        raise AssertionError(
            f"daemon delta: peak device memory {swap_peak} B above the "
            f"swap's start, {resident_peak} B above generation 1's; the "
            f"limit is {limit} B (2 x content + one piece)")
    published = await fetch_manifest(tm, first.task_id)
    store = tm.storage.find_completed_task(result.task_id)
    return {"task_id": result.task_id, "generation1_s": gen1_s,
            "stats": result.stats, "staged_bytes": result.staged_bytes,
            "reused_device_bytes": result.reused_device_bytes,
            "copies": result.copies, "swap_timings": result.timings,
            "delta_timings": tm.delta_timings.get(result.task_id, {}),
            "swap_s": swap_s, "peak_device_bytes": swap_peak,
            "resident_peak_bytes": resident_peak,
            "peak_limit_bytes": limit,
            "launches": launches, "origin": origin, "snapshots": seen,
            "published_base": (None if published is None
                               else chunk_triples(published.chunks)
                               == chunk_triples(base_ref.chunks)),
            "store_done": store is not None and store.metadata.done,
            "spans": len(plan.fetch_spans())}


async def _until_seeded(tm, sinks: TimedSinks, task_id: str,
                        timeout: float = 600.0) -> None:
    """Wait for a spawned seed task: its sink finalized and the task no
    longer running."""
    deadline = time.monotonic() + timeout
    while sinks.finalized is None or tm.is_task_running(task_id):
        if time.monotonic() > deadline:
            raise AssertionError(f"seed: task {task_id[:16]} did not finish")
        await asyncio.sleep(0.005)


async def _seed_triggers(data_dir: str, url: str, content: np.ndarray,
                         gw: StandInProcess, device) -> dict:
    """A fresh daemon (the port's parts, a stand-in scheduler with no
    parent to offer, the peer drpc server) seeded by the body a scheduler
    sends (``scheduler/seed_client.py``): the ACK, the task seeded from
    the origin and landed by K2 as its pieces arrive, the verified buffer
    taken from the sink manager and gated by K1 (launches counted from 0
    before the trigger); then the same trigger again on the completed
    task."""
    sched = StandInScheduler(_NoParent(), host_record("chip-seed-sched"))
    addr = await sched.serve()
    d = StandInDaemon(data_dir, device, scheduler=addr)
    rpc = DaemonRpcServer(d.task_manager)
    await rpc.serve_peer(NetAddr.tcp(P2P_HOST, 0))
    cli = Client(NetAddr.tcp(P2P_HOST, rpc.peer_server.port()))
    tm, sinks = d.task_manager, d.device_sinks
    task_id = FileTaskRequest(url=url, output="").task_id()
    body = {"url": url, "task_id": task_id, "device": "tpu", "seed": True}
    out = {}
    try:
        for what in ("seed", "again"):
            await asyncio.sleep(0)
            sinks.reset()
            origin_before = gw.requests()
            _sync(device)
            base = _memory_mark(device)
            failures = [SEED_DEVICE_FAILURES.value(r)
                        for r in ("device", "kernel")]
            zero_launches()
            t0 = time.perf_counter()
            ack = await cli.call("Peer.TriggerDownloadTask", dict(body),
                                 timeout=10.0)
            ack_s = time.perf_counter() - t0
            landed_at_ack = tm.storage.find_completed_task(task_id) is not None
            await _until_seeded(tm, sinks, task_id)
            rec = {"ack": ack, "ack_s": ack_s,
                   "landed_at_ack": landed_at_ack,
                   "land_s": sinks.finalized - sinks.first,
                   "sink_busy_s": sinks.busy_s - sinks.busy_from}
            sink = sinks.take(task_id)
            if what == "seed":
                u8 = sink.as_bytes_array()
                verify_u8_against_host(u8, sink.sink.piece_size,
                                       sink.sink.host_checksums)
                _sync(device)
                rec["trigger_to_verified_s"] = time.perf_counter() - t0
                rec["equal"] = equal_in_steps(u8, content)
                rec.update({key: getattr(sink.sink, key) for key in (
                    "host_checksum_s", "stage_s", "stage_wait_s")})
                u8 = None
            rec["launches"] = checksum.launch_counts()
            rec["device_failures"] = [
                SEED_DEVICE_FAILURES.value(r) - f
                for r, f in zip(("device", "kernel"), failures)]
            rec["peak_device_bytes"] = _memory_mark(device, peak=True) - base
            rec["device_copy"] = sink is not None
            sink = None
            rec["origin"] = _origin_delta(origin_before, gw.requests())
            store = tm.storage.find_completed_task(task_id)
            rec["store"] = None if store is None else {
                "pieces": len(store.metadata.pieces),
                "seed_peer": store.metadata.peer_id.endswith("_Seed"),
                "content_length": store.metadata.content_length}
            rec["scheduler"] = (await sched.summary(task_id)).get(task_id, {})
            out[what] = rec
    finally:
        await cli.close()
        await rpc.close()
        await sched.server.close()
        if d.scheduler_client is not None:
            await d.scheduler_client.close()
        d.close()
    return out


def phase_task_kinds(content: np.ndarray, gen2: np.ndarray, spans: dict,
                     layout, base_ref: DeltaManifest, new_m: DeltaManifest,
                     device: torch.device,
                     keep: str | None = None) -> tuple[dict, dict]:
    """Both generations served over HTTP from a process of its own. The
    ``daemon_delta`` path: generation 1 lands through the port's daemon,
    then ``download_delta`` to generation 2 runs the daemon's delta task
    (the base manifest built from the landed store by K3 and published,
    reused chunks copied out of the base store and checked by sha256, the
    changed spans fetched as ranged tasks) and the device swap (reused
    chunks copied out of the live buffer, the gate by K1). The ``seed``
    path: a fresh daemon seeded with generation 1 by a scheduler's
    trigger, landed by K2 as it arrives. Returns the two reports. With
    ``keep``, generation 1's file moves there at the end (the ``dfdaemon``
    phase serves it: no second 5 GB write)."""
    tmp = tempfile.mkdtemp(prefix="df-chip-tasks-")
    gw = d = None
    plan = plan_delta(new_m, base_ref)
    try:
        # Both origin files, generation 1's and 2's stores and the span
        # stores (the seed's store comes after the delta's are gone), with
        # a GiB to spare.
        need = 4 * content.size + plan.fetched_bytes + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(
                f"the task-kind phases need {need} B free under {tmp} (two "
                f"origin files and the daemon's stores); {free} B are")
        paths = [os.path.join(tmp, f"generation-{i}") for i in (1, 2)]
        t0 = time.perf_counter()
        content.tofile(paths[0])
        gen2.tofile(paths[1])
        write_s = time.perf_counter() - t0
        gw = StandInProcess(origin_generations, *paths)
        gw.start()
        ep = gw.endpoint()
        urls = [f"{ep}/buckets/{ORIGIN_BUCKET}/objects/{key}"
                for key in GENERATION_KEYS]
        data = os.path.join(tmp, "delta-daemon")
        d = StandInDaemon(data, device)
        delta = asyncio.run(_daemon_delta(d, urls, new_m, base_ref, plan, gw,
                                          gen2, spans, layout, tmp, device))
        delta["store_bytes"] = d.storage.total_disk_usage()
        d.close()
        d = None
        shutil.rmtree(data, ignore_errors=True)
        if _on_card(device):
            torch.cuda.empty_cache()
        st = delta["stats"]
        want_stats = (plan.reused_bytes, plan.fetched_bytes, 0)
        got_stats = (st.get("reused_bytes"), st.get("fetched_bytes"),
                     st.get("corrupt_base"))
        if got_stats != want_stats:
            raise AssertionError(f"daemon delta: stats {st}, want reused, "
                                 f"fetched, corrupt_base {want_stats}")
        if delta["staged_bytes"] != plan.fetched_bytes or delta[
                "reused_device_bytes"] != plan.reused_bytes:
            raise AssertionError(
                f"daemon delta: staged {delta['staged_bytes']} / reused "
                f"{delta['reused_device_bytes']}, plan "
                f"{plan.fetched_bytes} / {plan.reused_bytes}")
        if not delta["published_base"]:
            raise AssertionError("daemon delta: the task published no base "
                                 "manifest, or one that differs from the "
                                 "whole-shard manifest")
        # Only the changed spans came from the origin: one ranged task a
        # span, each a 1-byte probe and its span's bytes; nothing whole.
        served = delta["origin"].get("get_range", [0, 0])[1]
        delta["origin_bytes"] = served
        if set(delta["origin"]) != {"get_range"} or (
                served != plan.fetched_bytes + delta["spans"]):
            raise AssertionError(
                f"daemon delta: origin saw {delta['origin']}, want "
                f"{plan.fetched_bytes} B of spans + {delta['spans']} probes")
        want = {"chunk_checksums": 2, "land_and_checksum": 0,
                "gear_candidates": planned_k3(span_sizes(content.size))}
        if _on_card(device) and delta["launches"] != want:
            raise AssertionError(f"daemon delta: launches "
                                 f"{delta['launches']}, want {want}")
        delta.update(plan_reused=plan.reused_bytes,
                     plan_fetched=plan.fetched_bytes,
                     origin_write_s=write_s)

        seed = asyncio.run(_seed_triggers(os.path.join(tmp, "seed-daemon"),
                                          urls[0], content, gw, device))
        n_pieces = compute_piece_count(content.size,
                                       compute_piece_size(content.size))
        k2 = -(-n_pieces // BATCH_PIECES)
        groups = min(PieceManagerOption().concurrency, n_pieces)
        first, again = seed["seed"], seed["again"]
        if first["ack"] != {"ok": True, "already_complete": False} or (
                first["landed_at_ack"]):
            raise AssertionError(f"seed: ACK {first['ack']} (landed at the "
                                 f"ACK: {first['landed_at_ack']})")
        if not (first["equal"] and first["device_copy"]):
            raise AssertionError("seed: the verified buffer differs from "
                                 "generation 1")
        for what in ("seed", "again"):
            # A device fault on a preheat leaves the disk store standing:
            # only this count shows it.
            if seed[what]["device_failures"] != [0, 0]:
                raise AssertionError(
                    f"seed {what}: device copy failed (device, kernel): "
                    f"{seed[what]['device_failures']}")
        if first["origin"] != {"get_range": [1 + groups, 1 + content.size]}:
            raise AssertionError(f"seed: origin saw {first['origin']}")
        sched = first["scheduler"]
        if (not sched.get("is_seed") or sched.get("reported") != n_pieces
                or sched.get("messages", {}).get("download_finished") != 1
                or first["store"] != {"pieces": n_pieces, "seed_peer": True,
                                      "content_length": content.size}):
            raise AssertionError(f"seed: scheduler {sched}, store "
                                 f"{first['store']}")
        if again["ack"] != {"ok": True, "already_complete": True} or (
                again["origin"]):
            raise AssertionError(f"seed again: ACK {again['ack']}, origin "
                                 f"{again['origin']}")
        if _on_card(device):
            for what, k1_n in (("seed", 2), ("again", 0)):
                if seed[what]["launches"] != {"chunk_checksums": k1_n,
                                              "land_and_checksum": k2,
                                              "gear_candidates": 0}:
                    raise AssertionError(
                        f"seed {what}: launches {seed[what]['launches']}, "
                        f"want K1 {k1_n}, K2 {k2}")
        seed["want_k2"] = k2
        if keep is not None:
            gw.close()   # its map of the file goes with it
            os.replace(paths[0], keep)
        return delta, seed
    finally:
        if gw is not None:
            gw.close()
        if d is not None:
            d.close()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# The daemon proper (dfdaemon): the port's Daemon built from a config, its
# object gateway over an fs backend, a `?device=tpu` prefetch onto the
# card, the claim, reads through the gateway and a cut epoch through it
# --------------------------------------------------------------------- #

DFD_GC_INTERVAL = 2.0
DFD_EPOCH_BATCHES = 64
DFD_NOTE_KEY = "chip_smoke.json"


class SinkClock:
    """The first call into a sink manager (a piece, or a finalize that
    backfills), the return of its last piece's landing, the return of its
    last finalize and the pieces handed to it, taken by wrapping the methods of the daemon's own
    ``DeviceSinkManager`` instance; with the manager's ``busy_s`` at
    ``reset``."""

    def __init__(self, sinks: DeviceSinkManager):
        self.sinks = sinks
        self.reset()
        on_piece, finalize = sinks.on_piece, sinks.finalize

        async def timed_on_piece(*args):
            if self.first is None:
                self.first = time.perf_counter()
            self.pieces += 1
            await on_piece(*args)
            self.last_piece = time.perf_counter()

        async def timed_finalize(*args):
            if self.first is None:
                self.first = time.perf_counter()
            try:
                return await finalize(*args)
            finally:
                self.finalized = time.perf_counter()

        sinks.on_piece, sinks.finalize = timed_on_piece, timed_finalize

    def reset(self) -> None:
        self.first = self.finalized = self.last_piece = None
        self.pieces = 0
        self.busy_from = self.sinks.busy_s


def epoch_split(recorder: flight.FlightRecorder, requests: list) -> dict:
    """Where an epoch sample's time goes. ``requests`` holds each sample's
    ``read_object_range`` wall at the client and its ranged task's id.
    The recorder still holds the flights of the newest tasks: each is
    folded (``flight.analyze``), and the sample's wall splits into its
    task's phases, the task's unphased rest (``other``) and the time
    outside the task (the HTTP exchange and the handler thread's entry
    into the daemon's loop and out of it)."""
    folds, outside = [], []
    for wall, task_id in requests:
        tf = recorder.get(task_id) if task_id else None
        if tf is not None and tf.state == "done":
            f = flight.analyze(tf)
            folds.append(f)
            outside.append(wall - f["wall_s"])
    events: dict = {}
    for f in folds:
        for name, n in f["event_counts"].items():
            events[name] = events.get(name, 0) + n
    return {"requests": len(requests),
            "request": _quantiles([w for w, _ in requests]),
            "tasks_folded": len(folds),
            "task_wall": _quantiles([f["wall_s"] for f in folds]),
            "phases_s": {ph: sum(f["phases"][ph] for f in folds)
                         for ph in flight.PHASES},
            "other_s": sum(f["other_s"] for f in folds),
            "outside_task": _quantiles(outside),
            "event_counts": events}


def split_line(sp: dict) -> str:
    """One printed line of an epoch split: the folded samples' walls
    summed and each part's share of them."""
    whole = sp["task_wall"]["sum_s"] + sp["outside_task"]["sum_s"]
    parts = {**{k: v for k, v in sp["phases_s"].items() if v > 0},
             "other": sp["other_s"],
             "outside the task": sp["outside_task"]["sum_s"]}
    shares = ", ".join(f"{k} {v:.4f} s ({v / whole:.1%})"
                       for k, v in parts.items())
    r, t, o = sp["request"], sp["task_wall"], sp["outside_task"]
    return (f"a sample's request at the client p50 {r['p50_s'] * 1e3:.3f} "
            f"ms, p99 {r['p99_s'] * 1e3:.3f} ms over {sp['requests']}; its "
            f"ranged task p50 {t['p50_s'] * 1e3:.3f} ms, p99 "
            f"{t['p99_s'] * 1e3:.3f} ms, outside it p50 "
            f"{o['p50_s'] * 1e3:.3f} ms, p99 {o['p99_s'] * 1e3:.3f} ms; the "
            f"{sp['tasks_folded']} folded samples' {whole:.4f} s = {shares};"
            f" events {json.dumps(sp['event_counts'], sort_keys=True)}")


def _host_equal(data, content: np.ndarray, off: int) -> bool:
    """Whether ``data`` (bytes-like) is ``content`` at ``off``."""
    got = np.frombuffer(data, np.uint8)
    return got.size == content[off:off + got.size].size and bool(
        np.array_equal(got, content[off:off + got.size]))


async def _stream_equal(store: Dfstore, bucket: str, key: str,
                        content: np.ndarray) -> int:
    """Stream a whole object through the gateway, each chunk held to the
    host bytes at its offset; returns the bytes streamed."""
    off = 0
    async for chunk in await store.stream_object(bucket, key):
        if not _host_equal(chunk, content, off):
            raise AssertionError(f"dfdaemon: GET of {key} differs from the "
                                 f"host bytes in {off}..{off + len(chunk)}")
        off += len(chunk)
    return off


async def _dfdaemon(root: str, content: np.ndarray, spans: dict, layout,
                    shard_keys: list[str], ids: np.ndarray, seed: int,
                    device: torch.device, epoch_batches: int,
                    batch: int) -> dict:
    objects = os.path.join(root, "objects")
    sched = StandInScheduler(_NoParent(), host_record("chip-dfdaemon-sched"))
    addr = await sched.serve()
    config = DaemonConfig.from_dict({
        "work_home": os.path.join(root, "home"),
        "host": {"hostname": "chip-dfdaemon", "ip": P2P_HOST},
        "scheduler": {"addrs": [addr]},
        "metrics_port": 0,
        "gc_interval": DFD_GC_INTERVAL,
        "tpu_sink": {"enabled": True, "batch_pieces": BATCH_PIECES},
        "object_storage": {"enabled": True, "backend": "fs",
                           "backend_options": {"root": objects}}})
    d = Daemon(config, device=device)
    gc_runs, reclaimed, live_reclaimed = [], [], []
    storage_gc = d.storage.gc

    def counted_gc():
        # A failed task's store (the loader's index misses) is invalid and
        # the GC's to reclaim; a live one must survive it.
        invalid = {s.metadata.task_id for s in d.storage.tasks()
                   if s.metadata.invalid}
        got = storage_gc()
        gc_runs.append(time.perf_counter())
        reclaimed.extend(got)
        live_reclaimed.extend(t for t in got if t not in invalid)
        return got

    d.storage.gc = counted_gc
    sinks = d.task_manager.device_sinks
    clock = SinkClock(sinks)
    t0 = time.perf_counter()
    await d.start()
    out = {"start_s": time.perf_counter() - t0}
    host_id = d.announcer.host_id
    store = Dfstore(f"http://{P2P_HOST}:{d.object_storage.port}",
                    timeout=600.0)
    url = d.object_storage.backend.object_url(GATEWAY_BUCKET, GATEWAY_KEY)
    host = torch.from_numpy(content).to(device)
    try:
        note = json.dumps({"source": "chip_smoke", "key": GATEWAY_KEY,
                           "bytes": int(content.size)}).encode()
        digest = await store.put_object(GATEWAY_BUCKET, DFD_NOTE_KEY, note,
                                        mode="write_back")
        if digest != "sha256:" + hashlib.sha256(note).hexdigest():
            raise AssertionError(f"dfdaemon: PUT answered {digest}")
        out["put"] = {"bytes": len(note), "digest": digest}

        # The prefetch onto the card, through the gateway.
        await asyncio.sleep(0)
        clock.reset()
        _sync(device)
        base = _memory_mark(device)
        zero_launches()
        t0 = time.perf_counter()
        resp = await store.prefetch_object(GATEWAY_BUCKET, GATEWAY_KEY,
                                           device="tpu")
        _sync(device)
        wall = time.perf_counter() - t0
        task_id = resp["task_id"]
        land_s = clock.finalized - clock.first
        busy = sinks.busy_s - clock.busy_from
        prefetched = sinks.get(task_id)
        out["prefetch"] = {
            "answer": resp, "wall_s": wall, "land_s": land_s,
            "sink_busy_s": busy, "sink_busy_share": busy / land_s,
            "launches": checksum.launch_counts(),
            "peak_device_bytes": _memory_mark(device, peak=True) - base,
            "scheduler": (await sched.summary(task_id)).get(task_id, {})}
        if prefetched is not None:
            out["prefetch"].update({key: getattr(prefetched.sink, key) for key
                                    in ("host_checksum_s", "stage_s",
                                        "stage_wait_s")})

        # The claim: a reuse hit that takes the prefetched sink.
        clock.reset()
        registered = len(sched.records)
        origin_before = dict(d.piece_manager.timings)
        zero_launches()
        t0 = time.perf_counter()
        result = await download_to_device(d, url, tag=GATEWAY_BUCKET)
        claim_s = time.perf_counter() - t0
        claim_launches = checksum.launch_counts()
        u8 = result.as_bytes_array()
        verify_u8_against_host(u8, result.sink.sink.piece_size,
                               result.sink.sink.host_checksums)
        tensors = result.load_safetensors()
        _sync(device)
        equal = bool(torch.equal(u8, host))
        bad = [name for name, _ in layout
               if tensors[name].dtype != torch.bfloat16
               or not torch.equal(tensors[name].reshape(-1).view(torch.uint8),
                                  host[spans[name][0]:spans[name][1]])]
        out["claim"] = {
            "claim_s": claim_s, "from_reuse": result.from_reuse,
            "same_task": result.task_id == task_id,
            "same_sink": result.sink is prefetched,
            "pieces_landed": clock.pieces,
            "origin_read": d.piece_manager.timings != origin_before,
            "new_registrations": len(sched.records) - registered,
            "claim_launches": claim_launches, "equal": equal,
            "tensors": len(tensors), "tensors_differing": bad}
        tensors = u8 = result = prefetched = None
        gate = checksum.launch_counts()
        out["gate_launches"] = gate
        out["launches"] = {k: v + gate[k]
                           for k, v in out["prefetch"]["launches"].items()}

        # Reads through the gateway: whole (sendfile off the complete
        # store), a Range window and a ranged task, cold then reused.
        zero_launches()
        t0 = time.perf_counter()
        whole = await _stream_equal(store, GATEWAY_BUCKET, GATEWAY_KEY,
                                    content)
        whole_s = time.perf_counter() - t0
        # 64 MiB + 7 B at an offset on no piece or page boundary.
        a = content.size // 3 + 12345
        b = min(a + (64 << 20) + 6, content.size - 1)
        t0 = time.perf_counter()
        window = await store.get_object(GATEWAY_BUCKET, GATEWAY_KEY,
                                        f"bytes={a}-{b}")
        window_s = time.perf_counter() - t0
        # The tensor closest to 32 MiB (a projection at full width).
        name = min(layout, key=lambda t: abs(
            spans[t[0]][1] - spans[t[0]][0] - (32 << 20)))[0]
        lo, hi = spans[name]
        ranged = []
        for _ in range(2):
            t0 = time.perf_counter()
            attrs, data = await store.read_object_range(GATEWAY_BUCKET,
                                                        GATEWAY_KEY, lo, hi)
            ranged.append({"s": time.perf_counter() - t0, **attrs,
                           "equal": len(data) == hi - lo
                           and _host_equal(data, content, lo)})
        want_id = idgen.task_id_v1(url, tag=GATEWAY_BUCKET,
                                   range_header=f"bytes={lo}-{hi - 1}")
        out["reads"] = {
            "whole_bytes": whole, "whole_s": whole_s,
            "window": [a, b], "window_equal":
                len(window) == b + 1 - a and _host_equal(window, content, a),
            "window_s": window_s, "ranged_tensor": name,
            "ranged_bytes": hi - lo, "ranged": ranged,
            "ranged_task_id_ok": [r["task_id"] == want_id for r in ranged],
            "launches": checksum.launch_counts()}

        # A cut epoch through the gateway into DeviceFeed.
        opts = LoaderOptions(seed=seed, num_hosts=1,
                             interleave=WDS_INTERLEAVE, readahead=WDS_READAHEAD)
        t0 = time.perf_counter()
        loader = await PodShardedLoader(store, WDS_BUCKET, shard_keys,
                                        options=opts).prepare()
        prepare_s = time.perf_counter() - t0
        n = epoch_batches * batch
        plan = [k for _, k in loader.plan(0)][:n]
        record_bytes = ids.shape[2] * 4
        feed = DeviceFeed("tokens", record_bytes, batch, pad=True,
                          device=device)
        got = torch.empty((n, record_bytes), dtype=torch.uint8,
                          pin_memory=_on_card(device))
        keys, row, on_device = [], 0, True
        # Each sample's request timed at the client, with its task id.
        requests, read_range = [], store.read_object_range

        async def timed_read_range(*args, **kwargs):
            t = time.perf_counter()
            attrs, data = await read_range(*args, **kwargs)
            requests.append((time.perf_counter() - t, attrs.get("task_id")))
            return attrs, data

        store.read_object_range = timed_read_range
        _sync(device)
        zero_launches()
        t0 = time.perf_counter()
        async with contextlib.aclosing(loader.epoch(0)) as samples, \
                contextlib.aclosing(feed.batches(samples)) as it:
            async for bt in it:
                on_device &= bt.on_device and bt.array.device.type == \
                    device.type
                got[row:row + len(bt.keys)].copy_(bt.array, non_blocking=True)
                keys += bt.keys
                row += len(bt.keys)
                if row >= n:
                    break
        _sync(device)
        epoch_s = time.perf_counter() - t0
        store.read_object_range = read_range
        epoch_launches = checksum.launch_counts()
        order = np.array([[int(k[:5]), int(k[5:])] for k in keys])
        rows_equal = bool(np.array_equal(
            got.numpy(), ids[order[:, 0], order[:, 1]].view(np.uint8))) \
            if len(keys) == n else False
        out["epoch"] = {
            "prepare_s": prepare_s, "samples": len(keys),
            "batches": -(-len(keys) // batch), "record_bytes": record_bytes,
            "epoch_s": epoch_s, "samples_per_s": len(keys) / epoch_s,
            "in_plan_order": keys == plan, "on_device": on_device,
            "rows_equal": rows_equal, "launches": epoch_launches,
            "outstanding_buffers": loader.pool.stats()["outstanding"],
            "split": epoch_split(d.task_manager.flight, requests)}
        out["stores"] = len(d.storage.tasks())
        # The GC loop has run over the live stores at least once.
        deadline = time.monotonic() + 3 * DFD_GC_INTERVAL
        while not gc_runs and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
    finally:
        await store.close()
        del host
        t0 = time.perf_counter()
        await d.stop()
        out["stop_s"] = time.perf_counter() - t0
        await sched.server.close()
    out["scheduler_hosts"] = {
        "announces": len(sched.announces),
        "announce_keys": sorted(sched.announces[0]) if sched.announces
        else [], "clock_samples": sum("clock" in a for a in sched.announces),
        "left": sched.left, "still_registered": sorted(sched.hosts),
        "host_id": host_id}
    out["gc"] = {"runs": len(gc_runs), "reclaimed_invalid": len(reclaimed),
                 "reclaimed_live": live_reclaimed}
    out["sinks_closed"] = sinks._exec._shutdown
    return out


def phase_dfdaemon(root: str, content: np.ndarray, spans: dict, layout,
                   seed: int, vocab: int, device: torch.device, *,
                   epoch_batches: int = DFD_EPOCH_BATCHES,
                   batch: int = FEED_BATCH, **wds_shape) -> dict:
    """The port's ``Daemon`` from a ``DaemonConfig`` (the device sink at
    the main path's batch, the gateway on an ``fs`` backend whose root
    holds the shard, moved there by the task-kind phases, and the
    ``config4_webdataset`` token shards; the stand-in scheduler; a 2 s GC
    interval): a PUT through the gateway, ``Dfstore.prefetch_object(...,
    device="tpu")`` landing the shard on the card, ``download_to_device``
    claiming that sink (a reuse hit: no second landing, no origin read),
    the whole object, a Range window and a ranged task read through the
    gateway and held to the host bytes, then a cut epoch (the first
    ``epoch_batches`` batches) through the gateway into ``DeviceFeed``,
    held to the host records; ``stop()``. Checks the stand-in scheduler's
    announces and the leave, a GC run that reclaimed nothing, the sinks
    closed, and the launches of each step. The caller owns ``root`` and
    removes it."""
    shard = os.path.join(root, "objects", GATEWAY_BUCKET, GATEWAY_KEY)
    wds_dir = os.path.join(root, "objects", WDS_BUCKET)
    t0 = time.perf_counter()
    shards, ids = wds_shards(seed, vocab, **wds_shape)
    os.makedirs(wds_dir, exist_ok=True)
    for key, data in shards.items():
        with open(os.path.join(wds_dir, key), "wb") as f:
            f.write(data)
    shard_bytes = sum(len(data) for data in shards.values())
    del shards
    make_s = time.perf_counter() - t0
    # The stores: the shard's, the webdataset shards' whole-object
    # stores and the epoch's ranged tasks, with a GiB to spare.
    need = content.size + 2 * shard_bytes + (1 << 30)
    free = shutil.disk_usage(root).free
    if free < need:
        raise RuntimeError(f"the dfdaemon phase needs {need} B free "
                           f"under {root}; {free} B are")
    if os.path.getsize(shard) != content.size:
        raise AssertionError("dfdaemon: the shard's file was not handed "
                             "over whole")
    out = asyncio.run(_dfdaemon(root, content, spans, layout,
                                sorted(os.listdir(wds_dir)), ids, seed,
                                device, epoch_batches, batch))
    out.update(wds_make_s=make_s, wds_shard_bytes=shard_bytes)
    n_pieces = compute_piece_count(content.size,
                                   compute_piece_size(content.size))
    k2 = -(-n_pieces // BATCH_PIECES)
    pre, claim, reads, ep = (out["prefetch"], out["claim"], out["reads"],
                             out["epoch"])
    answer = pre["answer"]
    if (answer["state"], answer["content_length"], answer["from_reuse"],
            answer["device_verified"]) != ("done", content.size, False, True):
        raise AssertionError(f"dfdaemon prefetch: {answer}")
    sched = pre["scheduler"]
    if (sched.get("is_seed") or sched.get("reported") != n_pieces
            or sched.get("messages", {}).get("download_finished") != 1):
        raise AssertionError(f"dfdaemon prefetch at the scheduler: {sched}")
    if not (claim["from_reuse"] and claim["same_task"] and claim["same_sink"]
            and claim["pieces_landed"] == 0 and not claim["origin_read"]
            and claim["equal"]
            and not claim["tensors_differing"]
            and claim["new_registrations"] == 0
            and claim["tensors"] == len(layout)):
        raise AssertionError(f"dfdaemon claim: {claim}")
    if (reads["whole_bytes"] != content.size or not reads["window_equal"]
            or [r["equal"] for r in reads["ranged"]] != [True, True]
            or [r["from_reuse"] for r in reads["ranged"]] != [False, True]
            or reads["ranged_task_id_ok"] != [True, True]):
        raise AssertionError(f"dfdaemon reads: {reads}")
    if not (ep["samples"] == epoch_batches * batch and ep["in_plan_order"]
            and ep["on_device"] and ep["rows_equal"]
            and ep["outstanding_buffers"] == 0
            and ep["split"]["requests"] >= ep["samples"]
            and ep["split"]["tasks_folded"] > 0):
        raise AssertionError(f"dfdaemon epoch: {ep}")
    hosts = out["scheduler_hosts"]
    wire_keys = sorted(host_record("x")) + ["telemetry"]
    if (hosts["announces"] < 2 or hosts["clock_samples"] < 1
            or hosts["announce_keys"] != sorted(wire_keys)
            or hosts["left"] != [hosts["host_id"]]
            or hosts["still_registered"]):
        raise AssertionError(f"dfdaemon: the scheduler saw {hosts}")
    if out["gc"]["runs"] < 1 or out["gc"]["reclaimed_live"]:
        raise AssertionError(f"dfdaemon: GC {out['gc']}")
    if not out["sinks_closed"]:
        raise AssertionError("dfdaemon: the sink manager is still open")
    if _on_card(device):
        want = {"chunk_checksums": 2, "land_and_checksum": k2,
                "gear_candidates": 0}
        none = {"chunk_checksums": 0, "land_and_checksum": 0,
                "gear_candidates": 0}
        for what, got, w in (
                ("prefetch", pre["launches"], {**want, "chunk_checksums": 0}),
                ("claim", claim["claim_launches"], none),
                ("gate after the claim", out["gate_launches"],
                 {**none, "chunk_checksums": 2}),
                ("prefetch and claim", out["launches"], want),
                ("reads", reads["launches"], none),
                ("epoch", ep["launches"], {**none, "land_and_checksum":
                                           epoch_batches})):
            if got != w:
                raise AssertionError(f"dfdaemon {what}: launches {got}, "
                                     f"want {w}")
    out["want_k2"] = k2
    return out


# --------------------------------------------------------------------- #
# The proxy: the port's Daemon as a registry mirror and an intercepting
# proxy in front of a stand-in HTTPS registry. Mirror pull -> Proxy ->
# P2PTransport -> stream task (back-to-source over TLS) -> the store; the
# hijacked pull: CONNECT -> start_tls with a forged leaf -> sendfile off
# the store through TLS; the pass-through on http.client; then
# Daemon.Download (device "tpu") off the proxy-filled store -> K2 -> K1
# --------------------------------------------------------------------- #

REGISTRY_REPO = "tpu-p2p/weights"


class _RegistryServer(ThreadingHTTPServer):
    """``http.server`` over TLS: each connection is wrapped, and its
    handshake made, on its own thread."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, addr, handler, ctx: ssl.SSLContext):
        super().__init__(addr, handler)
        self.ctx = ctx
        self.mu = threading.Lock()
        self.counts: dict = {}

    def finish_request(self, request, client_address):
        try:
            request = self.ctx.wrap_socket(request, server_side=True)
        except (ssl.SSLError, OSError):
            return
        super().finish_request(request, client_address)

    def count(self, path: str, n: int) -> None:
        with self.mu:
            c = self.counts.setdefault(path, [0, 0])
            c[0] += 1
            c[1] += n


class _RegistryHandler(BaseHTTPRequestHandler):
    """A stand-in OCI registry: one blob (the shard's file, ranged GETs
    answered 206) and its manifest; requests and bytes counted by path."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def do_GET(self):
        srv = self.server
        if self.path == srv.manifest_path:
            body = srv.manifest
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/vnd.oci.image.manifest.v1+json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Docker-Content-Digest", "sha256:" +
                             hashlib.sha256(body).hexdigest())
            self.end_headers()
            self.wfile.write(body)
            srv.count(self.path, len(body))
            return
        if self.path != srv.blob_path:
            self.send_error(404)
            return
        total = srv.size
        start, end = 0, total - 1
        rng = self.headers.get("Range")
        if rng:
            a, _, b = rng.split("=", 1)[1].partition("-")
            start, end = int(a), min(int(b) if b else total - 1, total - 1)
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {start}-{end}/{total}")
        else:
            self.send_response(200)
        n = end - start + 1
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(n))
        self.end_headers()
        buf = memoryview(bytearray(min(n, 4 << 20)))
        sent = 0
        try:
            while sent < n:
                k = os.preadv(srv.fd, [buf[:n - sent]], start + sent)
                self.wfile.write(buf[:k])
                sent += k
        finally:
            srv.count(self.path, sent)


def _registry_child(conn, path: str, sha: str, cert_pem: bytes,
                    key_pem: bytes) -> None:
    """The body of ``StandInRegistry``'s process: serve the blob and its
    manifest over TLS until told to stop; answer the request counts."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    with tempfile.NamedTemporaryFile(suffix=".pem") as f:
        f.write(cert_pem + key_pem)
        f.flush()
        ctx.load_cert_chain(f.name)
    srv = _RegistryServer((P2P_HOST, 0), _RegistryHandler, ctx)
    srv.fd = os.open(path, os.O_RDONLY)
    srv.size = os.fstat(srv.fd).st_size
    srv.blob_path = f"/v2/{REGISTRY_REPO}/blobs/{sha}"
    srv.manifest_path = f"/v2/{REGISTRY_REPO}/manifests/latest"
    srv.manifest = json.dumps({
        "schemaVersion": 2,
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "layers": [{"mediaType": "application/octet-stream", "digest": sha,
                    "size": srv.size}]}).encode()
    thread = threading.Thread(target=srv.serve_forever,
                              name="df-registry-accept", daemon=True)
    thread.start()
    try:
        conn.send({"port": srv.server_address[1], "manifest": srv.manifest,
                   "blob_path": srv.blob_path,
                   "manifest_path": srv.manifest_path})
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                conn.send(None)
                return
            with srv.mu:
                conn.send({p: list(c) for p, c in srv.counts.items()})
    finally:
        srv.shutdown()
        srv.server_close()
        os.close(srv.fd)


class StandInRegistry(StandInProcess):
    """A stand-in HTTPS registry in a process of its own (spawned), with a
    leaf ``cert_pem``/``key_pem`` forged by a CA of its own: the shard's
    file as ``/v2/tpu-p2p/weights/blobs/<sha>`` and a JSON manifest as
    ``.../manifests/latest``. ``endpoint()`` gives its port, the
    manifest's bytes and both paths; ``requests()`` the requests and bytes
    by path."""

    def __init__(self, path: str, sha: str, cert_pem: bytes, key_pem: bytes):
        super().__init__(None, path, sha, cert_pem, key_pem)

    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_registry_child,
                                 args=(child, *self._args), daemon=True,
                                 name="df-standin-registry")
        self._proc.start()
        child.close()


def _pull(conn: http.client.HTTPConnection, path: str,
          headers: dict | None = None, keep: bool = False) -> dict:
    """One GET on ``conn``: its status, length, sha256, time to the
    answer's head and wall time; with ``keep`` its body."""
    t0 = time.perf_counter()
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    head_s = time.perf_counter() - t0
    h = hashlib.sha256()
    buf = memoryview(bytearray(8 << 20))
    n, kept = 0, []
    while k := resp.readinto(buf):
        h.update(buf[:k])
        if keep:
            kept.append(bytes(buf[:k]))
        n += k
    out = {"status": resp.status, "bytes": n,
           "sha256": "sha256:" + h.hexdigest(), "head_s": head_s,
           "wall_s": time.perf_counter() - t0,
           "content_range": resp.getheader("Content-Range")}
    if keep:
        out["body"] = b"".join(kept)
    return out


def _vias() -> dict:
    return {v: (PROXY_REQUESTS.value(v), PROXY_BYTES.value(v))
            for v in ("p2p", "direct", "hijack", "tunnel")}


def _via_delta(before: dict) -> dict:
    now = _vias()
    return {v: [now[v][0] - before[v][0], now[v][1] - before[v][1]]
            for v in now if now[v] != before[v]}


def range_window(total: int) -> tuple[int, int]:
    """The Range asked inside the tunnel: 64 MiB + 7 B at an offset on no
    piece or page boundary."""
    a = total // 5 + 4321
    return a, min(a + (64 << 20) + 6, total - 1)


async def _proxy(root: str, content: np.ndarray, reg: StandInRegistry,
                 info: dict, device: torch.device) -> dict:
    sched = StandInScheduler(_NoParent(), host_record("chip-proxy-sched"))
    addr = await sched.serve()
    reg_url = f"https://{P2P_HOST}:{info['port']}"
    config = DaemonConfig.from_dict({
        "work_home": os.path.join(root, "home"),
        "host": {"hostname": "chip-proxy", "ip": P2P_HOST},
        "scheduler": {"addrs": [addr]},
        "metrics_port": -1, "gc_interval": 3600,
        "tpu_sink": {"enabled": True, "batch_pieces": BATCH_PIECES},
        "qos": {"enabled": True},
        # The stand-in registry's port is ephemeral: off the default
        # white list [443, 80], its CONNECT would be refused (403).
        "proxy": {"enabled": True, "registry_mirror": reg_url,
                  "hijack_https": True,
                  "hijack_hosts": [f"^{re.escape(P2P_HOST)}$"],
                  "white_list_ports": [443, 80, info["port"]]}})
    t0 = time.perf_counter()
    d = Daemon(config, device=device)
    sinks = d.task_manager.device_sinks
    clock = SinkClock(sinks)
    await d.start()
    out = {"start_s": time.perf_counter() - t0}
    port = d.proxy.port
    blob, manifest = info["blob_path"], info["manifest_path"]
    loop = asyncio.get_running_loop()
    plain = http.client.HTTPConnection(P2P_HOST, port, timeout=600)
    tunnel = http.client.HTTPSConnection(
        P2P_HOST, port, timeout=600, context=d.proxy.ca.trust_context())
    tunnel.set_tunnel(P2P_HOST, info["port"])
    host = torch.from_numpy(content).to(device)
    url = reg_url + blob
    task_id = FileTaskRequest(url=url, output="").task_id()

    async def store_done(t0: float) -> float:
        """Seconds from ``t0`` until the blob's store is complete."""
        while d.storage.find_completed_task(task_id) is None:
            await asyncio.sleep(0.005)
        return time.perf_counter() - t0

    try:
        zero_launches()
        steps = {}
        for what, conn, path, headers, keep in (
                ("mirror", plain, blob, None, False),
                ("hijack", tunnel, blob, None, False),
                ("range", tunnel, blob, {"Range": "bytes={}-{}".format(
                    *range_window(content.size))}, True),
                ("direct", plain, manifest, None, True)):
            before, vias = reg.requests(), _vias()
            # The mirror pull's split: the back-to-source (the store
            # complete) against the client's last byte.
            done = (asyncio.ensure_future(store_done(time.perf_counter()))
                    if what == "mirror" else None)
            r = await loop.run_in_executor(None, _pull, conn, path, headers,
                                           keep)
            if done is not None:
                r["store_done_s"] = await asyncio.wait_for(done, 60)
            await asyncio.sleep(0.05)   # the proxy counts after its write
            r["registry"] = _origin_delta(before, reg.requests())
            r["via"] = _via_delta(vias)
            steps[what] = r
        out["pull_launches"] = checksum.launch_counts()
        a, b = range_window(content.size)
        rng = steps["range"]
        rng["equal"] = _host_equal(rng.pop("body"), content, a) and \
            rng["bytes"] == b - a + 1
        man = steps["direct"]
        man["equal"] = man.pop("body") == info["manifest"]
        out["steps"] = steps

        # Onto the card, off the store the proxy filled.
        # The stream task's store is the file task's: one task id.
        out["same_task"] = d.storage.find_completed_task(
            task_id) is not None
        cli = Client(NetAddr.unix(config.unix_sock))
        before = reg.requests()
        clock.reset()
        _sync(device)
        zero_launches()
        t0 = time.perf_counter()
        try:
            stream = await cli.open_stream("Daemon.Download", {
                "url": url, "device": "tpu"})
            frames = []
            while (msg := await stream.recv(timeout=600.0)) is not None:
                frames.append(msg)
        finally:
            await cli.close()
        last = frames[-1]
        sink = sinks.take(task_id)
        u8 = sink.as_bytes_array()
        verify_u8_against_host(u8, sink.sink.piece_size,
                               sink.sink.host_checksums)
        _sync(device)
        wall = time.perf_counter() - t0
        out["device"] = {
            "answer": {k: last.get(k) for k in (
                "state", "task_id", "content_length", "from_reuse",
                "from_p2p", "device_verified")},
            "wall_s": wall, "land_s": clock.finalized - clock.first,
            "sink_busy_s": sinks.busy_s - clock.busy_from,
            "pieces": clock.pieces, "equal": bool(torch.equal(u8, host)),
            "launches": checksum.launch_counts(),
            "registry": _origin_delta(before, reg.requests())}
        sink = u8 = None
        out["registry_total"] = reg.requests()
    finally:
        plain.close()
        tunnel.close()
        del host
        t0 = time.perf_counter()
        await d.stop()
        out["stop_s"] = time.perf_counter() - t0
        await sched.server.close()
    return out


def phase_proxy(root: str, content: np.ndarray, sha: str,
                device: torch.device) -> dict:
    """The port's ``Daemon`` as a registry mirror and an intercepting
    proxy (``proxy.enabled``, ``hijack_https`` for the registry's host, its
    ephemeral port white-listed; ``qos.enabled``; the device sink; the
    stand-in scheduler with no parent) in front of ``StandInRegistry``
    over the shard's file (``root/objects/...``, which the dfdaemon phase
    served), its leaf forged by a second ``CertAuthority``, which the
    daemon trusts through ``DRAGONFLY_SSL_CA_FILE``: the blob through the
    mirror (plaintext to the client, TLS to the registry: back-to-source
    into the store), the same blob through a hijacked CONNECT trusting
    only the daemon's CA (no registry request: off the store by
    ``sendfile`` through TLS), a Range inside the tunnel (206, the exact
    bytes), the manifest passed through (``via="direct"``), then
    ``Daemon.Download`` of the blob's registry URL with ``device: "tpu"``
    off the proxy-filled store (no registry request): the verified buffer
    gated by K1 and held to every byte. The caller owns ``root``."""
    shard = os.path.join(root, "objects", GATEWAY_BUCKET, GATEWAY_KEY)
    need = content.size + (1 << 30)      # one more store, a GiB to spare
    free = shutil.disk_usage(root).free
    if free < need:
        raise RuntimeError(f"the proxy phase needs {need} B free under "
                           f"{root}; {free} B are")
    proxy_root = os.path.join(root, "proxy")
    os.makedirs(proxy_root)
    registry_ca = CertAuthority.generate(common_name="chip-registry-ca")
    bundle = os.path.join(proxy_root, "registry-ca.pem")
    with open(bundle, "wb") as f:
        f.write(registry_ca.ca_cert_pem)
    reg = StandInRegistry(shard, sha, *registry_ca.forge_leaf(P2P_HOST))
    env = os.environ.get("DRAGONFLY_SSL_CA_FILE")
    try:
        reg.start()
        info = reg.endpoint()
        os.environ["DRAGONFLY_SSL_CA_FILE"] = bundle
        out = asyncio.run(_proxy(proxy_root, content, reg, info, device))
    finally:
        if env is None:
            os.environ.pop("DRAGONFLY_SSL_CA_FILE", None)
        else:
            os.environ["DRAGONFLY_SSL_CA_FILE"] = env
        reg.close()
        shutil.rmtree(proxy_root, ignore_errors=True)
    n_pieces = compute_piece_count(content.size,
                                   compute_piece_size(content.size))
    k2 = -(-n_pieces // BATCH_PIECES)
    steps, dev = out["steps"], out["device"]
    blob = info["blob_path"]
    mirror, hijack = steps["mirror"], steps["hijack"]
    for what, r in (("mirror", mirror), ("hijack", hijack)):
        if (r["status"], r["bytes"], r["sha256"]) != (200, content.size, sha):
            raise AssertionError(f"proxy {what}: {r}")
    if (blob not in mirror["registry"]
            or mirror["registry"][blob][1] < content.size
            or mirror["via"].get("p2p", [0])[0] != 1):
        raise AssertionError(f"proxy mirror: {mirror}")
    if (hijack["registry"] or hijack["via"].get("hijack", [0])[0] != 1
            or hijack["via"].get("p2p") != [1, content.size]):
        raise AssertionError(f"proxy hijack: {hijack}")
    a, b = range_window(content.size)
    rng = steps["range"]
    if (rng["status"] != 206 or not rng["equal"] or rng["registry"]
            or rng["content_range"] != f"bytes {a}-{b}/{content.size}"):
        raise AssertionError(f"proxy range: {rng}")
    man = steps["direct"]
    if (man["status"] != 200 or not man["equal"]
            or man["via"].get("direct", [0])[0] != 1
            or set(man["registry"]) != {info["manifest_path"]}):
        raise AssertionError(f"proxy pass-through: {man}")
    answer = dev["answer"]
    if (answer["state"] != "done" or answer["content_length"] != content.size
            or not answer["from_reuse"] or not answer["device_verified"]
            or not dev["equal"] or dev["registry"] or not out["same_task"]):
        raise AssertionError(f"proxy onto the card: {dev} "
                             f"{out['same_task']}")
    none = {"chunk_checksums": 0, "land_and_checksum": 0,
            "gear_candidates": 0}
    if out["pull_launches"] != none:
        raise AssertionError(f"proxy pulls launched {out['pull_launches']}")
    if _on_card(device) and dev["launches"] != {
            "chunk_checksums": 2, "land_and_checksum": k2,
            "gear_candidates": 0}:
        raise AssertionError(f"proxy onto the card: launches "
                             f"{dev['launches']}, want K1 2, K2 {k2}")
    out["launches"] = dev["launches"]
    out["want_k2"] = k2
    return out


# --------------------------------------------------------------------- #
# The entry and bench pair: entry(), the train step, the device bench
# --------------------------------------------------------------------- #

# entry()'s shapes: the JAX entry's (2 batches of 4 pieces of 4 KiB), and
# bench.py's production shape (8 batches of 16 pieces of 4 MiB, 512 MiB).
ENTRY_SHAPES = (("jax", {}),
                ("bench", {"piece_words": 1 << 20, "batch_pieces": 16,
                           "n_batches": 8}))
ENTRY_K2 = 2 + 8          # one K2 launch per batch
# The train step at Llama-3.1-8B's MLP widths, then at the JAX dryrun's.
TRAIN_SHAPES = (("full width", {"d_model": LLAMA_8B["hidden"],
                                "d_ff": LLAMA_8B["inter"], "batch": 8}),
                ("jax", {}))
# The train step against its plain version: float32 on both sides.
TRAIN_RTOL, TRAIN_ATOL = 1e-6, 1e-7


def phase_entry(device: torch.device) -> dict:
    """``entry()`` at each of ``ENTRY_SHAPES``, its inputs drawn first;
    the launches counted from 0 just before the calls and read just
    after; then each output held bit for bit against K2's plain version
    on the same inputs, against the batches themselves, and, for the
    first and last piece, against ``checksum_numpy`` on the host."""
    staged = [(name, *pentry.entry(device, **kw)) for name, kw in ENTRY_SHAPES]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    outs = [fn(*args) for _, fn, args in staged]
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = checksum.launch_counts()
    shapes = {}
    for (name, _, args), got in zip(staged, outs):
        want = pentry.land_batches(args,
                                   land=checksum.land_and_checksum_torch)
        check_equal(f"entry at the {name} shape", zip(got, want))
        if not torch.equal(got[0], torch.cat([a.reshape(-1) for a in args])):
            raise AssertionError(f"entry at the {name} shape: flat differs "
                                 "from the batches")
        k, pw = args[0].shape
        sums = checksum.to_u32(got[1]).cpu().numpy()
        xors = checksum.to_u32(got[2]).cpu().numpy()
        for i in (0, len(args) * k - 1):
            piece = got[0][i * pw:(i + 1) * pw].cpu().numpy().tobytes()
            if (int(sums[i]), int(xors[i])) != checksum.checksum_numpy(piece):
                raise AssertionError(f"entry at the {name} shape: piece {i} "
                                     "checksums differ from the host's")
        shapes[name] = {"batches": len(args), "batch_pieces": k,
                        "piece_words": pw, "bytes": got[0].numel() * 4,
                        "max_abs_err": max_abs_err(zip(got, want))}
    del staged, outs
    return {"shapes": shapes, "path_s": path_s, "launches": launches}


def phase_train(device: torch.device) -> dict:
    """``dryrun_multichip(1)`` on the card (one NCCL rank in a child
    process) at each of ``TRAIN_SHAPES``; the launches are the rank
    processes' own, counted from 0 just before each step and summed over
    the runs. Each result is held against ``train_step_plain`` (the same
    step on this device, no process group) within
    ``TRAIN_RTOL``/``TRAIN_ATOL``, its words exactly and its zeros in
    ``w1`` exactly."""
    runs = []
    for name, kw in TRAIN_SHAPES:
        t0 = time.perf_counter()
        runs.append((name, pentry.dryrun_multichip(1, device=device,
                                                   timeout_s=300, **kw),
                     time.perf_counter() - t0))
    launches = {kname: sum(r.launches[kname] for _, r, _ in runs)
                for kname in runs[0][1].launches}
    out = {"launches": launches}
    for name, r, wall_s in runs:
        words = pentry.checkpoint_words(1, r.d_model, r.d_ff)
        if not np.array_equal(r.words, words[:r.d_model * r.d_ff // 2]):
            raise AssertionError(f"train at {name}: gathered words differ")
        w_dev = torch.from_numpy(words.view(np.int32)).to(device)
        zeros = int((pentry.weights_from_words(w_dev, r.d_model, r.d_ff)
                     == 0).sum())
        del w_dev
        loss, w1, w2 = pentry.train_step_plain(words, r.d_model, r.d_ff,
                                               r.batch, device)
        errs = {}
        for what, got, want in (
                ("loss", torch.tensor([r.loss], dtype=torch.float64),
                 torch.tensor([loss], dtype=torch.float64)),
                ("w1", torch.from_numpy(r.w1).to(device), w1),
                ("w2", torch.from_numpy(r.w2).to(device), w2)):
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"train at {name}: non-finite {what}")
            if not torch.allclose(got, want, rtol=TRAIN_RTOL,
                                  atol=TRAIN_ATOL):
                raise AssertionError(f"train at {name}: {what} differs from "
                                     "the plain step")
            errs[what] = float((got - want).abs().max())
        if r.zeros != zeros:
            raise AssertionError(f"train at {name}: {r.zeros} zeros in w1, "
                                 f"the plain step has {zeros}")
        del w1, w2
        torch.cuda.empty_cache()
        out[name] = {"d_model": r.d_model, "d_ff": r.d_ff, "batch": r.batch,
                     "dp": r.dp, "tp": r.tp, "loss": r.loss,
                     "w1_bytes_landed": r.d_model * r.d_ff * 2,
                     "zeros": r.zeros, "max_abs_err": errs,
                     "fabric_s": r.fabric_s, "step_s": r.step_s,
                     "peak_device_bytes": r.peak_device_bytes,
                     "wall_s": wall_s}
    return out


def phase_bench(device: torch.device, smi: str) -> dict:
    """The bench module's measurements (``bench.measure``), launches
    counted from 0 just before and read just after; its sink smoke must
    pass."""
    torch.cuda.synchronize()
    zero_launches()
    line = bench.measure(device, smi)
    torch.cuda.synchronize()
    launches = checksum.launch_counts()
    if line["sink_smoke"] != "ok":
        raise AssertionError(f"bench sink smoke: {line['sink_smoke']}")
    return {"line": line, "launches": launches}


# The bench's launches. K2: entry()'s step is 8 launches (512 MiB in
# batches of 16 x 4 MiB), called 1 + 10 + 3 x 10 times by device_time and
# once more for the copy's source: 42 x 8 = 336; the sink smoke's 9 pieces
# flush in 3 batches of up to 4. K1: the swap gate over 64 whole pieces is
# one launch a call, warmed once and timed 5 times; K1 alone 1 + 10 + 3 x
# 10 times; the sink smoke's gate 2 (8 whole pieces, then the short last).
BENCH_LAUNCHES = {"chunk_checksums": 6 + 41 + 2,
                  "land_and_checksum": 42 * 8 + 3}


def check_launches(paths: dict, want_k2_main: int, want_k2_feed: int,
                   want_k3_chunker: int, want_k3_manifest: int,
                   want_k2_wds: int, want_k3_gateway: int,
                   want_k2_daemon: int, want_k2_p2p: int,
                   want_k2_pex: int, want_k2_seed: int,
                   want_k2_dfdaemon: int, want_k2_dfdaemon_epoch: int,
                   want_k2_proxy: int, want_k2_swarm: int,
                   want_k2_manager_preheat: int, want_k2_cli: int,
                   want_k2_observe: int) -> None:
    """Each path's launches, counted from 0 just before it: K2 once per
    flushed batch of the main path, once per feed batch (the token feed's
    and the webdataset epoch's) and once per batch of each ``entry()``
    call, never on a hot swap; K1 twice in each verify gate (whole pieces,
    then the short last piece), never in a feed or ``entry()``; neither on
    the mesh path, which moves verified bytes and folds nothing, nor in
    the train step, which lands through collectives; the bench's
    ``BENCH_LAUNCHES``; K3 once for each started scan block of each feed:
    of the chunker runs, of the span reads of a whole-shard manifest (the
    manifest path, and the cdc swap's fallback) and of the stream chunks
    of the gateway manifest's build (its hit launches none); nowhere
    else. The daemon path: K2 once per batch of each of its landings (the
    cold request's, the warm one's backfill, the sharded one's ranged
    tasks, the digest request's), K1 twice in the gate after each of its
    three whole landings. The p2p path: K2 once per batch of each of its
    two landings from the parent, K1 twice in the gate after each. The pex
    path: K2 once per batch of its landing from the holder, K1 twice in
    the gate after it. The
    daemon_delta path: K3 once for each started scan block of the base
    manifest's span reads inside the delta task, K1 twice in the swap's
    gate, no K2. The seed path: K2 once per batch as the seed lands, K1
    twice in the gate after the take; the seed_again path: K2 once per
    batch as the second trigger lands the device copy again from the
    store, no K1. The dfdaemon path: K2 once per batch as the gateway's
    prefetch lands the shard, none in the claim or the reads through the
    gateway, K1 twice in the gate after the claim; the dfdaemon_epoch
    path: K2 once a batch of the cut epoch. The p2p_qos path (the gated
    pull) and the proxy path (its pulls launch nothing; the landing off
    the proxy-filled store): K2 once per batch of the landing, K1 twice in
    the gate after it. The swarm path: K2 once per batch of each of its
    four children's landings (two of the shard, two of its quarter), K1
    twice in the gate after each. The manager_preheat path: K2 once per
    batch as the job's seed lands the shard, K1 twice in the gate after
    the take. The cli path: K2 once per batch as the child (in this
    process) lands the shard for ``dfget --device tpu``, K1 twice in the
    gate after the take (the cold host lands in a process of its own).
    The observe path: the same as the cli path's child, for the landing
    with the observability plane on; observe_off the same for its pair,
    the landing with it off."""
    def k(k1, k2, k3=0):
        return {"chunk_checksums": k1, "land_and_checksum": k2,
                "gear_candidates": k3}

    want = {"main": k(2, want_k2_main), "hot_swap": k(2, 0),
            "mesh": k(0, 0), "feed": k(0, want_k2_feed),
            "entry": k(0, ENTRY_K2), "train": k(0, 0),
            "bench": {**BENCH_LAUNCHES, "gear_candidates": 0},
            "chunker": k(0, 0, want_k3_chunker),
            "manifest": k(0, 0, want_k3_manifest),
            "cdc_swap": k(2, 0, want_k3_manifest),
            "wds": k(0, want_k2_wds),
            "gateway_manifest": k(0, 0, want_k3_gateway),
            "daemon": k(6, want_k2_daemon), "p2p": k(4, want_k2_p2p),
            "pex": k(2, want_k2_pex),
            "daemon_delta": k(2, 0, want_k3_manifest),
            "seed": k(2, want_k2_seed), "seed_again": k(0, want_k2_seed),
            "dfdaemon": k(2, want_k2_dfdaemon),
            "dfdaemon_epoch": k(0, want_k2_dfdaemon_epoch),
            "p2p_qos": k(2, want_k2_proxy), "proxy": k(2, want_k2_proxy),
            "swarm": k(8, want_k2_swarm),
            "manager_preheat": k(2, want_k2_manager_preheat),
            "cli": k(2, want_k2_cli), "observe": k(2, want_k2_observe),
            "observe_off": k(2, want_k2_observe)}
    if paths != want:
        raise AssertionError(f"launches by path {paths}, want {want}")


def compare_parent(root: str, n_pieces: int, pw: int, gen, device) -> dict:
    """The kernels of another checkout (``root``, the parent commit)
    against this tree's, timed by ``device_time`` in turns (parent, this,
    this, parent): K1 over the shard's pieces, K2 at the main path's
    shape and at the feed's (16 input sets in turn). The parent's
    wrappers zeroed both outputs before each launch, so its times hold
    those two memsets, as its calls did. Each pair's results are checked
    equal first."""
    src = os.path.join(root, "dragonfly2_tpu_torch", "csrc", "checksum.cu")
    path = _build.library_path(src)
    log = _build.compile_source(path, src) if not os.path.exists(path) else ""
    lib = ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.df_chunk_checksums.argtypes = [p, i64, i64, p, p, p]
    lib.df_land_and_checksum.argtypes = [p, i64, p, p, i64, i64, p, p, p]

    def zeros(k):
        return (torch.zeros(k, dtype=torch.int32, device=device),
                torch.zeros(k, dtype=torch.int32, device=device))

    def old_k1(words):
        sums, xors = zeros(n_pieces)
        code = lib.df_chunk_checksums(
            words.data_ptr(), n_pieces, pw, sums.data_ptr(), xors.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise AssertionError(f"parent chunk_checksums: CUDA error {code}")
        return sums, xors

    def old_k2(buf, pieces, slots):
        k, piece_words = pieces.shape
        sums, xors = zeros(k)
        code = lib.df_land_and_checksum(
            buf.data_ptr(), buf.numel() // piece_words, pieces.data_ptr(),
            slots.data_ptr(), k, piece_words, sums.data_ptr(), xors.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise AssertionError(
                f"parent land_and_checksum: CUDA error {code}")
        return buf, sums, xors

    def turns(old, new, n):
        a1, b1 = device_time(old, n)[0], device_time(new, n)[0]
        b2, a2 = device_time(new, n)[0], device_time(old, n)[0]
        return {"parent_ms": (a1 + a2) / 2, "this_ms": (b1 + b2) / 2,
                "turns_ms": [a1, b1, b2, a2]}

    out = {"parent": root, "built": bool(log)}
    main = land_sets(BATCH_PIECES, n_pieces, pw, 1, gen, device)
    words = main[0][0]
    check_equal("parent chunk_checksums",
                zip(old_k1(words), checksum.chunk_checksums(words, pw)))
    out["chunk_checksums"] = turns(
        lambda j: old_k1(words),
        lambda j: checksum.chunk_checksums(words, pw), 10)
    for name, data, n in (
            ("land_and_checksum", main, 40),
            ("land_and_checksum_feed",
             land_sets(FEED_BATCH, FEED_BATCH, SEQ_TOKENS, 16, gen, device),
             320)):
        a = [t.clone() for t in data[0]]
        check_equal(f"parent {name}",
                    zip(old_k2(*a), checksum.land_and_checksum(*data[0])))
        out[name] = turns(lambda j: old_k2(*data[j % len(data)]),
                          lambda j: checksum.land_and_checksum(
                              *data[j % len(data)]), n)
        del a
    return out


# K2's launch plans timed at the main path's shape: (name,
# cluster, stage words, stages, threads); stages 0 is the register path.
SWEEP_PLANS = (("ring 16 KiB x 2 (the plan)", 16, 4096, 2, 256),
               ("ring 8 KiB x 4", 16, 2048, 4, 256),
               ("ring 16 KiB x 4", 16, 4096, 4, 256),
               ("ring 32 KiB x 2", 16, 8192, 2, 256),
               ("ring 32 KiB x 4", 16, 8192, 4, 256),
               ("ring 32 KiB x 6", 16, 8192, 6, 256),
               ("ring 16 KiB x 2, clusters of 8", 8, 4096, 2, 256),
               ("registers, 1024 threads", 16, 0, 0, 1024),
               ("registers, 512 threads", 16, 0, 0, 512),
               ("registers, clusters of 8", 8, 0, 0, 1024))


def sweep_plans(n_pieces: int, pw: int, gen, device) -> dict:
    """K2 at the main path's shape under each of ``SWEEP_PLANS``, by
    ``device_time``, between two timings of a ``copy_`` of the same
    bytes, each with the number of its clusters the card holds at once;
    each plan's result is checked against the first's."""
    (buf, pieces, slots), = land_sets(BATCH_PIECES, n_pieces, pw, 1, gen,
                                      device)
    dst = torch.empty_like(pieces)
    out = {"copy_ms_before": device_time(lambda j: dst.copy_(pieces), 40)[0]}
    lib = _build.library()
    first = None
    for name, cluster, stage_words, stages, threads in SWEEP_PLANS:
        plan = checksum.LandPlan(cluster, BATCH_PIECES, stage_words, stages,
                                 threads)
        got = checksum.land_and_checksum(buf, pieces, slots, plan=plan)[1:]
        first = first or [t.clone() for t in got]
        check_equal(f"land_and_checksum plan {name}", zip(got, first))
        out[name] = {
            "ms": device_time(lambda j: checksum.land_and_checksum(
                buf, pieces, slots, plan=plan), 40)[0],
            "clusters_at_once": lib.df_land_max_active_clusters(
                cluster, threads, stages * stage_words * 4)}
    out["copy_ms_after"] = device_time(lambda j: dst.copy_(pieces), 40)[0]
    return out


def ptxas_lines(log: str) -> list[str]:
    """Each kernel's registers, shared memory and spills from nvcc's
    ``-Xptxas -v`` output; K3's two instances by their run (16-byte words
    a lane)."""
    out, kernel = [], ""
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = next((k for k in ("chunk_checksums_kernel",
                                       "land_checksum_kernel",
                                       "gear_scan_kernel",
                                       "read_floor_kernel") if k in line),
                          line.split()[-1])
            run = line.partition("gear_scan_kernelILi")[2].partition("E")[0]
            if run:
                kernel += f"<{run}>"
        elif kernel and ("spill" in line or "Used" in line):
            out.append(f"{kernel}: {line.split(' : ')[-1].strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", metavar="DIR",
                    help="also time this checkout's kernels against those "
                    "of the checkout in DIR (the parent commit), in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    smi = smi_line()
    device_name = torch.cuda.get_device_name(0)
    bw = card_bandwidth(device_name)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; bound at "
          f"{bw / 1e12:.2f} TB/s")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(_build.SOURCES) + 1,
                            thread_name_prefix="df-nvcc") as ex:
        # One nvcc for each source, started together; the third builds
        # K3's yardstick, the read floor; g++ builds the host library
        # beside them.
        for f in [ex.submit(_build.library), ex.submit(_build.gear_library),
                  ex.submit(_build.read_floor_library),
                  ex.submit(_build.host_library)]:
            f.result()
    print(f"kernels and the host library built in "
          f"{time.perf_counter() - t0:.1f} s ("
          + ", ".join(_build.library_path(src)
                      for src in (*_build.SOURCES, _build.HOST_SOURCE))
          + ")")
    if _build.build_log:
        print(_build.build_log)
    for line in ptxas_lines(_build.build_log):
        print("ptxas", line)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    layout = shard_layout(LLAMA_8B, SHARD_LAYERS)
    content_length = 8 + sum(int(np.prod(s)) * 2 for _, s in layout)
    piece_size = compute_piece_size(content_length)
    n_pieces = compute_piece_count(content_length, piece_size)
    pw = piece_size // 4

    k1 = phase_chunk_checksums(n_pieces, pw, gen, device, bw)
    print("kernel chunk_checksums:", json.dumps(k1))
    torch.cuda.empty_cache()
    k2 = phase_land_and_checksum(BATCH_PIECES, n_pieces, pw, gen, device, bw)
    print("kernel land_and_checksum:", json.dumps(k2))
    torch.cuda.empty_cache()
    # K2 at the feed's shape: one batch of FEED_BATCH token records, one
    # record (SEQ_TOKENS int32 ids) per slot, every slot landed.
    # 16 input sets of 4 MiB in turn: more than the 50 MB L2 holds.
    k2_feed = phase_land_and_checksum(FEED_BATCH, FEED_BATCH, SEQ_TOKENS, gen,
                                      device, bw, sets=16, n=320)
    print("kernel land_and_checksum at the feed's shape:",
          json.dumps(k2_feed))
    phase_odd_shapes(gen, device)
    print("odd shapes: both kernels match their plain versions")
    k3 = phase_gear(gen, device, bw)
    torch.cuda.empty_cache()
    print("kernel gear_candidates:", json.dumps(k3))
    print(f"gear: K3 equal to its plain version bit for bit in "
          f"{len(k3['cases'])} cases (its (tile, run) in bytes: "
          f"{k3['geometries']}), the largest {GEAR_HUGE} bytes (over 2^31); "
          + "; ".join(
              f"{label} ({r['shape']}) {r['ms']:.5f} ms against a "
              f"{r['bound_ms']:.5f} ms bound ({r['bound_by']}), copy_ "
              f"{r['copy_ms']:.5f} ms, read floor {r['read_ms']:.5f} ms, "
              f"plain {r['plain_ms']:.4f} ms"
              for label, r in (("at the main path's shape", k3),
                               ("at 64 MiB", k3["at_64_mib"]),
                               ("at a stream chunk", k3["at_stream_chunk"])))
          + f" on {smi}")
    if args.parent:
        print("against the parent:", json.dumps(compare_parent(
            args.parent, n_pieces, pw, gen, device)))
        torch.cuda.empty_cache()
    print("land_and_checksum plans:", json.dumps(sweep_plans(
        n_pieces, pw, gen, device)))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    content, spans = make_shard(layout, gen, device)
    shard_bytes = content.size
    print(f"shard: {content.size} bytes, {len(layout)} tensors, "
          f"{n_pieces} pieces of {piece_size}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    main_path, taken = drive_main_path(content, spans, layout, piece_size,
                                       args.seed, device)
    t = main_path["times"]
    landed_s = t["land_s"] + t["finalize_s"]
    print("main path:", json.dumps(main_path))
    print(f"main path: landed and verified {content.size / 1e9:.3f} GB in "
          f"{landed_s:.3f} s ({content.size / landed_s / 1e9:.2f} GB/s), "
          f"verify gate {content.size / t['verify_gate_s'] / 1e9:.2f} GB/s, "
          f"peak device memory {main_path['peak_device_bytes'] / 1e9:.2f} GB "
          f"on {smi}")
    launches_k2 = main_path["launches"]["land_and_checksum"]
    device_s = launches_k2 * (k2["h2d_batch_ms"] + k2["ms"]) / 1e3
    print(f"landing: land_s {t['land_s']:.4f} s = host checksum "
          f"{t['host_checksum_s']:.4f} s + staging copy {t['stage_s']:.4f} s "
          f"+ waits on the card {t['stage_wait_s']:.4f} s + the rest; device "
          f"work, estimated as {launches_k2} x (one pinned batch copy + one "
          f"K2) = {device_s:.4f} s")
    print("corruption:", phase_corruption(device))
    dmn = phase_daemon(content, spans, layout, device)
    torch.cuda.empty_cache()
    print("daemon:", json.dumps(dmn))
    cold, warm, shd = dmn["cold"], dmn["warm"], dmn["sharded"]
    dig = dmn["digest"]
    print(f"daemon: cold request {cold['bytes']} B from the stand-in "
          f"origin ({cold['origin']['get_range'][0]} ranged GETs, "
          f"{cold['origin']['get_range'][1]} B) in {cold['wall_s']:.3f} s, "
          f"{cold['tensors']} tensors equal to the shard, validate_digest() "
          f"== the shard's sha256; land_s {cold['land_s']:.4f} s (first on_piece to "
          f"finalize returned) beside, summed over the piece groups' "
          f"streams, origin wait {cold['origin_wait_s']:.4f} s and store "
          f"write (CRC-32C fused) {cold['store_write_s']:.4f} s; the sink's "
          f"worker busy {cold['sink_busy_s']:.4f} s of it: host checksum "
          f"{cold['host_checksum_s']:.4f} s, staging "
          f"{cold['stage_s']:.4f} s, the rest (reads from the store, "
          f"launches) {cold['sink_busy_s'] - cold['host_checksum_s'] - cold['stage_s']:.4f} s; K2 "
          f"{cold['launches']['land_and_checksum']} x {k2['ms']:.4f} ms = "
          f"{cold['launches']['land_and_checksum'] * k2['ms']:.2f} ms on the "
          f"card; warm request (reused, no origin request) "
          f"{warm['wall_s']:.3f} s, land_s {warm['land_s']:.4f} s, the "
          f"sink's worker busy {warm['sink_busy_s']:.4f} s of it = host "
          f"checksum {warm['host_checksum_s']:.4f} s + staging "
          f"{warm['stage_s']:.4f} s + the rest; sharded request "
          f"{shd['tensors']} tensors ({shd['bytes']} B) in "
          f"{shd['wall_s']:.3f} s off the local parent, no origin request; "
          f"digest request (sha256, fetched again, prefix hasher on) "
          f"{dig['wall_s']:.3f} s, land_s {dig['land_s']:.4f} s, last piece "
          f"to finalize (the completion re-hash) "
          f"{dig['last_piece_to_finalize_s']:.4f} s against the cold "
          f"request's {cold['last_piece_to_finalize_s']:.4f} s, origin wait "
          f"{dig['origin_wait_s']:.4f} s, store write "
          f"{dig['store_write_s']:.4f} s, the sink's worker busy "
          f"{dig['sink_busy_s']:.4f} s: host checksum "
          f"{dig['host_checksum_s']:.4f} s, staging {dig['stage_s']:.4f} s; "
          f"written to disk {dmn['origin_file_bytes']} B (the origin's "
          f"file) + {dmn['store_bytes']} B (the stores); a landing's peak "
          f"device memory above what was allocated before it: cold "
          f"{cold['peak_device_bytes'] / 1e9:.3f} GB, warm "
          f"{warm['peak_device_bytes'] / 1e9:.3f} GB, sharded "
          f"{shd['peak_device_bytes'] / 1e9:.3f} GB, digest "
          f"{dig['peak_device_bytes'] / 1e9:.3f} GB, on {smi}")
    print(flight_line("daemon cold", dmn["flight"]) + f" on {smi}")
    p2p = phase_p2p(content, spans, layout, device)
    torch.cuda.empty_cache()
    print("p2p:", json.dumps(p2p))
    for what, r in (("no digest", p2p["plain"]), ("sha256", p2p["digest"])):
        print(f"p2p {what}: {r['bytes']} B pulled from the parent process "
              f"({r['upload_requests']:.0f} upload requests, "
              f"{r['upload_bytes']:.0f} B served, no origin request; "
              f"{r['scheduler']['reported']} pieces reported, "
              f"{r['scheduler']['messages'].get('download_finished')} "
              f"download_finished) in {r['wall_s']:.3f} s, {r['tensors']} "
              f"tensors equal to the shard; land_s {r['land_s']:.4f} s "
              f"(first on_piece to finalize returned); the sink's worker "
              f"busy {r['sink_busy_s']:.4f} s of it (host checksum "
              f"{r['host_checksum_s']:.4f} s, staging {r['stage_s']:.4f} s); "
              f"summed over the piece workers, GET wait "
              f"{r['get_wait_s']:.4f} s and store write "
              f"{r['store_write_s']:.4f} s; last piece to finalize "
              f"{r['last_piece_to_finalize_s']:.4f} s (re-hash skipped "
              f"{r['rehash']['skipped']:.0f}, hashed "
              f"{r['rehash']['hashed']:.0f}); K2 "
              f"{r['launches']['land_and_checksum']}, K1 "
              f"{r['launches']['chunk_checksums']}; the parent's CPU "
              f"{r['parent_cpu_s']:.3f} s; peak device memory "
              f"{r['peak_device_bytes'] / 1e9:.3f} GB on {smi}")
    print(f"p2p: the parent fetched the shard back-to-source in "
          f"{p2p['parent_fetch_s'][0]:.3f} s and (with the sha256) "
          f"{p2p['parent_fetch_s'][1]:.3f} s; after the requests the "
          f"child's digest store validate_digest() == the shard's sha256 "
          f"in {p2p['validate_s']:.3f} s")
    for what in ("plain", "digest"):
        sched = p2p[what]["scheduler"]
        print(f"p2p {what} at the stand-in scheduler: {sched['reported']} "
              f"pieces reported with {sched['digested']} digests and "
              f"{sched['timed']} timings, {sched['packed']} batches packed "
              f"of {sched['messages'].get('pieces_finished', 0)} "
              f"pieces_finished; the terminal flight digest "
              f"{sched['flight']['bytes']} B with "
              f"{sched['clock_samples']} clock samples; per-host rollup "
              f"(PodAggregator): {json.dumps(sched['pod']['hosts'])}")
    print(flight_line("p2p no digest", p2p["flight"]) + f" on {smi}")
    gt = p2p["gated"]
    print(f"p2p gated: a fresh child with a WFQGate of "
          f"{gt['gate_capacity']} slots pulled {gt['bytes']} B as the tenant "
          f"{gt['tenant']} in {gt['wall_s']:.3f} s, land_s "
          f"{gt['land_s']:.4f} s beside the ungated first pull's "
          f"{p2p['plain']['land_s']:.4f} s "
          f"({gt['land_s'] / p2p['plain']['land_s']:.3f}x); the gate's "
          f"grants by class {json.dumps(gt['grants'])}; the parent's "
          f"peer_upload_bytes_total by tenant: the first pull "
          f"{json.dumps(p2p['plain']['tenant_bytes'])}, the sha256 pull "
          f"{json.dumps(p2p['digest']['tenant_bytes'])}, the gated pull "
          f"{json.dumps(gt['tenant_bytes'])}; K2 "
          f"{gt['launches']['land_and_checksum']}, K1 "
          f"{gt['launches']['chunk_checksums']} on {smi}")
    pex = phase_pex(content, spans, layout, device)
    torch.cuda.empty_cache()
    print("pex:", json.dumps(pex))
    print(f"pex: gossip start to the first holder found "
          f"{pex['gossip_to_holder_s'] * 1e3:.2f} ms; {pex['bytes']} B "
          f"pulled from the holder process with no scheduler "
          f"({pex['piece_requests']} piece GETs, the holder's upload server "
          f"{pex['upload_requests']:.0f} requests, {pex['upload_bytes']:.0f}"
          f" B, no origin request) in {pex['wall_s']:.3f} s, "
          f"{pex['tensors']} tensors equal to the shard; land_s "
          f"{pex['land_s']:.4f} s, the sink's worker busy "
          f"{pex['sink_busy_s']:.4f} s of it "
          f"({pex['sink_busy_s'] / pex['land_s'] * 100:.1f}%: host checksum "
          f"{pex['host_checksum_s']:.4f} s, staging {pex['stage_s']:.4f} s); "
          f"K2 {pex['launches']['land_and_checksum']}, K1 "
          f"{pex['launches']['chunk_checksums']}; the holder fetched it "
          f"back-to-source in {pex['holder_fetch_s']:.3f} s and spent "
          f"{pex['holder_cpu_s']:.3f} CPU s serving; peak device memory "
          f"{pex['peak_device_bytes'] / 1e9:.3f} GB on {smi}")
    print(flight_line("pex", pex["flight"]) + f" on {smi}")
    swm = phase_swarm(content, device)
    torch.cuda.empty_cache()
    print("swarm:", json.dumps(swm))
    for line in swarm_lines(swm, content.size):
        print(f"{line} on {smi}")
    mpre = phase_manager_preheat(content, device)
    torch.cuda.empty_cache()
    print("manager preheat:", json.dumps(mpre))
    print(f"{manager_preheat_line(mpre, cold['wall_s'])} on {smi}")
    with cli_origin(content) as origin:
        clip = phase_cli(content, device, origin)
        torch.cuda.empty_cache()
        print("cli:", json.dumps(clip))
        print(f"{cli_line(clip)} on {smi}")
        obs = phase_observe(content, device, origin)
        torch.cuda.empty_cache()
    obs["split"]["origin_cleanup"] = origin["cleanup_s"]
    print("observe:", json.dumps(obs))
    print(f"{observe_line(obs)} on {smi}")

    swap, gen2, _ = phase_hot_swap(content, spans, layout, taken,
                                   piece_size, gen, device)
    torch.cuda.empty_cache()
    chunker = phase_chunker(content, args.seed, device)
    print("chunker:", json.dumps(chunker))
    print(f"chunker: {chunker['bytes']} B prefix, {chunker['chunks']} "
          f"chunks, the card's in two splits equal to the plain CPU "
          f"chunker's ({chunker['plain_s']:.2f} s); card runs "
          + ", ".join(f"{name} {r['s']:.3f} s" for name, r in
                      chunker["runs"].items()) + f" on {smi}")
    torch.cuda.empty_cache()
    man, base_ref = phase_manifest(content, piece_size, device)
    print("manifest:", json.dumps(man))
    print(f"manifest: {man['bytes']} B in {man['chunks']} chunks "
          f"({man['forced_cuts']} forced at the bound); manifest_s "
          f"{man['manifest_s']:.3f} s = read {man['read_s']:.3f} s + stage "
          f"{man['stage_s']:.3f} s + scan {man['scan_s']:.3f} s + sha256 "
          f"and emit {man['hash_s']:.3f} s + the rest; "
          f"{man['launches']['gear_candidates']} K3 launches, their device "
          f"time estimated as that many x K3's {k3['ms']:.5f} ms at the same "
          f"shape = {man['launches']['gear_candidates'] * k3['ms']:.3f} ms, "
          f"on {smi}")
    torch.cuda.empty_cache()
    cdc, gen2_m = phase_cdc_swap(content, gen2, spans, layout, taken,
                                 base_ref, piece_size, device)
    torch.cuda.empty_cache()
    ctm = cdc["timings"]
    print("cdc swap:", json.dumps(cdc))
    print(f"cdc swap: {cdc['chunks_new']} chunks of generation 2 against "
          f"{cdc['chunks_base']} of generation 1 (its manifest built from "
          f"the landed store in {cdc['base_manifest_s']:.3f} s); reused "
          f"{cdc['reused_device_bytes']} B device to device, staged "
          f"{cdc['staged_bytes']} B (plan_delta's fetched bytes), "
          f"{cdc['copies']} copies; assemble {ctm['assemble_s']:.4f} s, its "
          f"copies {ctm['assemble_device_ms']:.4f} ms on the card; swap "
          f"{cdc['swap_s']:.3f} s with the fallback; peak device memory "
          f"{cdc['peak_device_bytes'] / 1e9:.3f} GB on {smi}")
    # The dfdaemon phase serves the shard's file the task-kind phases wrote.
    dfd_root = tempfile.mkdtemp(prefix="df-chip-dfdaemon-")
    try:
        dfd_shard = os.path.join(dfd_root, "objects", GATEWAY_BUCKET,
                                 GATEWAY_KEY)
        os.makedirs(os.path.dirname(dfd_shard))
        dd, seed = phase_task_kinds(content, gen2, spans, layout, base_ref,
                                    gen2_m, device, keep=dfd_shard)
        del gen2, gen2_m
        torch.cuda.empty_cache()
        dt, sw = dd["delta_timings"], dd["swap_timings"]
        print("daemon delta:", json.dumps(dd))
        print(f"daemon delta: generation 1 -> 2 through the port's daemon: "
              f"download_delta {dd['swap_s']:.3f} s (generation 1 landed "
              f"first in {dd['generation1_s']:.3f} s); the delta task reused "
              f"{dd['stats']['reused_bytes']} B from the base store and "
              f"fetched {dd['stats']['fetched_bytes']} B (plan_delta: "
              f"{dd['plan_reused']} / {dd['plan_fetched']}), the origin "
              f"served {dd['origin_bytes']} B in {dd['spans']} span tasks "
              f"(plan.fetched_bytes {dd['plan_fetched']} + one 1-byte probe a "
              f"span), corrupt_base {dd['stats']['corrupt_base']}; the task's "
              f"split: resolve {dt.get('resolve_s', 0):.3f} s (of it the base "
              f"manifest built by K3 {dt.get('base_manifest_s', 0):.3f} s), "
              f"assemble {dt.get('assemble_s', 0):.3f} s (base reads "
              f"{dt.get('base_read_s', 0):.3f} s, sha256 "
              f"{dt.get('sha256_s', 0):.3f} s, span waits "
              f"{dt.get('span_wait_s', 0):.3f} s, store writes "
              f"{dt.get('store_write_s', 0):.3f} s), finalize "
              f"{dt.get('finalize_s', 0):.3f} s; the swap: staged "
              f"{dd['staged_bytes']} B, reused {dd['reused_device_bytes']} B "
              f"device to device, assemble {sw['assemble_s']:.4f} s, gate "
              f"{sw['gate_s']:.4f} s; K3 "
              f"{dd['launches']['gear_candidates']}, K1 "
              f"{dd['launches']['chunk_checksums']}, K2 "
              f"{dd['launches']['land_and_checksum']}; peak device memory "
              f"above the swap's start {dd['peak_device_bytes'] / 1e9:.3f} "
              f"GB, with generation 1 (both generations) "
              f"{dd['resident_peak_bytes'] / 1e9:.3f} GB, each within "
              f"{dd['peak_limit_bytes'] / 1e9:.3f} GB (2 x the padded "
              f"content + one piece) on {smi}")
        s1, s2 = seed["seed"], seed["again"]
        print("seed:", json.dumps(seed))
        print(f"seed: Peer.TriggerDownloadTask ACK in "
              f"{s1['ack_s'] * 1e3:.2f} ms (before the seed landed); trigger "
              f"to verified device buffer {s1['trigger_to_verified_s']:.3f} "
              f"s, land_s {s1['land_s']:.4f} s, "
              f"the sink's worker busy {s1['sink_busy_s']:.4f} s "
              f"({s1['sink_busy_s'] / s1['land_s']:.0%}) = host checksum "
              f"{s1['host_checksum_s']:.4f} s + staging "
              f"{s1['stage_s']:.4f} s + the rest; registered as a seed, "
              f"{s1['scheduler'].get('reported')} pieces reported; K2 "
              f"{s1['launches']['land_and_checksum']}, K1 "
              f"{s1['launches']['chunk_checksums']}; the second trigger "
              f"answered already_complete with no origin request, its device "
              f"copy landed again from the store (K2 "
              f"{s2['launches']['land_and_checksum']}) in "
              f"{s2['land_s']:.4f} s; "
              f"peak device memory {s1['peak_device_bytes'] / 1e9:.3f} GB on "
              f"{smi}")
        dfd = phase_dfdaemon(dfd_root, content, spans, layout, args.seed,
                             LLAMA_8B["vocab"], device)
        torch.cuda.empty_cache()
        prx = phase_proxy(dfd_root, content, p2p["sha256"], device)
    finally:
        shutil.rmtree(dfd_root, ignore_errors=True)
    torch.cuda.empty_cache()
    print("dfdaemon:", json.dumps(dfd))
    pre, claim, reads = dfd["prefetch"], dfd["claim"], dfd["reads"]
    print(f"dfdaemon: the port's Daemon from a DaemonConfig up in "
          f"{dfd['start_s']:.3f} s; POST .../prefetch/{GATEWAY_KEY}"
          f"?device=tpu {pre['wall_s']:.3f} s wall, land_s "
          f"{pre['land_s']:.4f} s, the sink's worker busy "
          f"{pre['sink_busy_s']:.4f} s ({pre['sink_busy_share']:.1%}), "
          f"device_verified {pre['answer']['device_verified']}, K2 "
          f"{pre['launches']['land_and_checksum']}, K1 "
          f"{pre['launches']['chunk_checksums']}, "
          f"{pre['scheduler'].get('reported')} pieces reported to the "
          f"stand-in scheduler; the claim (download_to_device, a reuse "
          f"hit on the prefetched sink, no landing, no origin read) "
          f"{claim['claim_s']:.4f} s, then the gate K1 "
          f"{dfd['launches']['chunk_checksums']}, {claim['tensors']} "
          f"tensors equal to the shard; through the gateway: the whole "
          f"object {reads['whole_bytes']} B in {reads['whole_s']:.3f} s "
          f"({reads['whole_bytes'] / reads['whole_s'] / 1e9:.2f} GB/s), a "
          f"{reads['window'][1] - reads['window'][0] + 1} B Range window in "
          f"{reads['window_s']:.3f} s, the ranged task of "
          f"{reads['ranged_bytes']} B cold {reads['ranged'][0]['s']:.4f} s "
          f"then reused {reads['ranged'][1]['s']:.4f} s; stop "
          f"{dfd['stop_s']:.3f} s (announces {dfd['scheduler_hosts']['announces']}, "
          f"left {dfd['scheduler_hosts']['left']}, GC runs "
          f"{dfd['gc']['runs']}, live stores reclaimed "
          f"{len(dfd['gc']['reclaimed_live'])}, failed ones "
          f"{dfd['gc']['reclaimed_invalid']}) "
          f"on {smi}")
    st, dev = prx["steps"], prx["device"]
    print("proxy:", json.dumps(prx))
    print(f"proxy: the port's Daemon as a registry mirror and intercepting "
          f"proxy up in {prx['start_s']:.3f} s; the mirror pull (plaintext "
          f"to the client, TLS to the stand-in registry, back-to-source "
          f"into the store) {st['mirror']['bytes']} B in "
          f"{st['mirror']['wall_s']:.3f} s "
          f"({st['mirror']['bytes'] / st['mirror']['wall_s'] / 1e9:.3f} "
          f"GB/s; the answer's head at {st['mirror']['head_s']:.3f} s, "
          f"the store complete at {st['mirror']['store_done_s']:.3f} s), "
          f"sha256 equal, the registry served "
          f"{json.dumps(st['mirror']['registry'])}, proxy_requests_total"
          f"{{via=\"p2p\"}} +{st['mirror']['via']['p2p'][0]}; the hijacked "
          f"warm pull through CONNECT (TLS with a forged leaf, sendfile off "
          f"the store) {st['hijack']['bytes']} B in "
          f"{st['hijack']['wall_s']:.3f} s "
          f"({st['hijack']['bytes'] / st['hijack']['wall_s'] / 1e9:.3f} "
          f"GB/s), sha256 equal, {len(st['hijack']['registry'])} new "
          f"registry requests; a Range in the tunnel {st['range']['status']} "
          f"{st['range']['bytes']} B equal in {st['range']['wall_s']:.4f} s; "
          f"the manifest passed through (via direct) in "
          f"{st['direct']['wall_s'] * 1e3:.2f} ms; Daemon.Download onto the "
          f"card off the proxy-filled store {dev['wall_s']:.3f} s (land_s "
          f"{dev['land_s']:.4f} s, the sink's worker busy "
          f"{dev['sink_busy_s']:.4f} s), from_reuse "
          f"{dev['answer']['from_reuse']}, {len(dev['registry'])} new "
          f"registry requests, K2 {dev['launches']['land_and_checksum']}, "
          f"K1 {dev['launches']['chunk_checksums']}, every byte equal; stop "
          f"{prx['stop_s']:.3f} s on {smi}")
    gwm = phase_gateway_manifest(content, base_ref, device)
    torch.cuda.empty_cache()
    k3s = k3["at_stream_chunk"]
    print("gateway manifest:", json.dumps(gwm))
    print(f"gateway manifest: fetch_or_build_manifest over the stand-in "
          f"gateway built {gwm['bytes']} B into {gwm['chunks']} chunks, its "
          f"JSON equal to manifest_from_store's, and published it; "
          f"manifest_s {gwm['manifest_s']:.3f} s = stream "
          f"{gwm['stream_s']:.3f} s + stage {gwm['stage_s']:.3f} s + scan "
          f"{gwm['scan_s']:.3f} s + sha256 and emit {gwm['hash_s']:.3f} s + "
          f"the rest, over {gwm['feeds']} stream chunks; "
          f"{gwm['launches']['gear_candidates']} K3 launches, their device "
          f"time estimated as that many x K3's {k3s['ms']:.5f} ms at "
          f"{STREAM_CHUNK} + 31 B = "
          f"{gwm['launches']['gear_candidates'] * k3s['ms']:.3f} ms; then a "
          f"hit in {gwm['hit_s']:.4f} s with no K3 launch, on {smi}")
    mesh = phase_mesh(content, layout, taken, device)
    del taken, content
    torch.cuda.empty_cache()
    print("mesh:", json.dumps(mesh))
    print(f"mesh: world of one over {mesh['backend']}; ici_broadcast of "
          f"{mesh['bytes']} B {mesh['ici_broadcast_ms']:.4f} ms device time "
          f"beside copy_ {mesh['copy_ms']:.4f} ms; no copy in "
          f"{sum(mesh['no_copy'].values())} of {len(mesh['no_copy'])} "
          f"placements; StripedBroadcast of {mesh['striped_feeds']} feeds "
          f"in {mesh['striped_s']:.3f} s; peak device memory "
          f"{mesh['peak_device_bytes'] / 1e9:.3f} GB; torch.distributed "
          f"calls {mesh['collective_calls']} on {smi}")
    tm = swap["timings"]
    print("hot swap:", json.dumps(swap))
    print(f"hot swap: {swap['content_bytes'] / 1e9:.3f} GB in "
          f"{swap['chunks']} chunks; reused {swap['reused_device_bytes']} B "
          f"device to device, staged {swap['staged_bytes']} B, "
          f"{swap['copies']} copies; assemble {tm['assemble_s']:.4f} s on "
          f"the host, its copies {tm['assemble_device_ms']:.4f} ms on the "
          f"card; gate cold "
          f"{tm['gate_s']:.4f} s, warm {swap['gate_warm_ms'] / 1e3:.4f} s; "
          f"flip-to-readable {tm['flip_s']:.4f} s; peak device memory "
          f"{swap['peak_device_bytes'] / 1e9:.3f} GB on {smi}")
    feed = phase_feed(args.seed, LLAMA_8B["vocab"], device)
    print("feed:", json.dumps(feed))
    print(f"feed: {feed['batches']} batches of up to {FEED_BATCH} x "
          f"{feed['record_bytes']} B in {feed['feed_s']:.4f} s: "
          f"{feed['batches_per_s']:.1f} batches/s, {feed['gb_per_s']:.3f} GB/s "
          f"on {smi}")
    print("feed window under the profiler:",
          json.dumps(profile_feed(args.seed, LLAMA_8B["vocab"], device)))
    torch.cuda.empty_cache()
    wds = phase_wds(args.seed, LLAMA_8B["vocab"], device)
    torch.cuda.empty_cache()
    k2_wds_ms = wds["batches"] * k2_feed["ms"]
    print("wds:", json.dumps(wds))
    print(f"wds: {wds['shards']} shards, {wds['shard_bytes']} B in the "
          f"stand-in gateway; prepare_s {wds['prepare_s']:.3f} s (index "
          f"{wds['index_s']:.3f} s on the loop, streams and the rest "
          f"{wds['stream_and_rest_s']:.3f} s), then all hits in "
          f"{wds['prepare_hit_s']:.3f} s; epoch 0: {wds['samples']} samples "
          f"in plan order, {wds['batches']} batches on the card equal to the "
          f"host records, in {wds['epoch_s']:.3f} s: "
          f"{wds['samples_per_s']:.0f} samples/s, "
          f"{wds['batches_per_s']:.1f} batches/s, {wds['gb_per_s']:.3f} GB/s; "
          f"{wds['requests']} requests of {wds['mean_request_bytes']:.0f} B "
          f"mean; loader wait {wds['loader_wait_s']:.3f} s, feed "
          f"{wds['feed_s']:.3f} s; CPU seconds in the epoch: this process "
          f"{wds['cpu_s']:.3f}, the gateway's {wds['gateway_cpu_s']:.3f}; "
          f"the loader alone "
          f"{wds['loader_alone']['samples_per_s']:.0f} samples/s; K2 "
          f"{wds['launches']['land_and_checksum']} launches, their device "
          f"time estimated as that many x K2's {k2_feed['ms']:.5f} ms at the "
          f"feed's shape = {k2_wds_ms:.3f} ms, "
          f"{k2_wds_ms / 1e3 / wds['epoch_s']:.2%} of the epoch's wall time; "
          f"peak device memory {wds['peak_device_bytes'] / 1e9:.3f} GB on "
          f"{smi}")
    ep = dfd["epoch"]
    print(f"dfdaemon epoch: the first {ep['batches']} batches of epoch 0 "
          f"({ep['samples']} samples, each a ranged task) through the "
          f"port's gateway into DeviceFeed in {ep['epoch_s']:.3f} s: "
          f"{ep['samples_per_s']:.0f} samples/s against the stand-in "
          f"gateway's {wds['samples_per_s']:.0f} samples/s in this call "
          f"({ep['samples_per_s'] / wds['samples_per_s']:.2f}x); prepare "
          f"{ep['prepare_s']:.3f} s; K2 {ep['launches']['land_and_checksum']}"
          f" on {smi}")
    print(f"dfdaemon epoch split: {split_line(ep['split'])}")

    ent = phase_entry(device)
    torch.cuda.empty_cache()
    print("entry:", json.dumps(ent))
    for shape, sh in ent["shapes"].items():
        print(f"entry at the {shape} shape: {sh['batches']} batches of "
              f"{sh['batch_pieces']} x {sh['piece_words'] * 4} B "
              f"({sh['bytes']} B) landed through K2, equal to its plain "
              f"version bit for bit, on {smi}")
    train = phase_train(device)
    print("train:", json.dumps(train))
    for shape, _ in TRAIN_SHAPES:
        r = train[shape]
        print(f"train at {shape}: d_model {r['d_model']} d_ff {r['d_ff']} "
              f"batch {r['batch']}, w1 of {r['w1_bytes_landed']} B landed, "
              f"gathered and bitcast, {r['zeros']} zeros; loss "
              f"{r['loss']!r}; step {r['step_s']:.4f} s, landing "
              f"{r['fabric_s']:.4f} s, peak device memory "
              f"{r['peak_device_bytes'] / 1e9:.4f} GB, wall {r['wall_s']:.1f}"
              f" s; max abs err vs the plain step {r['max_abs_err']} on "
              f"{smi}")
    ben = phase_bench(device, smi)
    torch.cuda.empty_cache()
    print("bench:", json.dumps(ben["line"]))
    line = ben["line"]
    print(f"bench: verify_and_land {line['value']:.2f} GB/s "
          f"({line['verify_and_land_ms']:.4f} ms against a "
          f"{line['verify_and_land_bound_ms']:.4f} ms bound, copy_ "
          f"{line['verify_and_land_copy_ms']:.4f} ms), staging pageable "
          f"{line['staged_host_to_hbm_gbps']:.2f} / pinned "
          f"{line['staged_pinned_host_to_hbm_gbps']:.2f} GB/s, swap verify "
          f"{line['swap_verify_gbps']:.2f} GB/s, cpu sha256 "
          f"{line['cpu_sha256_gbps']:.3f} GB/s on {smi}")

    paths = {"main": main_path["launches"], "hot_swap": swap["launches"],
             "mesh": mesh["launches"], "feed": feed["launches"],
             "entry": ent["launches"], "train": train["launches"],
             "bench": ben["launches"], "chunker": chunker["launches"],
             "manifest": man["launches"], "cdc_swap": cdc["launches"],
             "wds": wds["launches"], "gateway_manifest": gwm["launches"],
             "daemon": dmn["launches"], "p2p": p2p["launches"],
             "pex": pex["launches"],
             "daemon_delta": dd["launches"], "seed": s1["launches"],
             "seed_again": s2["launches"], "dfdaemon": dfd["launches"],
             "dfdaemon_epoch": dfd["epoch"]["launches"],
             "p2p_qos": p2p["gated"]["launches"],
             "proxy": prx["launches"], "swarm": swm["launches"],
             "manager_preheat": mpre["launches"], "cli": clip["launches"],
             "observe": obs["on"]["launches"],
             "observe_off": obs["off"]["launches"]}
    check_launches(paths, -(-n_pieces // BATCH_PIECES), feed["batches"],
                   chunker["planned_k3"], planned_k3(span_sizes(shard_bytes)),
                   wds["batches"], gwm["planned_k3"],
                   sum(dmn["want_k2"].values()), p2p["want_k2"],
                   pex["want_k2"], seed["want_k2"], dfd["want_k2"],
                   DFD_EPOCH_BATCHES, prx["want_k2"], swm["want_k2"],
                   mpre["want_k2"], clip["want_k2"], obs["want_k2"])
    kernels = []
    timed_keys = ("max_abs_err", "ms", "call_us", "plain_ms", "bound_ms",
                  "copy_ms", "register_path_ms", "plan", "l2_rotation_sets",
                  "shape")
    # The bench's shapes: K1 over 256 MiB of 4 MiB pieces (the swap gate's
    # fold), and entry()'s step of 8 K2 launches of 16 x 4 MiB a call.
    at_swap = {"ms": line["swap_verify_k1_ms"],
               "bound_ms": line["swap_verify_k1_bound_ms"],
               "plain_ms": line["swap_verify_k1_plain_ms"],
               "copy_ms": line["swap_verify_k1_copy_ms"],
               "shape": "n=64 pw=1048576"}
    at_bench = {"ms_per_call": line["verify_and_land_ms"],
                "launches_per_call": line["verify_and_land_batches"],
                "bound_ms": line["verify_and_land_bound_ms"],
                "plain_ms": line["verify_and_land_plain_ms"],
                "copy_ms": line["verify_and_land_copy_ms"],
                "shape": "8 launches of k=16 pw=1048576 into 128 slots"}
    for kname, res, replaces, also in (
            ("chunk_checksums", k1, "dragonfly2_tpu/ops/checksum.py:68",
             {"at_swap_verify_shape": at_swap}),
            ("land_and_checksum", k2, "dragonfly2_tpu/ops/checksum.py:134",
             {"at_feed_shape": {key: k2_feed[key] for key in timed_keys},
              "at_bench_shape": at_bench})):
        by_path = {p: counts[kname] for p, counts in paths.items()}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "dragonfly2_tpu_torch/csrc/checksum.cu",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{key: res[key] for key in (
                "max_abs_err", "ms", "call_us", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "copy_ms", "register_path_ms",
                "plan", "shape") if key in res},
            **also, "match": True})
    by_path = {p: counts["gear_candidates"] for p, counts in paths.items()}
    kernels.append({
        "name": "gear_candidates", "route": "cuda",
        "source": "dragonfly2_tpu_torch/csrc/gear.cu",
        "replaces": "dragonfly2_tpu/native/src/dfchunk.cc:46",
        "replaces_what": "df_chunk_scan, the JAX package's native host scan "
                         "(not a Pallas kernel)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **{key: k3[key] for key in (
            "max_abs_err", "ms", "call_us", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "copy_ms", "read_ms", "shape",
            "geometries")},
        "at_64_mib": k3["at_64_mib"],
        "at_stream_chunk": k3["at_stream_chunk"], "match": True})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
