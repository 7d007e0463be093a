#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hsa_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py [--seed 1] [--profile]
    python3 chip_smoke.py --glocal-only R,L,G     # phases 1 and 5 alone
    python3 chip_smoke.py --probes-only           # phases 1 and 2b alone
    python3 chip_smoke.py --oracle-only           # phases 1 and 12 alone
    python3 chip_smoke.py --api-only              # phase 1, 3's index, 10c

It imports nothing of JAX and nothing of the JAX package: it drives the
port through its CLI (``hsa_tpu_torch.cli``), its ``Aligner``, its kernel
wrappers and its native-library loader.  Every phase that fails exits
non-zero; there is no CPU fallback, and without a CUDA device (or without
the rest of the repository beside it) it exits non-zero before printing
any result.

1. Device and build: the card's name and power limit (``nvidia-smi``),
   the torch/CUDA versions; builds every CUDA kernel from
   ``hsa_tpu_torch/csrc`` (select_topk, glocal_screen, gather_rows,
   table_take, onehot_gather), one nvcc each, in parallel, with their times.
2. select_topk against plain, on the card, at the beam step's two shapes
   (frontier ``[576, 32768]`` K=64 with window, hit merge ``[352, 32768]``
   K=32; three payloads each; seeded, ~30% of the keys valid): valid keys
   and payloads, the drop row and nvalid must be exactly equal.  Median ms
   of the kernel, of the plain version (one stable ``torch.sort`` + three
   gathers) and of the library yardstick (``torch.topk`` + three gathers,
   called nowhere in the port), timed in turns with CUDA events, beside the
   bound that the script computes from the case's own valid counts (4
   compulsory bytes per picked payload word) and the looser one that charges
   a 32-byte sector per pick, with the kernel's ratio to each.  Then
   the edges of the kernel's compaction and rank, each held exactly against
   plain and timed: every key valid; no valid key in every third column;
   a width that is no multiple of 32.
2b. The FM row-gather probes: the port's probe modules
   (``hsa_tpu_torch.tools``: gather_probe, gather_probe2, gather_probe3,
   sync_probe), driven as ``python -m ... --device cuda`` drives them at
   every test that launched a Pallas kernel on the TPU, with the three
   gather kernels' counts set to 0 just before and read just after (each
   must be above 0; each probe's own check must read correct=True).  Then
   each of the 27 launches of those 14 ``pallas_call``s at its probe's own
   inputs: the kernel (gather_rows, table_take or onehot_gather) exactly
   equal to its plain version and to the probe's check ``tab[q]`` (rounded
   through float32 for the one-hot product), the library call
   (``index_select``; ``torch.matmul`` over a prebuilt one-hot) the same
   function; median ms of the three in turns (one call between CUDA
   events, so the host's time to issue it counts), their device ms (calls
   queued behind a sleeping kernel, so that the card runs them back to
   back), the kernel's host ms per launch, and the bound.
   table_take's tables above the card's on-chip capacity (the largest
   thread-block cluster it schedules x 7,264 rows) must be refused with
   ``ValueError`` before any launch; prints the capacity and the largest
   probe table that ran.
3. Single-end main path through the CLI, in process: an i.i.d. genome of
   46,709,983 bp (human chr21 scale) from ``--seed``; ``hsa_tpu_torch.cli
   index`` (which builds the native index library and prints its time;
   the index is cached under ``hsa_tpu_torch/_build/smoke/``, keyed by
   size and seed), then ``align --engine beam --device cuda`` at the CLI
   defaults on 32,768 reads of 100 bp: half reverse-strand, each with 2
   mismatches, every fourth also with a 1-bp deletion.
4. Checks: mapped fraction >= 0.95; mapped reads within 2 bp of their
   origin >= 0.99; the select kernel's launch count during phase 3 alone
   equals 2 x n_steps x batches; every ``(C, B, K, window)`` that the
   wrapper recorded for those launches is printed with its count, and one
   that phase 2 did not hold against plain is checked and timed here as
   phase 2 does (so after phases 7, 9 and 10, each for its own path); the
   first 256 reads through ``align --device cpu`` (the plain path) give a
   byte-equal SAM.  Prints reads/s
   over the whole align window and, per batch, how long its yield was
   waited for (the stream searches batches ahead, so that is no per-batch
   rate).
4b. gather_rows against the library at the main path's own table, phase
   3's forward occ rows (1,459,688 x 32 bytes), for 131,072 rows twice:
   uniform random rows, and the block ids of one real ``extend`` (step 21
   of a backward search of phase 6's first 32,768 pairs' 65,536 ends, the
   lanes of a paired pigeon batch).  The yardstick is ``index_select``
   with int64 ids, the call inside ``fm._gather_rows``; beside it int32
   ids, ``fm._gather_rows`` whole and ``tab[b]``.  Exact against plain,
   timed warm (the table is about the size of the 50 MB L2, so part of it
   is there) and with the L2 flushed by a 128 MB write ahead of every call
   (outside the events), each also at every pipe depth (device ms).  Then
   the port's ``occ_probe5`` on phase 3's index.  The gather kernels'
   launches from phase 3 to phase 10, less these, must be 0 each: they are
   on no main path.
5. glocal_screen against plain, on the card, on 16,384 rescue-like jobs
   (reads of 150 bp, windows of 576 bp; exact, 2-mismatch, deletion,
   random and shorter read-in-window classes; seeded): cost and end must
   be exactly equal on every job.  Median ms of both, timed in turns, and
   the host time of the native ``glocal_batch`` (DP with traceback, the
   reference's rescue) on the same jobs, whose costs must agree too.  Then
   the edges of the kernel's decomposition, each held exactly against
   plain: the narrowest rescue window (L + 8 columns); windows of 2,500
   columns, which span several register tiles, at full and at mixed
   lengths (the latter with more jobs than warps, so that warps loop); a
   width that is no multiple of 32 or of a lane's run; mixed read and
   window lengths with windows shorter than their reads, empty windows and
   empty reads; reads of N only; one job; a job count that is no multiple
   of the warps in a block.
6. Paired-end main path: ``align-pe --engine beam --device cuda`` at the
   CLI defaults (``-a 500``, 16,384 pairs a batch) on phase 3's genome and
   index, 32,768 pairs of 150 bp from fragments of about N(400, 30) bp
   with 2 substitutions each, end 2 reverse-complemented; every 8th
   pair's end 2 carries 12 more substitutions, over the search budget
   and within the rescue's.
7. Checks: among the other pairs, the fraction of mapped ends and of
   mapped ends within 2 bp of their origin; the fraction of the heavy
   mates placed by rescue (``XT:Z:M``) within 2 bp of their origin; the
   select kernel's launches during phase 6 alone equal 2 x n_steps x
   batches, and the glocal kernel's equal the number of batches with
   rescue jobs, which must be above 0.  Then 512 pairs through
   ``align-pe`` on ``cuda`` and on ``cpu`` (the plain path) must give
   byte-equal SAMs.  Last, glocal_screen against plain once more, checked
   and timed as in phase 5, at the ``(R, L, G)`` of the largest screen that
   phase 6 launched (all its shapes are printed), and select_topk's launch
   shapes on this path as in phase 4.
7a. Paired ends on the pigeon route: the 12-mer seed table of phase 3's
   index, built on the card and written beside the index (``kmer12.npz``),
   then loaded from that file, each timed; then ``align-pe --device cuda``
   with no ``--engine`` (the CLI's default, ``auto``) on phase 6's pairs
   with a pair of 200 bp ends after every 128th (256 pairs too long for the
   pigeon engine: the router hands their ends to the beam, pooled by the
   paired stream's flush), with both kernels' counts set to 0 just before.
7b. Checks: per batch its fallback, trunc and retry fractions and its
   rescue jobs; phase 7's gates over all pairs (the long ones count as
   plain pairs); glocal_screen launched once per batch with rescue jobs and
   more than 0 times, and held against plain at its largest launch shape;
   select_topk launched more than 0 times, every recorded shape held
   against plain; 512 pairs (rescued mates and long pairs among them)
   through ``align-pe --engine auto`` on ``cuda`` and ``cpu``: byte-equal;
   then the pigeon route's records against the beam's, pair by pair on one
   batch of phase 6's pairs (the rule is ``pe_engine_compare``'s
   docstring).
7c. The beam ladder: ``align --engine beam --ladder 8,64 --device cuda`` on
   the first batch of phase 3's reads (its mapped and placed fractions and
   its launches: 2 x n_steps at each of the two rungs), then the first 256
   reads on ``cuda`` and ``cpu``: byte-equal; select_topk held against
   plain at every shape these runs launched.
7d. The two-phase flow, with both kernels' counts set to 0 just before:
   ``aln --device cuda`` at the CLI defaults on each mate file of phase
   7a, ``sampe --device cuda`` over the two ``.sai`` files, then ``aln`` and
   ``samse`` on phase 8's reads.  Prints each window, pairs/s (and reads/s)
   over their sum, the ``.sai`` sizes and each ``aln``'s search split into
   the pigeon route and its inline beam fallback (a beam run per batch:
   ``aln`` does not pool).  The ``sampe`` records must equal phase 7a's
   ``align-pe`` records byte for byte (the ``samse`` records phase 8's
   ``align`` records, checked in phase 9); select_topk launched 2 x
   (longest read + 7) times per inline beam run and held against plain at
   every shape ``aln`` launched it at (the tail batch's run is narrow);
   glocal_screen launched once per ``sampe`` batch with rescue jobs and held
   at every shape no earlier phase held; the first 512 pairs through ``aln``
   x2 + ``sampe`` on ``cuda`` and ``cpu``: byte-equal; last, ``aln
   --resume`` over the finished run searches nothing (no select_topk
   launch) and leaves the ``.sai`` arrays as they were.
8. Pigeon main path: the seed table is phase 7a's (loaded from
   ``kmer12.npz``); ``align --engine auto --device cuda`` at
   the CLI defaults over phase 3's reads with a 200 bp read after every
   64th (512 reads too long for the pigeon engine: the router hands them
   to the beam, pooled over the stream's batches), with the select
   kernel's count set to 0 just before.
9. Pigeon checks: reads/s over the align window and peak device memory;
   mapped >= 0.95 and placed within 2 bp >= 0.99 over all reads; the select
   kernel's launches during phase 8 alone, which must be above 0, and
   their shapes: the pooled beam runs over the long reads are narrower than
   phase 3's batches, so select_topk is held exactly against plain, and
   timed beside the library call and its bound, at each of them (frontier
   select and hit merge); one
   batch through ``Aligner.align`` for the engine's fallback, ineligible,
   trunc and retry fractions; the first 260 reads through ``align
   --engine auto`` on ``cuda`` and on ``cpu``: byte-equal SAMs, equal to
   the full run's first records; phase 7d's ``aln`` + ``samse`` records
   equal to the full run's, byte for byte; and the pigeon engine's records
   against
   the beam's on one batch of phase 3's reads (the rule is
   ``engine_compare``'s docstring: byte-equal but for the engines'
   documented differences, which are listed; anything else fails).
10. Repeat path at small size: a genome of 120,000 bp with an exact and a
   diverged repeat family, 1,088 reads (in-repeat, diverged, straddling,
   flank-mismatch, background, long) through ``Aligner.align_stream`` at
   the small caps the repeat tests set, with full-segment anchors (K = 0)
   and with 6-mer seeds forced: truncation, the ``seg_phase`` retry and
   the pooled beam flush must all occur, ``cuda`` against ``cpu``
   byte-equal; then select_topk against plain at every shape these flushes
   launched it at.
10b. The sharded index (``hsa_tpu_torch.dist``): worlds of ranks on this
   card, each rank a fresh process (``--shard-rank``, started by
   ``dist.launch.run_world``) and one ``(data, shard)`` coordinate: ``(1,
   1)`` over nccl (one rank per card), ``(1, 4)`` and ``(2, 2)`` over gloo
   (four ranks sharing the card; the merge's ``all_reduce`` takes CUDA
   tensors and stages them through host memory).  Each rank keeps its row
   range of phase 3's index on the card and runs every ``ShardedIndex``
   entry point on the whole inputs: ``pigeon_fn`` on phase 3's first batch
   (16,384 reads, both strands, k = 2, phase 7a's 12-mer table replicated),
   ``exact_fn``, ``width_fn`` and ``beam_fn`` (W=64, the CLI defaults) on
   its first 4,096 reads, ``locate_fn`` on the ranks of the unsharded
   pigeon search's positions, and at ``(1, 4)`` the LF walk on the repeat
   path's genome indexed without the direct SA.  Every rank's whole result
   must equal the port's unsharded result on the card bit for bit (pigeon
   at two data slices: the per-lane fields exactly, the pool and gapped
   entries as sets, the occurrences exactly); every merge must have run on
   CUDA tensors, the ranks of a shard group must have merged alike, and
   select_topk must have launched 2 x 107 times in each beam call.
   Each entry point runs twice a rank (the first call in a fresh process);
   prints per world and entry point the slowest rank's wall seconds of
   both calls, the all-reduces and the bytes a shard of a call, and the
   unsharded calls' warm walls; then select_topk against plain at every
   shape the ranks launched it at.  At ``(1, 4)`` the ranks also run phase
   10c's four FM functions on its ranks, one merge each, equal to the
   unsharded card.
10c. The rest of the device API.  ``search/fm.py``'s ``occ_lt4``,
   ``extend4``, ``bwt_char`` and ``lf`` at 131,072 ranks of phase 3's index
   (uniform, the primary and its neighbours, both ends of the range, the
   edges of 4,097 blocks): the card bit-equal to the same functions on the
   CPU and to the oracle's ``FMIndex`` of the 46.7 Mbp genome, read back
   from ``text.pac`` and built by its fields from the native suffix array
   (forward and reverse); ``oracle_align`` with those indexes at
   ``max_diff`` 2 on 128 reads of that genome (clean, 1 and 2 mismatches,
   reverse strand, a 1-bp deletion) against ``Aligner(...,
   device="cuda")``: the beam at W=1024 and W=1820 (the widest the keys
   allow) byte-equal, the states and hits each dropped printed by read kind,
   ``auto`` at W=1024 byte-equal but for records listed under deviation 13;
   ``hsa_tpu_torch.entry``: the
   step of ``entry("cuda")`` bit-equal to ``entry("cpu")``'s, its warm wall
   and device kernels under ``torch.profiler``; ``dryrun_multichip(1)``
   (nccl) and ``(4)`` (gloo, the ranks on this card), every rank's hits and
   pigeon_mapped equal to the unsharded dry run's; the library's two-phase
   API, ``search_batch_device`` then ``resolve_handle``, on phase 3's first
   4,096 reads, ``cuda`` byte-equal to ``cpu`` (a process of its own,
   ``--handle-cpu``, beside the rest of the phase), and, not gated, how many
   records equal ``align --engine beam``'s; select_topk against plain at
   every shape these routes and the dry runs' ranks launched it at.
11. With ``--profile``, where the time goes on the warm card: each
   single-end batch's stream phases (search; readback + hits + locate;
   resolve) one after another with the device synchronised between them;
   one batch's search under ``torch.profiler`` (kernel launches, host
   time in torch ops, device busy time, idle share, the top kernels and
   select_topk's own, peak memory); ``align --device cuda`` twice more, warm, against the
   sequential sum; then the same per-batch phases and warm runs for
   ``align-pe --engine beam``, with the mate rescue timed apart; then the
   paired pigeon route (``align-pe`` at its default engine): per batch
   pack, upload + search, readback, host finalise, pairing + rescue + SAM
   with the rescue's seconds and jobs, one batch's device search under
   ``torch.profiler`` (launches, device busy, idle share, peak memory),
   and two warm runs; then the single-end pigeon route:
   per batch pack, upload + search, readback, host finalise and resolve;
   one batch's device search under ``torch.profiler``, whole and split by
   the engine's stages (upload, K-mer seed + anchor scan, extension loops,
   order + slots, compaction, locate, window fetch, ungapped verify, gapped
   screen: kernel launches, device busy, idle share); ``align --engine
   auto`` twice more, warm.
12. The oracle: the port's reference path (``pipeline.oracle_align`` and
   ``oracle_align_pe``: the numpy FM index, the branch-and-bound search on
   the host, the list resolvers) against the card's engines, on a genome of
   2^20 bp from ``--seed`` in two records (786,432 and 262,144 bp), indexed
   by ``cli index``, at ``AlnOpt(max_diff=2)``.  Single end: 256 reads of
   100 bp in rotation over clean, 1 and 2 mismatches, reverse strand, a
   1-bp deletion, a 1-bp insertion, one N and junk, plus 2 across the
   records' boundary, through ``Aligner(..., device="cuda")`` at
   ``beam_width=512``: ``engine="beam"`` (every record byte-equal to the
   oracle's; the frontier states and hits the beam dropped printed by read
   kind) and ``"auto"`` (byte-equal but for the listed and counted records
   that differ in XM/XO/XG alone, docs/PARITY.md deviation 13); then the
   beam at W=1820, the widest the keys allow, which must drop nothing and
   be byte-equal.  Paired end: 64 pairs of 100 bp ends, fragments about
   N(300, 20), every 3rd end 1 with a mismatch, every 8th end 2 with 12
   more substitutions (rescue), a junk end 1, a discordant pair (end 2
   100 kbp away): ``align_pe(..., beam_width=256)`` at both engines
   against ``oracle_align_pe(..., device="cuda")``, the same rule.
   glocal_screen's launches from ``oracle_align_pe`` (1 or more) held
   against plain at their shape; select_topk at every shape each route
   launched, then the tall frontier ``[4608, 16384]`` K=512 and the edges
   of the kernel's tall variant (W=1820's frontier and merge, every key
   valid, fewer valid keys than K, a ragged width), each exact and timed
   against plain and ``torch.topk`` beside its bound.  Then, printed and not
   gated, 64 reads of phase 3's kind at the CLI defaults (``AlnOpt()``,
   W=64) through both engines and the oracle: how many records are
   byte-equal, and the first differing field of the others.  Prints the
   seconds of every route and of the phase.
13. Prints the kernel table as one JSON line (per kernel: launches on the
   main paths, max |err|, ms, plain_ms, library_ms (for select_topk those of
   one beam step of ``align --engine beam``, with every path's own step at
   the widest shape it launched under ``step_by_path`` and every compared
   shape under ``shapes``), and bound_ms, the least
   time the card could take: the larger of the bytes the function must move
   over 3.35 TB/s and the integer instructions it must issue over 132 SMs x
   64 int32 lanes x the card's maximum SM clock.  For the glocal DP those
   are the 4.5 a cell that must run on those lanes when the card's fused
   add-min and three-way-min instructions are used and the adds go to the
   multiply-add pipe; bound_ops11_ms beside it counts the recurrence's 11
   int32 operations a cell, written out unfused, which is no bound on this
   card (a kernel can read under it) and is kept so that rows of earlier
   measurements compare; host_ms is the wrapper's host time per launch, the
   floor of ``ms`` for a small launch; for the gather kernels the probe
   modules' launches and, under ``launches_by_path``, the count measured
   on the main paths (null with ``--probes-only``), device_ms (queued
   calls), every probe launch under ``shapes`` and for gather_rows phase
   4b's four cases under ``main_table``, its top-level times those of the
   real extend with the L2 flushed), then, as the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 46_709_983          # human chr21 (BASELINE config 3)
N_READS, READ_LEN, BATCH = 32_768, 100, 16_384
CROSS_CHECK = 256
MAPPED_MIN, PLACED_MIN = 0.95, 0.99
FRONTIER = dict(C=576, B=32_768, K=64, window=True)
MERGE = dict(C=352, B=32_768, K=32, window=False)
SCORES = (3, 11, 4)             # -M -O -E at the CLI defaults
GLOCAL = dict(R=16_384, L=150, G=576)
PE_PAIRS, PE_LEN, PE_ISIZE, PE_ISIZE_SD = 32_768, 150, 400, 30
HEAVY_EVERY, HEAVY_SUBS = 8, 12
PE_CROSS_CHECK = 512
# the paired pigeon path: phase 6's pairs with a pair of ends too long for
# the engine after every PE_LONG_EVERY-th
PE_LONG_EVERY, PE_LONG_LEN = 128, 200
LADDER = "8,64"
PE_MAPPED_MIN, PE_PLACED_MIN, RESCUED_MIN = 0.99, 0.99, 0.95
# the card's peaks for the bounds: device memory rate (H100 SXM data sheet)
# and int32 lanes; the int32 rate is lanes x the maximum SM clock
HBM_BYTES_S = 3.35e12
INT32_LANES = 132 * 64
# int32 operations of one cell of the glocal DP when the recurrence
# (hsa_tpu_torch/kernels/sw.py:glocal_screen_plain) is written out with
# two-operand operations.  No bound on a card with fused add-min and three-way
# min and a second pipe that adds: printed as bound_ops11_ms, the figure that
# earlier measurements of this kernel were held to.
#   sub   = (read base != window base) ? s_mm : 0        compare, select    2
#   m'    = min(m[j-1], ins[j-1], del[j-1]) + sub        2 min, 1 add       3
#   ins'  = min(m[j] + s_gapo, ins[j] + s_gape)          2 add, 1 min       3
#   del'  = ramp[j] + prefixmin(m'[j'] - ramp[j'] + c)   add, min, add      3
# (the ramp j * s_gape and the constant are per column, the N test per row)
GLOCAL_OPS_PER_CELL = 11
# the fewest instructions per cell that must run on the card's integer pipe
# (the 64 lanes an SM that the rate above counts) when the fused instructions
# of sm_90 are used: the compare 1, an add-min each for ins' and for the
# prefix-min 2, a three-way min for min(m', ins', del') 1, half a three-way
# min for the prefix-min's pass over a run of columns that one thread holds
# 0.5.  The adds, and the select done as predicated adds, can run on the
# multiply-add pipe beside it, so they are not counted.  This is bound_ms.
GLOCAL_FUSED_PER_CELL = 4.5
GLOCAL_EDGES = [          # name, R, L, G, lengths
    ("edge: narrowest window (L + 8)", 4_096, 150, 158, "classes"),
    ("edge: window over several register tiles", 1_024, 150, 2_500, "classes"),
    ("edge: several tiles, mixed lengths, warps looping over jobs", 2_501, 150,
     2_500, "mixed"),
    ("edge: width no multiple of 32 or of a lane's run", 1_001, 150, 601,
     "classes"),
    ("edge: mixed lengths, short and empty windows, empty reads", 2_051, 150,
     576, "mixed"),
    ("edge: reads of N only", 513, 150, 576, "all N"),
    ("edge: one job", 1, 150, 576, "classes"),
    ("edge: jobs no multiple of the warps in a block", 4_099, 150, 576,
     "classes"),
]
# the pigeon main path: phase 3's reads with a read too long for the engine
# (the router hands it to the beam) after every PIGEON_LONG_EVERY-th
PIGEON_LONG_EVERY, PIGEON_LONG_LEN = 64, 200
PIGEON_CROSS_CHECK = 4 * (PIGEON_LONG_EVERY + 1)
# the repeat path: a small genome (under 2^24 bp: full-segment anchors) with
# an exact and a diverged repeat family, and caps small enough to truncate
REPEAT = dict(bp=120_000, unit=300, copies=40, div=0.04, reads=1_024,
              batch=256, L=90, long_every=16,
              caps=dict(_PIGEON_SEG_CAP=4, _PIGEON_CAND_CAP=8,
                        _PIGEON_REPEAT_THRESH=10.0,
                        _PIGEON_RETRY_CAPS=(6, 8, 4)))
REPEAT_CLEAN_MAPPED_MIN = 0.95
# the sharded index (phase 10b): worlds of ranks, each one process and one
# (data, shard) coordinate on this card; pigeon at k = 2 on phase 3's first
# batch (n_seg = k + 1) at the CLI's caps; the beam at the CLI defaults on
# SHARD_BEAM_READS of its reads (cut from 16,384 for the run's time); the LF
# walk on the repeat path's genome without the direct SA, at SHARD_WALK_MESH
SHARD_WORLDS = (("nccl", 1, 1), ("gloo", 1, 4), ("gloo", 2, 2))
SHARD_PIGEON_OPT = dict(max_diff=2)
SHARD_N_SEG = 3
SHARD_CAPS = dict(seg_cap=32, cand_cap=48, pool_mult=4)
SHARD_BEAM_READS, SHARD_BEAM_W, SHARD_BEAM_H = 4_096, 64, 32
SHARD_WALK_MESH, SHARD_WALK_RANKS = (1, 4), 4_096
SHARD_PG_TIMEOUT_S, SHARD_WORLD_TIMEOUT_S = 60, 300
# the oracle phase (12): the port's host oracle against the card's engines on a
# genome its prefix-doubling suffix array builds in seconds (fmcore.py: "good
# to ~1e6"), in two records; the reference's parity settings (max_diff 2,
# W=512 single end, W=256 paired; tests/test_resolve.py, tests/test_sampe.py)
ORACLE_BP = (786_432, 262_144)
ORACLE_READS, ORACLE_PAIRS, ORACLE_L, ORACLE_MAX_DIFF = 256, 64, 100, 2
ORACLE_KINDS = ("clean", "1 mismatch", "2 mismatches", "reverse strand",
                "1-bp deletion", "1-bp insertion", "one N", "junk")
ORACLE_ISIZE, ORACLE_ISIZE_SD, ORACLE_HEAVY, ORACLE_FAR = 300, 20, 12, 100_000
ORACLE_SE_W, ORACLE_PE_W = 512, 256
# a beam that drops nothing on the single ends: the widest the keys allow
# (9W < 2^14).  At W=512 the frontier of the reads with an exact hit holds
# more than 512 states near depth log4(2^20) = 10, so that beam is held to
# the oracle's records alone
ORACLE_FULL_W = 1820
ORACLE_CLI_READS, ORACLE_CLI_W = 64, 64
# the frontier select of a beam of W=512 at a batch's 16,384 columns, and the
# edges of the kernel's tall variant (one column a block): the widest beam the
# keys allow (9W < 2^14: W=1820) at both selects, every key valid, fewer valid
# keys than K in every column, a width no multiple of 32
ORACLE_TALL = dict(C=9 * 512, B=16_384, K=512, window=True)
ORACLE_TALL_EDGES = [
    dict(C=9 * 1820, B=2_048, K=1820, window=True, name="edge: tall, W=1820"),
    dict(C=5 * 1820 + 64, B=2_048, K=64, window=False,
         name="edge: tall merge, W=1820, H=64"),
    dict(ORACLE_TALL, B=2_048, window=False, valid=1.0,
         name="edge: tall, every key valid"),
    dict(ORACLE_TALL, B=2_048, valid=0.05,
         name="edge: tall, fewer valid keys than K"),
    dict(ORACLE_TALL, B=2_048 - 19, name="edge: tall, width no multiple of 32"),
]
# the rest of the device API (phase 10c): search/fm.py's four functions on
# API_RANKS ranks of phase 3's index (API_BLOCKS random 32-rank blocks' edges
# among them); the oracle at phase 3's size on API_ORACLE_READS reads of
# API_ORACLE_KINDS at max_diff 2 against the beam at API_ORACLE_W (phase 12:
# W >= 1,024 dropped nothing at 2^20 bp; the widest the keys allow) and the
# auto route; entry() and dryrun_multichip(n) for n in API_DRYRUNS; the
# two-phase library API on phase 3's first API_HANDLE_READS reads, its CPU
# side in a process of API_HANDLE_THREADS threads
API_RANKS, API_BLOCKS = 131_072, 4_096
API_ORACLE_READS, API_ORACLE_MAX_DIFF = 128, 2
API_ORACLE_KINDS = ("clean", "1 mismatch", "2 mismatches", "reverse strand",
                    "1-bp deletion")
API_ORACLE_W = (1024, 1820)
API_DRYRUNS = (1, 4)
API_HANDLE_READS, API_HANDLE_THREADS = 4_096, 4
API_PHASE = ("10c. the rest of the device API: fm.py's four functions, the "
             "oracle at phase 3's size, entry(), dryrun_multichip, "
             "resolve_handle")
ACGT = np.frombuffer(b"ACGT", np.uint8)


ORACLE_PHASE = ("12. the oracle: the card's records against the port's "
                "branch-and-bound (oracle_align, oracle_align_pe)")


def smoke_dir():
    """Where the script keeps its indexes and reads (listed in .gitignore)."""
    path = os.path.join(ROOT, "hsa_tpu_torch", "_build", "smoke")
    os.makedirs(path, exist_ok=True)
    return path


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)


# -- 1. device and build ------------------------------------------------------
def device_info():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    print(r.stdout.strip())
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    mhz = float(r.stdout.split()[0])
    print(f"maximum SM clock {mhz:.0f} MHz: int32 peak "
          f"{INT32_LANES * mhz * 1e6:.4e} operations/s")
    return INT32_LANES * mhz * 1e6


def build_kernels(baseline=None):
    """Every CUDA source of the package (and the ``baseline`` kernels), one
    nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from hsa_tpu_torch.kernels import gather, select, sw
    kernels = {"select_topk": select.KERNEL, "glocal_screen": sw.KERNEL,
               **gather.KERNELS, **(baseline.kernels if baseline else {})}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:
        for fut in [ex.submit(k.lib) for k in kernels.values()]:
            fut.result()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s")
    for name, k in kernels.items():
        print(f"{name}: nvcc {k.build_s} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


# -- 2. kernel against plain ---------------------------------------------------
def make_select_case(C, B, window, rs, device, valid=0.3, dead_every=0):
    """Beam-like select inputs: unique row-tagged keys, a fraction ``valid``
    of them valid; with ``dead_every``, no valid key in every such column."""
    import torch
    from hsa_tpu_torch.kernels.select import KEY_SH, SENT
    row = np.arange(C, dtype=np.int64)[:, None]
    score = rs.randint(0, 40, (C, B)).astype(np.int64)
    key = np.where(rs.rand(C, B) < valid, (score << KEY_SH) | row, SENT | row)
    if dead_every:
        key[:, ::dead_every] = SENT | row
    pays = [rs.randint(-2 ** 31, 2 ** 31, (C, B), dtype=np.int64)
            for _ in range(3)]
    win = rs.randint(5, 40, B) if window else None

    def dev(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(device)
    return dev(key), [dev(p) for p in pays], dev(win)


def compare_select(k_out, p_out):
    """Max |kernel - plain| over valid slots, the drop row and nvalid;
    fails on any difference or on a malformed invalid slot."""
    import torch
    from hsa_tpu_torch.kernels.select import SENT
    (kk, kp, kd), (pk, pp, pd) = k_out, p_out
    K = kk.shape[0] - 1
    kv, pv = kk[:K] < SENT, pk[:K] < SENT
    if not torch.equal(kv, pv):
        fail("select_topk: valid slots differ from the plain version")
    errs = [(torch.where(kv, kk[:K], 0).long() - torch.where(pv, pk[:K], 0).long()).abs().max(),
            (kd.long() - pd.long()).abs().max()]
    for a, b in zip(kp, pp):
        errs.append((torch.where(kv, a, 0).long() - torch.where(pv, b, 0).long()).abs().max())
    if (kk[:K][~kv] != SENT).any() or any((a[~kv] != 0).any() for a in kp):
        fail("select_topk: invalid slots are not SENT / payload 0")
    err = int(torch.stack(errs).max())
    if err:
        fail(f"select_topk differs from the plain version (max |err| {err})")
    return err


def time_turns(fns, rounds=15, warm=3, before=None):
    """Median ms of each function, timed in turns (a, b, b, a, ...) with
    CUDA events around every call; ``before`` (say, a write that flushes the
    L2 cache) runs ahead of each call, outside the events."""
    import torch
    for f in fns:
        for _ in range(warm):
            f()
    times = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            if before is not None:
                before()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[i]()
            e1.record()
            torch.cuda.synchronize()
            times[i].append(e0.elapsed_time(e1))
    return [statistics.median(t) for t in times]


def select_library(key, pays, K, window=None):
    """The library yardstick: one ``torch.topk`` of the K smallest keys per
    column (window applied first) and a gather per payload.  Timed here,
    called nowhere in the port."""
    import torch
    from hsa_tpu_torch.kernels.select import KEY_SH, SENT
    if window is not None:
        key = torch.where((key >> KEY_SH) > window.reshape(1, -1), key | SENT,
                          key)
    top, idx = torch.topk(key, K, dim=0, largest=False, sorted=True)
    return top, tuple(p.gather(0, idx) for p in pays)


def select_bound_ms(key, K, n_pay, window, int32_ops_s):
    """(bound ms, what binds it, sector-granular bound ms) of one select on
    this input.  Bytes: the keys and the window read once, the K + 1 key rows
    and K rows per payload written once, and per column min(nvalid, K) picks
    per payload of 4 bytes each, the compulsory traffic (never more than the
    payload matrix itself).  Operations: one validity test per key and, per
    column, its valid keys against the running K-th best.  The third value
    charges each pick a whole 32-byte sector instead, as the memory system
    moves it when neighbouring columns pick different rows: a looser bound,
    printed beside the first."""
    import torch
    from hsa_tpu_torch.kernels.select import KEY_SH, SENT
    C, B = key.shape
    k = key if window is None else torch.where(
        (key >> KEY_SH) > window.reshape(1, B), key | SENT, key)
    picks = int((k < SENT).sum(dim=0).clamp(max=K).sum())
    fixed = (C * B * 4 + (B * 4 if window is not None else 0)
             + (K + 1 + n_pay * K) * B * 4)
    ops = 2 * C * B + int((k < SENT).sum())
    t_ops = ops / int32_ops_s
    t_bytes, t_sector = ((fixed + n_pay * min(picks * g, C * B * 4))
                         / HBM_BYTES_S for g in (4, 32))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            max(t_sector, t_ops) * 1e3)


def select_key(case):
    """What the wrapper records of a launch: (C, B, K, window given)."""
    return case["C"], case["B"], case["K"], bool(case["window"])


def select_compare(case, rs, int32_ops_s):
    """Kernel == plain exactly on one seeded case, the library yardstick the
    same function, then median ms of the three in turns beside the bounds."""
    import torch
    from hsa_tpu_torch.kernels import select
    C, B, K, window = select_key(case)
    key, pays, win = make_select_case(
        C, B, window, rs, "cuda", valid=case.get("valid", 0.3),
        dead_every=case.get("dead_every", 0))
    run_k = lambda: select.select_topk(key, pays, K, window=win)   # noqa: E731
    run_p = lambda: select.select_topk_plain(key, pays, K, window=win)  # noqa: E731
    run_l = lambda: select_library(key, pays, K, window=win)       # noqa: E731
    k_out, p_out = run_k(), run_p()
    torch.cuda.synchronize()        # a fault in the kernel shows here
    err = compare_select(k_out, p_out)
    lib_top = run_l()[0]
    if not torch.equal(lib_top[lib_top < select.SENT],
                       p_out[0][:K][p_out[0][:K] < select.SENT]):
        fail("the library yardstick computes another function")
    bound_ms, bound_by, sector_ms = select_bound_ms(
        key, K, len(pays), win, int32_ops_s)
    ms, plain_ms, library_ms = time_turns([run_k, run_p, run_l])
    shape = f"[{C}, {B}] K={K}" + (" window" if window else "")
    print(f"select_topk {case['name']} {shape}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (topk + gathers) "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{ms / bound_ms:.2f}x), with a 32-byte sector per pick "
          f"{sector_ms:.4f} ms ({ms / sector_ms:.2f}x), max |err| {err}")
    return dict(case=case["name"], shape=shape, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_sector_ms=sector_ms, max_abs_err=err)


def kernel_phase(seed, int32_ops_s):
    rs = np.random.RandomState(seed)
    B = FRONTIER["B"]
    cases = [dict(FRONTIER, name="frontier"), dict(MERGE, name="merge"),
             dict(FRONTIER, name="edge: every key valid", window=False,
                  valid=1.0),
             dict(MERGE, name="edge: no valid key in every third column",
                  window=True, dead_every=3),
             dict(FRONTIER, name="edge: width no multiple of 32", B=B - 19)]
    shapes = [select_compare(case, rs, int32_ops_s) for case in cases]
    # the beam step's two shapes, by what the wrapper records of a launch
    return shapes, {select_key(c): row for c, row in zip(cases[:2], shapes)}


def select_path_phase(path, launched, compared, seed, int32_ops_s):
    """select_topk at the shapes a main path launched it at.  Prints every
    ``(C, B, K, window)`` of ``launched`` (the wrapper's record of the path's
    launches) with its count; a shape that ``compared`` (shape -> row) does
    not hold yet is checked against plain and timed like phase 2's, on
    seeded beam-like inputs of that shape, and added.  Returns the rows of the
    path's two widest shapes, the frontier select (window) and the hit merge
    (none) of one beam step at the path's widest batch."""
    if not launched:
        fail(f"select_topk recorded no launch shape on {path}")
    rs = np.random.RandomState(seed + 8)
    for key in sorted(launched, key=lambda k: (-k[1], -k[0])):
        C, B, K, window = key
        known = key in compared
        print(f"select_topk on {path}: {launched[key]} launches at [{C}, {B}] "
              f"K={K}" + (" window" if window else "")
              + (" (compared above)" if known else ""))
        if not known:
            kind = "frontier" if window else "merge"
            compared[key] = select_compare(
                dict(C=C, B=B, K=K, window=window, name=f"{path}: {kind}"),
                rs, int32_ops_s)
    step = []
    for window in (True, False):
        keys = [k for k in launched if k[3] == window]
        if not keys:
            fail(f"{path} launched select_topk "
                 f"{'with' if window else 'without'} a window no time")
        step.append(compared[max(keys, key=lambda k: (k[1], k[0]))])
    return step


# -- 2b. the FM row-gather probes --------------------------------------------
# dense int8 tensor-core peak (H100 SXM data sheet), for onehot_gather's bound
INT8_TC_OPS_S = 1.979e15
# the port's probe modules and the tests of each that launch a kernel ([]: all)
PROBE_RUNS = [("gather_probe", ["dma", "vmemtake"]),
              ("gather_probe2", ["dmapipe", "rowloop", "onehot", "vmemsize"]),
              ("gather_probe3", []), ("sync_probe", ["dma", "vmemtake"])]
# rows one extend gathers over a paired pigeon batch's 65,536 lanes (both
# interval ends, search/fm.py:extend)
MAIN_TABLE_QUERIES = 131_072
L2_FLUSH_BYTES = 128 << 20      # a write that evicts the card's 50 MB L2
# device_ms: calls queued behind torch.cuda._sleep, long enough (about 1 ms
# a call at the card's clock) for the host to issue them all first
QUEUED_CALLS = 20
SLEEP_CYCLES_PER_CALL = 2_000_000
# the probes' tables above this card's on-chip capacity (116,224 rows of 32
# bytes), each refused by table_take before launch; the probe modules print
# the first of vmemsize's bisect (it stops there) and sync_probe's 4 MB one
REFUSED_TABLES = [f"vmem table {mb} MB" for mb in (4, 8, 16, 32, 64, 96)] + [
    "pallas VMEM take [4MB] Q=2^17"]
REFUSED_BY_MODULES = ["vmem table 4 MB", "pallas VMEM take [4MB] Q=2^17"]
# the backward-search step of phase 4b's real extend: past log4(n) (12.7 at
# 46.7 Mbp) most live intervals span a row or two
EXTEND_STEP = 20
# the larger cases, where fixed costs amortise: gather_rows at the main
# path's table and table_take at the probes' 1 MB table, 2^20 rows each
LARGE_QUERIES = 1 << 20
# --gather-only's sweeps of the plans: gather_rows' rows a tile (phase 4b),
# table_take's slices of the 1 MB table and groups of a launch ("most": one
# block an SM; phase 2b)
SWEEP_CHUNKS = (32, 64, 128, 256, 512, 1024)
SWEEP_SLICES = (8, 16)
SWEEP_GROUPS = (1, 2, 4, 8, "most")
PROBE_PHASE = ("2b. the FM row-gather probes: gather_rows, table_take and "
               "onehot_gather at every TPU probe launch they replace")
MAIN_TABLE_PHASE = "4b. the FM row gather at the main path's table"


def probe_modules():
    import importlib
    return [(importlib.import_module(f"hsa_tpu_torch.tools.{name}"), tests)
            for name, tests in PROBE_RUNS]


def drive_probes(dev="cuda"):
    """The port's probe modules through their entry point (what ``python -m
    hsa_tpu_torch.tools.<name> --device cuda <test ...>`` runs), in process,
    with the three gather kernels' counts set to 0 just before and read just
    after.  Each probe's own check must read correct=True, and the only
    FAILED lines are table_take's refusals (``ValueError``) of
    REFUSED_BY_MODULES, each once."""
    import contextlib
    import io
    import torch
    from hsa_tpu_torch.kernels import gather
    from hsa_tpu_torch.tools import _timing
    torch.cuda.synchronize()
    for k in gather.KERNELS.values():
        k.launches = 0
        k.launch_shapes.clear()
    refusals = []
    for mod, tests in probe_modules():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _timing.main(mod.TESTS, ["--device", dev, *tests], mod.__doc__)
        print(f"python -m {mod.__name__} --device {dev} {' '.join(tests)} "
              f"({time.perf_counter() - t0:.3f} s):")
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"  {line}")
        for line in lines:
            label = line.split(": FAILED ValueError")[0]
            if "FAILED" in line and label in REFUSED_BY_MODULES:
                refusals.append(label)
            elif "correct=False" in line or "FAILED" in line:
                fail(f"{mod.__name__} on the card: {line}")
    torch.cuda.synchronize()
    print(f"refused before launch by the probe modules: {refusals}")
    if sorted(refusals) != sorted(REFUSED_BY_MODULES):
        fail(f"the probe modules refused {refusals}, not "
             f"{REFUSED_BY_MODULES}")
    launches = {name: k.launches for name, k in gather.KERNELS.items()}
    print(f"launches of the probe modules: {launches}")
    if not all(launches.values()):
        fail(f"a gather kernel was launched no time by the probes: {launches}")
    return launches


def device_ms(fn, calls=QUEUED_CALLS, before=None):
    """Device time per call: median over ``calls`` calls queued behind a
    sleeping kernel, so that the card runs them back to back whatever the
    host's time to issue each, with CUDA events around every call.
    ``before`` runs ahead of each call, outside its events."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * calls)
    events = []
    for _ in range(calls):
        if before is not None:
            before()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def host_ms(fn, rounds=15):
    """Median host time to issue one call (the floor of a single call's
    event-timed ms)."""
    import torch
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def device_ms_turns(fns, before=None):
    """:func:`device_ms` of each function, taken in turns (a, b, ..., b,
    a): the mean of its two medians."""
    fwd = [device_ms(f, before=before) for f in fns]
    rev = [device_ms(f, before=before) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(fwd, rev)]


def launch_floor_ms():
    """What :func:`device_ms` reads for a one-element torch op: the floor
    under every device time it reports."""
    import torch
    x = torch.zeros(1, device="cuda")
    return device_ms(lambda: x.add_(1))


class Baseline:
    """The earlier sources of gather_rows.cu and table_take.cu in ``path``
    (with their C interfaces ``hsa_gather_rows(tab, nb, w, q, nq, pipe,
    chunk, out, stream)`` and ``hsa_table_take(tab, nb, q, nq, out,
    stream)``: ``git show 93331e4:hsa_tpu_torch/csrc/<name>.cu``), built
    by kernels/build.py beside the current kernels."""

    CHUNK = 256                  # the earlier wrapper's default chunk

    def __init__(self, path):
        import ctypes
        from hsa_tpu_torch.kernels.build import CudaKernel
        vp, i = ctypes.c_void_p, ctypes.c_int

        def rows(lib):
            lib.hsa_gather_rows.argtypes = [vp, i, i, vp, i, i, i, vp, vp]
            lib.hsa_gather_rows.restype = i

        def take(lib):
            lib.hsa_table_take.argtypes = [vp, i, vp, i, vp, vp]
            lib.hsa_table_take.restype = i
        self.kernels = {
            "gather_rows (baseline)": CudaKernel(
                os.path.abspath(os.path.join(path, "gather_rows.cu")), rows),
            "table_take (baseline)": CudaKernel(
                os.path.abspath(os.path.join(path, "table_take.cu")), take)}

    @staticmethod
    def _run(name, launch, tab, q):
        """``launch(out pointer, stream)`` into a new [NQ, W] output."""
        import torch
        out = torch.empty((q.numel(), tab.shape[1]), dtype=torch.int32,
                          device=tab.device)
        err = launch(out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"{name} launch failed: CUDA error {err}")
        return out

    def gather_rows(self, tab, q, pipe, chunk):
        fn = self.kernels["gather_rows (baseline)"].lib().hsa_gather_rows
        return self._run("gather_rows (baseline)", lambda out, st: fn(
            tab.data_ptr(), tab.shape[0], tab.shape[1], q.data_ptr(),
            q.numel(), pipe, chunk, out, st), tab, q)

    def table_take(self, tab, q):
        fn = self.kernels["table_take (baseline)"].lib().hsa_table_take
        return self._run("table_take (baseline)", lambda out, st: fn(
            tab.data_ptr(), tab.shape[0], q.data_ptr(), q.numel(), out, st),
            tab, q)


def gather_bound(kernel, tab, q):
    """(bound ms, what binds it, bytes ms, operations ms, bytes ms at 64
    bytes a row read): bytes are the indices read, the rows written and one
    32-byte sector per 32 bytes of each distinct row read, over 3.35 TB/s;
    operations (onehot_gather only) the one-hot product exactly in int8, 2 x
    Q x R x 32, over the int8 tensor-core peak.  The last counts each
    distinct row of 32 bytes read as 64, the device memory's access
    granularity for a random row (printed beside the bound, not the
    bound)."""
    import torch
    nb, w = tab.shape
    nq = q.numel()
    distinct = torch.unique(q.clamp(0, nb - 1)).numel()
    t_bytes = (4 * nq + 4 * w * nq + 4 * w * distinct) / HBM_BYTES_S
    t_64 = (4 * nq + 4 * w * nq + max(4 * w, 64) * distinct) / HBM_BYTES_S
    t_ops = (2 * nq * nb * 32 / INT8_TC_OPS_S
             if kernel == "onehot_gather" else 0.0)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", t_bytes * 1e3,
            t_ops * 1e3, t_64 * 1e3)


def gather_compare(name, kernel, run_k, run_p, run_l, tab, q, expected,
                   shape, replaces, before=None, variants=None, base=None):
    """Kernel == plain == ``expected`` exactly and the library call the same
    function, then median ms of the three in turns and their device ms
    (with ``before`` ahead of each call, outside both), the kernel's host ms
    per launch and the bound, beside the launch floor.  ``variants`` (label
    -> (call, its output as int32 words)) are other library calls of the
    same function, checked and timed in the same turns; ``base``, the
    baseline kernel on the same inputs, checked and timed in turns too."""
    import torch
    from hsa_tpu_torch.kernels import gather
    k_out, p_out = run_k(), run_p()
    torch.cuda.synchronize()            # a fault in the kernel shows here
    err = int((k_out.long() - p_out.long()).abs().max()) if k_out.numel() \
        else 0
    if err or not torch.equal(k_out, p_out):
        fail(f"{kernel} {name} differs from its plain version (max |err| "
             f"{err})")
    if not np.array_equal(k_out.cpu().numpy().view(np.uint32), expected):
        fail(f"{kernel} {name} differs from the probe's own check tab[q]")
    lib = run_l()
    if kernel == "onehot_gather":
        lib = gather.float_to_words(lib)
    if not torch.equal(lib, p_out):
        fail(f"the library yardstick of {kernel} {name} computes another "
             "function")
    variants = dict(variants or {})
    if base is not None:
        variants["baseline kernel"] = (base, lambda x: x)
    for label, (fn, words) in variants.items():
        if not torch.equal(words(fn()), p_out):
            fail(f"{label} ({kernel} {name}) computes another function")
    fns = [run_k, run_p, run_l] + [fn for fn, _ in variants.values()]
    times = time_turns(fns, before=before)
    ms, plain_ms, library_ms = times[:3]
    dev = device_ms_turns(fns, before=before)
    bound_ms, bound_by, bytes_ms, ops_ms, b64_ms = gather_bound(kernel, tab,
                                                                q)
    h_ms = host_ms(run_k)
    floor = launch_floor_ms()
    extra = {}
    if kernel == "table_take":
        plan = gather.table_take_plan(tab, q)
        extra = dict(plan=plan.__dict__, staging_bytes=plan.groups
                     * plan.slices * plan.rows * 32,
                     index_rescan_bytes=(plan.slices - 1) * 4 * q.numel())
    print(f"{kernel} {name} ({shape}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms; device time "
          f"{dev[0]:.4f} / {dev[1]:.4f} / {dev[2]:.4f} ms (launch floor "
          f"{floor:.4f}); host time per launch {h_ms:.4f} ms; bound "
          f"{bound_ms:.4g} ms ({bound_by}; bytes {bytes_ms:.4g} ms, at 64 "
          f"bytes a row read {b64_ms:.4g} ms"
          + (f", int8 tensor cores {ops_ms:.4g} ms" if ops_ms else "")
          + f"; {ms / bound_ms:.1f}x, device {dev[0] / bound_ms:.1f}x)"
          + (f"; plan {extra['plan']}, beyond the bound: staging "
             f"{extra['staging_bytes']} bytes, indices scanned again "
             f"{extra['index_rescan_bytes']} bytes" if extra else "")
          + f"; max |err| {err}")
    for i, label in enumerate(variants, 3):
        print(f"  {label}: {times[i]:.4f} ms, device time {dev[i]:.4f} ms")
    return dict(case=name, replaces=replaces, shape=shape, rows=tab.shape[0],
                queries=q.numel(), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, device_ms=dev[0],
                plain_device_ms=dev[1], library_device_ms=dev[2],
                launch_floor_ms=floor, host_ms=h_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_bytes_ms=bytes_ms,
                bound_ops_ms=ops_ms, bytes_64_ms=b64_ms, max_abs_err=err,
                **extra,
                library_variants={
                    label: dict(ms=times[i], device_ms=dev[i])
                    for i, label in enumerate(variants, 3)})


def probe_case(case, capacity, dev="cuda", baseline=None):
    """One launch of a TPU probe's kernel at the probe's own inputs, on the
    card: refused before launch when it is table_take's and the table is
    above the chip's ``capacity`` (rows), else compared and timed (beside
    the ``baseline`` kernel, if given)."""
    import torch
    from hsa_tpu_torch.kernels import gather
    tab_np, q_np, tab, q = case.tensors(dev)
    nb, w = tab.shape
    shape = f"tab [{nb}, {w}] q [{len(q_np)}]" + (
        f" pipe={case.pipe} chunk={case.chunk or gather.CHUNK}"
        if case.kernel == "gather_rows" else "")
    if case.kernel == "table_take" and nb > capacity:
        n0 = gather.TABLE_TAKE.launches
        try:
            case.run(tab, q)
        except ValueError as e:
            print(f"table_take {case.label} ({shape}): refused before launch: "
                  f"{e}")
        else:
            fail(f"table_take ran {case.label}, above the chip's {capacity} "
                 "rows")
        torch.cuda.synchronize()
        if gather.TABLE_TAKE.launches != n0:
            fail("table_take counted a launch for a refused table")
        return dict(case=case.label, replaces=case.replaces, shape=shape,
                    refused=True)
    base = None
    if case.kernel == "onehot_gather":
        oh = (torch.arange(nb, device=dev)[None, :] == q[:, None]).float()
        tabf = gather.words_to_float(tab)
        run_l = lambda: torch.matmul(oh, tabf)                 # noqa: E731
    else:
        run_l = lambda: torch.index_select(tab, 0, q)          # noqa: E731
    if baseline and case.kernel == "gather_rows":
        base = lambda: baseline.gather_rows(                   # noqa: E731
            tab, q, case.pipe, case.chunk or Baseline.CHUNK)
    elif baseline and case.kernel == "table_take":
        base = lambda: baseline.table_take(tab, q)             # noqa: E731
    return gather_compare(case.label, case.kernel, lambda: case.run(tab, q),
                          lambda: case.run(tab, q, plain=True), run_l, tab, q,
                          case.expected(tab_np, q_np), shape, case.replaces,
                          base=base)


def probe_phase(dev="cuda", baseline=None, sweep=False):
    """The three gather kernels at every TPU probe launch they replace: the
    probe modules driven as a user runs them (the launch counts), then each
    launch held exactly against plain and the probe's own check and timed;
    table_take's refusals above the chip's capacity asserted; table_take's
    larger case (and with ``sweep``, its plan swept)."""
    import torch
    from hsa_tpu_torch.kernels import gather
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matrix products are on: onehot_gather's plain version "
             "needs full float32")
    launches = drive_probes(dev)
    capacity = gather.table_take_capacity(dev)
    print(f"table_take: this card stages at most {capacity} rows "
          f"({capacity * 32 / 2 ** 20:.3f} MiB) in one cluster")
    rows = defaultdict(list)
    for mod, _ in probe_modules():
        for cases in mod.KERNEL_CASES.values():
            for case in cases:
                rows[case.kernel].append(probe_case(case, capacity, dev,
                                                    baseline))
    ran = [r for r in rows["table_take"] if not r.get("refused")]
    refused = [r["case"] for r in rows["table_take"] if r.get("refused")]
    if not ran or sorted(refused) != sorted(REFUSED_TABLES):
        fail(f"table_take ran {len(ran)} of the probes' tables and refused "
             f"{refused}, not {REFUSED_TABLES}")
    print(f"table_take: the largest probe table that ran: "
          f"{max(ran, key=lambda r: r['rows'])['case']}; refused: "
          f"{', '.join(refused)}")
    t0 = time.perf_counter()
    rows["table_take (larger case)"] = take_large_phase(dev, baseline, sweep)
    print(f"table_take's larger case took "
          f"{time.perf_counter() - t0:.3f} s")
    return launches, rows


def extend_block_ids(idx, ends):
    """int64 block ids of a real ``extend``: ``cat([k, l + 1]) >> 5``, what
    ``search/fm.py:extend`` hands ``_gather_rows``, at step EXTEND_STEP + 1
    of a backward search of each end (``exact_search`` over its last
    EXTEND_STEP bases first)."""
    import torch
    from hsa_tpu_torch.search import exact
    reads_rev, lens = exact.pack_reads(ends, EXTEND_STEP)
    k, l, alive = exact.exact_search(idx, reads_rev, lens)
    print(f"extend at step {EXTEND_STEP + 1} over {len(ends)} ends: "
          f"{int(alive.sum())} live, {int((l - k).eq(0).sum())} intervals of "
          "one row")
    return torch.cat([k, l + 1]) >> 5


def wide_to_words(x):
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return (x - ((x >> 31) << 32)).int()


def main_table_phase(prefix, seed, ends, dev="cuda", baseline=None,
                     sweep=False):
    """gather_rows against the library at the main path's own table, phase
    3's forward occ rows: MAIN_TABLE_QUERIES uniform random rows, the block
    ids of a real ``extend`` over ``ends`` (a paired pigeon batch's 65,536
    lanes), and LARGE_QUERIES uniform rows.  The library yardstick is
    ``index_select`` with int64 ids, the call inside ``fm._gather_rows``;
    int32 ids, ``fm._gather_rows`` whole and ``tab[b]`` beside it (and the
    ``baseline`` kernel, if given, and its device ms at every pipe depth).
    Each warm (the table is about as large as the L2 cache, so part of it
    is there) and with the L2 flushed by a 128 MB write ahead of every
    call; with ``sweep``, each also at every SWEEP_CHUNKS tile (device
    ms)."""
    import torch
    from hsa_tpu_torch.kernels import gather
    from hsa_tpu_torch.search import fm
    from hsa_tpu_torch.tools.occ_probe5 import load_index
    idx = load_index(prefix, dev)
    tab = idx.occ_blocks
    tab_np = tab.cpu().numpy().view(np.uint32)
    nb = tab.shape[0]
    rs = np.random.RandomState(seed + 11)
    uniform = torch.from_numpy(rs.randint(0, nb, MAIN_TABLE_QUERIES).astype(
        np.int64)).to(dev)
    real = extend_block_ids(idx, ends)
    if real.numel() != MAIN_TABLE_QUERIES:
        fail(f"the extend gathers {real.numel()} rows, not "
             f"{MAIN_TABLE_QUERIES}")
    large = torch.from_numpy(rs.randint(0, nb, LARGE_QUERIES).astype(
        np.int64)).to(dev)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    out = {}
    for ids, b in (("uniform", uniform), ("extend", real),
                   ("uniform 2^20", large)):
        t0 = time.perf_counter()
        b32 = b.int()
        expected = tab_np[b32.cpu().numpy()]
        shape = (f"tab [{nb}, 8] ({tab.numel() * 4 / 1e6:.1f} MB) q "
                 f"[{b.numel()}] {ids} chunk={gather.CHUNK}")
        variants = {"index_select, int32 ids": (
            lambda: torch.index_select(tab, 0, b32), lambda x: x),
            "fm._gather_rows, int64 ids": (
            lambda: fm._gather_rows(tab, b), wide_to_words),
            "tab[b], int64 ids": (lambda: tab[b], lambda x: x)}
        base = None
        if baseline:
            base = lambda: baseline.gather_rows(                # noqa: E731
                tab, b32, 8, Baseline.CHUNK)
        for mode, before in (("warm", None),
                             ("L2 flushed", lambda: flush.fill_(7))):
            key = f"{ids}, {mode}"
            out[key] = gather_compare(
                f"at the main path's table, {key}", "gather_rows",
                lambda: gather.gather_rows(tab, b32),
                lambda: gather.rows_plain(tab, b32),
                lambda: torch.index_select(tab, 0, b), tab, b32, expected,
                shape, "main path table", before=before, variants=variants,
                base=base)
            if sweep:
                by_chunk = {chunk: device_ms(
                    lambda: gather.gather_rows(tab, b32, chunk=chunk),
                    before=before) for chunk in SWEEP_CHUNKS}
                print(f"gather_rows at the main path's table, {key}, device "
                      "ms by chunk: " + ", ".join(
                          f"chunk={c} {ms:.4f}" for c, ms in by_chunk.items()))
                out[key]["device_ms_by_chunk"] = by_chunk
            if baseline:
                by_pipe = {pipe: device_ms(
                    lambda: baseline.gather_rows(tab, b32, pipe,
                                                 Baseline.CHUNK),
                    before=before) for pipe in gather.PIPES}
                print(f"  baseline kernel, {key}, device ms by pipe: "
                      + ", ".join(f"pipe={p} {ms:.4f}"
                                  for p, ms in by_pipe.items()))
                out[key]["baseline_device_ms_by_pipe"] = by_pipe
        print(f"gather_rows at the main path's table, {ids} ids, both modes: "
              f"{time.perf_counter() - t0:.3f} s")
    return out


def take_large_phase(dev="cuda", baseline=None, sweep=False):
    """table_take on the probes' 1 MB table at LARGE_QUERIES queries, held
    and timed as a probe launch is; with ``sweep``, then its plan swept
    (device ms, every launch held exactly against plain): SWEEP_SLICES x
    SWEEP_GROUPS at 16,384, 131,072 and LARGE_QUERIES queries and at one
    query (the staging alone), and one group of each slice count over an
    8-row table at one query (the launch alone)."""
    import torch
    from hsa_tpu_torch.index.layout import words_to_device
    from hsa_tpu_torch.kernels import gather
    from hsa_tpu_torch.tools._cases import random_table
    nb = 32_768
    tab_np = random_table(nb, 8)
    tab = words_to_device(tab_np, dev)
    q_np = np.random.RandomState(12).randint(0, nb, LARGE_QUERIES).astype(
        np.int32)
    q = torch.from_numpy(q_np).to(dev)
    base = None
    if baseline:
        base = lambda: baseline.table_take(tab, q)             # noqa: E731
    large = gather_compare(
        "1 MB table, 2^20 queries", "table_take",
        lambda: gather.table_take(tab, q), lambda: gather.rows_plain(tab, q),
        lambda: torch.index_select(tab, 0, q), tab, q, tab_np[q_np],
        f"tab [{nb}, 8] q [{LARGE_QUERIES}]", "larger case", base=base)

    if not sweep:
        return large
    swept = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(tab, q[:n], cs, c) for n in (16_384, MAIN_TABLE_QUERIES,
                                           LARGE_QUERIES, 1)
             for cs in SWEEP_SLICES for c in SWEEP_GROUPS]
    cases += [(tab[:8], q[:1] % 8, cs, 1) for cs in (1,) + SWEEP_SLICES]
    for t, qq, cs, c in cases:
        n_g = sms // cs if c == "most" else c
        if any(r["rows"] == t.shape[0] and r["queries"] == qq.numel() and
               r["slices"] == cs and r["groups"] == n_g for r in swept):
            continue
        rows = -(-t.shape[0] // cs)
        plan = gather.TakePlan(cs, rows, n_g, rows * 32)
        if not torch.equal(gather.take_launch(t, qq, plan),
                           gather.rows_plain(t, qq)):
            fail(f"table_take by plan {plan} differs from its plain version")
        ms = device_ms(lambda: gather.take_launch(t, qq, plan))
        swept.append(dict(rows=t.shape[0], queries=qq.numel(), slices=cs,
                          groups=n_g, device_ms=ms, staging_bytes=n_g * cs
                          * plan.rows * 32))
        print(f"table_take sweep: tab [{t.shape[0]}, 8] q [{qq.numel()}] "
              f"{n_g} groups of {cs} slices: device {ms:.4f} ms, staging "
              f"{n_g * cs * plan.rows * 32} bytes")
    large["plan_sweep"] = swept
    return large


def gather_rows_json(launches, rows, main_table=None, main_launches=None):
    """The kernel-table rows of the three gather kernels: their launches
    those of the probe modules, beside ``main_launches`` (each kernel's
    count on the main paths, as measured; None, printed null, when no main
    path ran)."""
    out = []
    for name in ("gather_rows", "table_take", "onehot_gather"):
        ran = [r for r in rows[name] if not r.get("refused")]
        if name == "gather_rows" and main_table:
            top, per = main_table["extend, L2 flushed"], (
                "one extend's gather of the main path's occ rows, L2 flushed")
        else:
            top = max(ran, key=lambda r: (r["queries"], r["rows"]))
            per = "the probe launch with the most queries (then rows)"
        row = {"name": name, "route": "cuda",
               "source": f"hsa_tpu_torch/csrc/{name}.cu",
               "replaces": ", ".join(dict.fromkeys(r["replaces"]
                                                   for r in rows[name])),
               "launches": launches[name],
               "launches_by_path": {
                   "main paths": (None if main_launches is None
                                  else main_launches[name]),
                   "probe modules": launches[name]},
               "max_abs_err": max(r["max_abs_err"] for r in ran)}
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "host_ms", "device_ms", "plain_device_ms",
                  "library_device_ms"):
            row[k] = top[k]
        row["ms_per"] = per
        row["shape"] = top["shape"]
        row["launch_floor_ms"] = top["launch_floor_ms"]
        if name == "gather_rows" and main_table:
            row["main_table"] = main_table
        if name == "table_take":
            row["larger_case"] = rows["table_take (larger case)"]
        row["shapes"] = rows[name]
        out.append(row)
    return out


# -- 3. main path ----------------------------------------------------------------
def make_genome(n, seed):
    return np.random.RandomState(seed).randint(0, 4, n).astype(np.int8)


def revcomp(codes):
    return (3 - codes[::-1]).astype(np.int8)


def write_fasta(path, genome):
    s = ACGT[genome].tobytes()
    with open(path, "wb") as fh:
        fh.write(b">chrS\n")
        fh.write(b"\n".join(s[i:i + 80] for i in range(0, len(s), 80)))
        fh.write(b"\n")


def make_reads(genome, n_reads, seed):
    """Reads of READ_LEN bp: odd reads reverse-strand, 2 mismatches each,
    every fourth with a 1-bp deletion (the read classes of
    benchmarks/common.py:sample_reads).  Returns (codes, origins)."""
    rs = np.random.RandomState(seed + 1)
    reads, origin = [], np.empty(n_reads, np.int64)
    for j in range(n_reads):
        dele = j % 4 == 0
        p = rs.randint(0, len(genome) - READ_LEN - 2)
        r = genome[p:p + READ_LEN + dele].copy()
        if dele:
            cut = rs.randint(8, READ_LEN - 8)
            r = np.concatenate([r[:cut], r[cut + 1:]])
        q = rs.choice(READ_LEN, size=2, replace=False)
        r[q] = (r[q] + rs.randint(1, 4, size=2)) % 4
        reads.append(revcomp(r) if j % 2 else r)
        origin[j] = p
    return reads, origin


def write_fastq(path, reads, prefix="r"):
    with open(path, "w") as fh:
        for j, r in enumerate(reads):
            fh.write(f"@{prefix}{j}\n{ACGT[r].tobytes().decode()}\n+\n"
                     f"{'I' * len(r)}\n")


def ensure_index(genome, seed, workdir):
    """``hsa_tpu_torch.cli index`` on the genome's FASTA, cached by size and
    seed.  Returns (prefix, seconds or None when cached)."""
    from hsa_tpu_torch import cli
    prefix = os.path.join(workdir, f"genome_{len(genome)}_s{seed}")
    if os.path.exists(os.path.join(prefix + ".hsa", "text.pac")):
        return prefix, None
    fa = prefix + ".fa"
    write_fasta(fa, genome)
    t0 = time.perf_counter()
    if cli.main(["index", fa, "-p", prefix]) != 0:
        fail("index build failed")
    secs = time.perf_counter() - t0
    os.remove(fa)
    return prefix, secs


def read_sam(path):
    with open(path) as fh:
        return fh.read().split("\n")[:-1]


def sam_body(lines):
    return [l for l in lines if not l.startswith("@")]


def run_align(prefix, fq, out_dir, device, tag, engine="beam", extra=()):
    """``hsa_tpu_torch.cli align --engine <engine>`` at the CLI defaults
    (plus ``extra`` arguments).  Returns (SAM lines, header included;
    metrics dict)."""
    from hsa_tpu_torch import cli
    sam = os.path.join(out_dir, f"{tag}.sam")
    met = os.path.join(out_dir, f"{tag}_metrics.json")
    if cli.main(["align", prefix, fq, "--engine", engine, "--device", device,
                 "-f", sam, "--metrics", met, *extra]) != 0:
        fail(f"align --engine {engine} --device {device} failed")
    with open(met) as fh:
        return read_sam(sam), json.load(fh)


def align_window(met):
    """Seconds from the start of ``align`` to its end, index load excluded."""
    return met["wall_s"] - met["t_index_load_s"]


def check_placement(records, origin):
    """(mapped fraction, fraction of mapped reads within 2 bp of origin)."""
    if len(records) != len(origin):
        fail(f"{len(records)} SAM records for {len(origin)} reads")
    mapped = placed = 0
    for j, line in enumerate(records):
        f = line.split("\t", 4)
        if f[0] != f"r{j}":
            fail(f"SAM record {j} is {f[0]}")
        if int(f[1]) & 4:
            continue
        mapped += 1
        placed += abs(int(f[3]) - 1 - origin[j]) <= 2
    return mapped / len(records), placed / max(mapped, 1)


def cross_check(prefix, reads, lines, workdir):
    """The first CROSS_CHECK reads through ``align --device cpu``, the plain
    path: its SAM must equal the card's header and first records, byte for
    byte."""
    fq = os.path.join(workdir, "reads_cross_check.fq")
    write_fastq(fq, reads[:CROSS_CHECK])
    cpu, _ = run_align(prefix, fq, workdir, "cpu", "cross_check")
    n_hdr = sum(l.startswith("@") for l in lines)
    card = lines[:n_hdr + CROSS_CHECK]
    if cpu != card:
        bad = next(j for j in range(max(len(cpu), len(card)))
                   if cpu[j:j + 1] != card[j:j + 1])
        fail(f"the CPU plain path's SAM differs from the card's at line "
             f"{bad}:\n  card: {card[bad:bad + 1]}\n  cpu:  {cpu[bad:bad + 1]}")
    return CROSS_CHECK


# -- 5. glocal screen against plain and native ------------------------------------
def make_glocal_case(R, L, G, rs):
    """Rescue-like screen jobs: the read classes of tests/test_kernels_sw.py
    (exact, 2 mismatches, a 1-bp deletion, random, a shorter read in a
    shorter window) at reads of L and windows of G bases."""
    reads = np.zeros((R, L), np.int32)
    lens = np.full(R, L, np.int32)
    wins = rs.randint(0, 4, (R, G)).astype(np.int32)
    wlens = np.full(R, G, np.int32)
    for j in range(R):
        kind = j % 5
        s = rs.randint(0, G - L - 1)
        if kind == 0:
            reads[j] = wins[j, s:s + L]
        elif kind == 1:
            reads[j] = wins[j, s:s + L]
            q = rs.choice(L, 2, replace=False)
            reads[j, q] = (reads[j, q] + 1) % 4
        elif kind == 2:
            w = wins[j, s:s + L + 1]
            cut = rs.randint(5, L - 5)
            reads[j] = np.concatenate([w[:cut], w[cut + 1:]])
        elif kind == 3:
            reads[j] = rs.randint(0, 4, L)
        else:
            lens[j], wlens[j] = L - 7, G - 13
            s = rs.randint(0, G - 13 - (L - 7))
            reads[j, :L - 7] = wins[j, s:s + L - 7]
    return reads, lens, wins, wlens


def make_glocal_edge(R, L, G, lengths, rs):
    """An edge case of the screen: the rescue-like classes, with every read
    of N only, or with lengths drawn from 0..L and 0..G (every fifth read
    and every fifth window empty, many windows shorter than their reads)."""
    reads, lens, wins, wlens = make_glocal_case(R, L, G, rs)
    if lengths == "all N":
        reads[:] = 4
    elif lengths == "mixed":
        lens = rs.randint(0, L + 1, R).astype(np.int32)
        wlens = rs.randint(0, G + 1, R).astype(np.int32)
        wlens[::7] = rs.randint(0, L, len(wlens[::7]))
        lens[::5], wlens[1::5] = 0, 0
    return reads, lens, wins, wlens


def sass_summary(kernel, mangled_part):
    """Opcode counts of one compiled kernel (``cuobjdump -sass``), the ten
    most frequent: what the compiler emitted for the unrolled row loop."""
    import shutil
    from collections import Counter
    from hsa_tpu_torch.kernels.build import find_nvcc
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(find_nvcc()), "cuobjdump")
    r = subprocess.run([tool, "-sass", kernel.lib()._name],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump failed: {r.stderr.strip()}")
    for part in r.stdout.split("Function : ")[1:]:
        if mangled_part not in part.split("\n", 1)[0]:
            continue
        ops = Counter()
        for line in part.splitlines():
            f = line.split()
            if len(f) > 2 and f[0].startswith("/*") and f[0].endswith("*/") \
                    and len(f[0]) == 8:
                op = f[2] if f[1].startswith("@") else f[1]
                ops[op.rstrip(";").split(".")[0]] += 1
        print(f"SASS of {part.split()[0]}: {sum(ops.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common(10)))
        return
    fail(f"no function named *{mangled_part}* in {kernel.lib()._name}")


GLOCAL_CALLS = 10       # kernel launches per timed sample


def glocal_compare(arrs, name, int32_ops_s, rounds=15, native=False):
    """Kernel == plain exactly (cost and end) on these jobs, then median ms of
    kernel and plain in turns (the kernel as GLOCAL_CALLS launches one after
    another per sample, so that the card need not wait for the host between
    them; ``host_ms`` is the host's time to issue one launch, below which
    ``ms`` cannot read), beside the bound: the jobs' own DP cells (read
    length x window length each) at GLOCAL_FUSED_PER_CELL instructions on the
    integer pipe, against the bytes of the reads, windows, lengths and
    results; and beside the same cells at GLOCAL_OPS_PER_CELL unfused
    operations.  With ``native``, also the host ms of the native DP, whose
    costs must agree."""
    import torch
    from hsa_tpu_torch import refpack
    from hsa_tpu_torch.kernels import sw
    reads, lens, wins, wlens = arrs
    (R, L), G = reads.shape, wins.shape[1]
    args = (*(torch.from_numpy(a).cuda() for a in arrs), *SCORES)
    run_k = lambda: sw.glocal_screen(*args)             # noqa: E731
    run_p = lambda: sw.glocal_screen_plain(*args)       # noqa: E731
    (ck, ek), (cp, ep) = run_k(), run_p()
    torch.cuda.synchronize()            # a fault in the kernel shows here
    err = int(torch.stack([(ck.long() - cp.long()).abs().max(),
                           (ek.long() - ep.long()).abs().max()]).max())
    if err:
        bad = int(((ck != cp) | (ek != ep)).nonzero()[0])
        fail(f"glocal_screen {name} R={R} L={L} G={G} differs from the plain "
             f"version (max |err| {err}; job {bad}: kernel "
             f"({int(ck[bad])}, {int(ek[bad])}), plain ({int(cp[bad])}, "
             f"{int(ep[bad])}), lens {lens[bad]}, wlens {wlens[bad]})")
    ms, plain_ms = time_turns(
        [lambda: [run_k() for _ in range(GLOCAL_CALLS)], run_p], rounds=rounds)
    ms /= GLOCAL_CALLS
    h_ms = host_ms(run_k, rounds)
    native_ms = None
    if native:
        job = (reads.astype(np.uint8), np.arange(R, dtype=np.int64) * L, lens,
               wins.astype(np.int8).reshape(-1),
               np.arange(R, dtype=np.int64) * G, wlens, *SCORES)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ncost = refpack.glocal_batch(*job)[0]
            times.append(time.perf_counter() - t0)
        if not np.array_equal(ncost, ck.cpu().numpy()):
            fail("glocal_screen's costs differ from the native glocal_batch's")
        native_ms = statistics.median(times) * 1e3
    cells = int((lens.astype(np.int64) * wlens).sum())
    t_bytes = (sum(a.nbytes for a in arrs) + 8 * R) / HBM_BYTES_S
    t_fused, t_ops11 = (cells * n / int32_ops_s
                        for n in (GLOCAL_FUSED_PER_CELL, GLOCAL_OPS_PER_CELL))
    bound_ms, ops11_ms = max(t_fused, t_bytes) * 1e3, max(t_ops11, t_bytes) * 1e3
    bound_by = "operations" if t_fused >= t_bytes else "bytes"
    print(f"glocal_screen {name} R={R} L={L} G={G}: kernel {ms:.4f} ms (the "
          f"wrapper's host time per launch {h_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, "
          + (f"native glocal_batch (host, with traceback) {native_ms:.4f} ms, "
             f"costs equal the native's, " if native else "")
          + f"bound {bound_ms:.4f} ms ({bound_by}: {cells} cells x "
          f"{GLOCAL_FUSED_PER_CELL} instructions on the integer pipe; "
          f"{ms / bound_ms:.2f}x); the {GLOCAL_OPS_PER_CELL} unfused "
          f"operations a cell, no bound, {ops11_ms:.4f} ms "
          f"({ms / ops11_ms:.2f}x); max |err| {err}")
    return dict(case=name, shape=f"R={R} L={L} G={G}", ms=ms, host_ms=h_ms,
                plain_ms=plain_ms, native_ms=native_ms, bound_ms=bound_ms,
                bound_ops11_ms=ops11_ms, bound_by=bound_by, cells=cells,
                max_abs_err=err)


def glocal_phase(seed, int32_ops_s):
    """The smoke shape (with the native DP beside it), then every edge."""
    rs = np.random.RandomState(seed + 2)
    R, L, G = GLOCAL["R"], GLOCAL["L"], GLOCAL["G"]
    shapes = [glocal_compare(make_glocal_case(R, L, G, rs), "smoke",
                             int32_ops_s, native=True)]
    for name, R, L, G, lengths in GLOCAL_EDGES:
        shapes.append(glocal_compare(make_glocal_edge(R, L, G, lengths, rs),
                                     name, int32_ops_s, rounds=5))
    return shapes


def glocal_main_path_phase(seed, launched, int32_ops_s,
                           path="align-pe --engine beam"):
    """The screen at the shape of the largest launch that ``path`` made:
    rescue-like jobs at that (R, L, G), checked and timed like the smoke
    shape."""
    for R, L, G in launched:
        print(f"glocal_screen launch on {path}: R={R} L={L} G={G}")
    R, L, G = max(launched)
    return glocal_compare(
        make_glocal_case(R, L, G, np.random.RandomState(seed + 4)),
        f"main path ({path})", int32_ops_s, native=True)


# -- 6. paired-end main path --------------------------------------------------------
def make_pairs(genome, n_pairs, seed):
    """Pairs of PE_LEN bp from fragments of about N(PE_ISIZE, PE_ISIZE_SD)
    bp with 2 substitutions each, end 2 reverse-complemented
    (benchmarks/config4_paired.py); every HEAVY_EVERY-th pair's end 2 has
    HEAVY_SUBS more substitutions.  Returns (ends 1, ends 2, origins
    [n, 2] of both ends' leftmost bases)."""
    rs = np.random.RandomState(seed + 3)
    r1s, r2s = [], []
    origin = np.empty((n_pairs, 2), np.int64)
    for j in range(n_pairs):
        isize = int(np.clip(round(rs.normal(PE_ISIZE, PE_ISIZE_SD)),
                            PE_LEN + 1, 2 * PE_ISIZE))
        p = rs.randint(0, len(genome) - isize)
        frag = genome[p:p + isize].copy()
        q = rs.randint(0, isize, size=2)
        frag[q] = (frag[q] + rs.randint(1, 4, size=2)) % 4
        r2 = frag[-PE_LEN:].copy()
        if j % HEAVY_EVERY == HEAVY_EVERY - 1:
            q = rs.choice(PE_LEN, HEAVY_SUBS, replace=False)
            r2[q] = (r2[q] + rs.randint(1, 4, size=HEAVY_SUBS)) % 4
        r1s.append(frag[:PE_LEN])
        r2s.append(revcomp(r2))
        origin[j] = (p, p + isize - PE_LEN)
    return r1s, r2s, origin


def write_pairs(workdir, tag, r1s, r2s):
    fq1 = os.path.join(workdir, f"{tag}_1.fq")
    fq2 = os.path.join(workdir, f"{tag}_2.fq")
    write_fastq(fq1, r1s, "q")
    write_fastq(fq2, r2s, "q")
    return fq1, fq2


def run_align_pe(prefix, fq1, fq2, out_dir, device, tag, engine="beam"):
    """``hsa_tpu_torch.cli align-pe --engine <engine>`` at the CLI defaults;
    with ``engine=None`` no ``--engine`` is given (the CLI's own default).
    Returns (SAM lines, header included; metrics dict)."""
    from hsa_tpu_torch import cli
    sam = os.path.join(out_dir, f"{tag}.sam")
    met = os.path.join(out_dir, f"{tag}_metrics.json")
    route = ["--engine", engine] if engine else []
    if cli.main(["align-pe", prefix, fq1, fq2, *route, "--device", device,
                 "-f", sam, "--metrics", met]) != 0:
        fail(f"align-pe {' '.join(route)} --device {device} failed")
    with open(met) as fh:
        return read_sam(sam), json.load(fh)


def check_pairs(records, origin, is_heavy=None):
    """(fraction of mapped ends and of mapped ends within 2 bp of their
    origin, among the pairs without the heavy mate; fraction of heavy
    mates placed by rescue within 2 bp of their origin).  ``is_heavy``:
    which pairs carry the heavy mate (every HEAVY_EVERY-th when None)."""
    n = len(origin)
    if is_heavy is None:
        is_heavy = np.arange(n) % HEAVY_EVERY == HEAVY_EVERY - 1
    if len(records) != 2 * n:
        fail(f"{len(records)} SAM records for {n} pairs")
    ends = mapped = placed = heavy = rescued = 0
    for j in range(n):
        for e, first in ((0, 0x40), (1, 0x80)):
            f = records[2 * j + e].split("\t")
            flag = int(f[1])
            if f[0] != f"q{j}" or not flag & first:
                fail(f"SAM record {2 * j + e} is {f[0]} flag {flag}")
            near = not flag & 4 and abs(int(f[3]) - 1 - origin[j, e]) <= 2
            if is_heavy[j]:
                if e == 1:
                    heavy += 1
                    rescued += near and "XT:Z:M" in f[11:]
                continue
            ends += 1
            mapped += not flag & 4
            placed += near
    return mapped / ends, placed / max(mapped, 1), rescued / heavy


def pe_cross_check(prefix, r1s, r2s, workdir, engine="beam"):
    """The first PE_CROSS_CHECK pairs through ``align-pe --engine <engine>``
    on the card and on the CPU (the plain path): the SAMs must be
    byte-equal, and hold a rescued mate.  Returns the card's lines."""
    tag = f"pairs_cross_check_{engine}"
    fq1, fq2 = write_pairs(workdir, tag, r1s[:PE_CROSS_CHECK],
                           r2s[:PE_CROSS_CHECK])
    card, _ = run_align_pe(prefix, fq1, fq2, workdir, "cuda", f"{tag}_cuda",
                           engine)
    cpu, _ = run_align_pe(prefix, fq1, fq2, workdir, "cpu", f"{tag}_cpu",
                          engine)
    if cpu != card:
        bad = next(j for j in range(max(len(cpu), len(card)))
                   if cpu[j:j + 1] != card[j:j + 1])
        fail(f"align-pe --engine {engine} on the CPU differs from the card "
             f"at line {bad}:\n  card: {card[bad:bad + 1]}\n  cpu:  "
             f"{cpu[bad:bad + 1]}")
    if not any("\tXT:Z:M" in line for line in card):
        fail("the cross-check's SAM holds no rescued mate")
    return card


# -- 7a-7c. paired ends on the pigeon route; the beam ladder -------------------------
def make_long_pairs(genome, n, seed):
    """``n`` pairs of PE_LONG_LEN bp ends from fragments as in
    :func:`make_pairs`, 2 substitutions each: both ends too long for the
    pigeon engine.  Returns (ends 1, ends 2, origins [n, 2])."""
    rs = np.random.RandomState(seed + 7)
    L = PE_LONG_LEN
    r1s, r2s = [], []
    origin = np.empty((n, 2), np.int64)
    for j in range(n):
        isize = int(np.clip(round(rs.normal(PE_ISIZE, PE_ISIZE_SD)), L + 1,
                            2 * PE_ISIZE))
        p = rs.randint(0, len(genome) - isize)
        frag = genome[p:p + isize].copy()
        q = rs.randint(0, isize, size=2)
        frag[q] = (frag[q] + rs.randint(1, 4, size=2)) % 4
        r1s.append(frag[:L])
        r2s.append(revcomp(frag[-L:]))
        origin[j] = (p, p + isize - L)
    return r1s, r2s, origin


def interleave_long_pairs(r1s, r2s, origin, l1s, l2s, long_origin):
    """A long pair after every PE_LONG_EVERY pairs.  Returns (ends 1, ends
    2, origins, heavy mask, src) with src[j] the index into ``r1s`` or -1
    for a long pair."""
    o1, o2, org, heavy, src = [], [], [], [], []
    for j in range(len(r1s)):
        o1.append(r1s[j])
        o2.append(r2s[j])
        org.append(origin[j])
        heavy.append(j % HEAVY_EVERY == HEAVY_EVERY - 1)
        src.append(j)
        if j % PE_LONG_EVERY == PE_LONG_EVERY - 1:
            i = j // PE_LONG_EVERY
            o1.append(l1s[i])
            o2.append(l2s[i])
            org.append(long_origin[i])
            heavy.append(False)
            src.append(-1)
    return (o1, o2, np.asarray(org, np.int64), np.asarray(heavy, bool),
            np.asarray(src, np.int64))


def _pair_explained(fp, fbm, lossy, origin):
    """Why a covered pair's pigeon records (``fp``: the field lists of both
    ends) may differ from the beam's (``fbm``), or None.  ``lossy``: the
    beam dropped frontier states or hits for one of the pair's reads."""
    if all(len(x) == len(y) and all(u.startswith(TIE_TAGS)
                                    for u, v in zip(x, y) if u != v)
           for x, y in zip(fp, fbm)):
        return "tie"
    if not lossy:
        return None
    why = "beam under-counted"
    for p, b, org in zip(fp, fbm, origin):
        p_un, b_un = int(p[1]) & 4, int(b[1]) & 4
        if p_un:
            if not b_un:
                return None          # an end the beam has and the pigeon lost
            continue
        if abs(int(p[3]) - 1 - org) > 2:
            return None
        if b_un or ("XT:Z:M" in b[11:] and "XT:Z:M" not in p[11:]):
            why = "beam lost an end"
        elif (p[2], p[3], p[5]) != (b[2], b[3], b[5]):
            if _sam_score(p) > _sam_score(b):
                return None
            if why != "beam lost an end":
                why = "beam missed a better hit"
    return why


def pe_engine_compare(al_p, prefix, r1s, r2s, origin, beam_lines=None):
    """The pigeon route's records against the beam's, pair by pair, on one
    batch of phase 6's pairs, both through ``Aligner.align_pe``'s halves on
    the card with phase 6's names, qualities and ordinals.

    Rule (phase 9's, per pair): a pair is covered when the pigeon engine
    neither fell back on nor truncated either end and the beam reported both
    occurrence lists untruncated.  A covered pair's four SAM lines must be
    byte-equal, but for the engines' documented differences
    (docs/PARITY.md), which are counted: deviation 13 (the XM/XO/XG tags on
    an exact score tie at one position); and, only where the beam dropped
    frontier states or hits for one of the pair's reads, pigeon records that
    are no worse: every end they place lies within 2 bp of where it was
    taken from and no end the beam placed is lost, while the beam lost an
    end (unmapped, or placed by the mate rescue where the pigeon search
    found it), placed one elsewhere at no better a score, or reports the
    same placements and CIGARs with other counts, MAPQ or flags.  Anything
    else fails.  With ``beam_lines`` (phase 6's records) the beam's records
    here must equal them."""
    from collections import Counter
    from hsa_tpu_torch.pipeline import Aligner
    from hsa_tpu_torch.search import pigeon as pg
    n = len(r1s)
    names = [f"q{j}" for j in range(n)]
    quals = ["I" * PE_LEN] * n
    h = al_p._align_pe_device(r1s, r2s)
    if h[0] != "pigeon" or len(h[4]) != 2 * n:
        fail("phase 6's ends did not all route to the pigeon engine")
    _, fb, missed = pg.pigeon_occ_arrays(h[5], 2 * n, al_p.opt, h[6])
    sam_p = al_p._align_pe_finish(h, r1s, r2s, names, quals, quals,
                                  emit="sam")[0]
    al_b = Aligner(prefix, engine="beam", device="cuda")
    hb = al_b._align_pe_device(r1s, r2s)
    occ, trunc, c2x, _, _ = al_b._align_pe_occ(hb, list(r1s) + list(r2s))
    ld, hd = (np.asarray(x, np.int64) for x in al_b.last_overflow)
    sam_b = al_b._resolve_pe(r1s, r2s, names, quals, quals, occ, trunc, c2x,
                             emit="sam")[0]
    if beam_lines is not None and sam_b != beam_lines[:2 * n]:
        fail("the beam's pair records through Aligner differ from phase 6's "
             "SAM")
    N = 2 * n                                  # reads; lanes: both strands
    lossy = (ld[:N] + ld[N:] + hd[:N] + hd[N:]) > 0
    ok = ~fb & (missed == 0) & ~np.asarray(trunc, bool)
    covered, lossy = ok[:n] & ok[n:], lossy[:n] | lossy[n:]
    equal = np.fromiter((sam_p[2 * j:2 * j + 2] == sam_b[2 * j:2 * j + 2]
                         for j in range(n)), bool, n)
    kinds, shown, other = Counter(), Counter(), []
    for j in np.nonzero(covered & ~equal)[0]:
        fp = [x.split("\t") for x in sam_p[2 * j:2 * j + 2]]
        fbm = [x.split("\t") for x in sam_b[2 * j:2 * j + 2]]
        why = _pair_explained(fp, fbm, bool(lossy[j]), origin[j])
        if why is None:
            other.append(j)
            continue
        kinds[why] += 1
        if shown[why] < 1:
            shown[why] += 1
            print(f"  listed ({why}):\n    pigeon: {sam_p[2 * j]}\n            "
                  f"{sam_p[2 * j + 1]}\n    beam:   {sam_b[2 * j]}\n"
                  f"            {sam_b[2 * j + 1]}")
    print(f"engine comparison on {n} pairs: {int(covered.sum())} covered "
          f"(pigeon fell back on {int(fb.sum())} ends, truncated "
          f"{int((missed > 0).sum())}; the beam truncated "
          f"{int(np.sum(trunc))}), of them {int((covered & equal).sum())} "
          f"byte-equal; the beam dropped states or hits on a read of "
          f"{int(lossy.sum())} pairs, so {int((covered & ~lossy).sum())} "
          f"covered pairs are held to byte-equality or a tie alone; listed "
          f"differences {json.dumps(dict(kinds))} (docs/PARITY.md: deviation "
          f"13; DFS -> beam); {len(other)} differ otherwise")
    if other:
        j = other[0]
        fail(f"{len(other)} covered pairs differ between the engines in a way "
             f"no documented difference explains, first q{j} (beam dropped "
             f"states or hits: {bool(lossy[j])}, origin {origin[j]}):\n  "
             f"pigeon: {sam_p[2 * j:2 * j + 2]}\n  beam:   "
             f"{sam_b[2 * j:2 * j + 2]}")
    if covered.sum() < 0.9 * n:
        fail(f"the comparison covered only {int(covered.sum())} of {n} pairs")


def ladder_phase(prefix, reads, origin, opt, workdir):
    """``align --engine beam --ladder`` on one batch of phase 3's reads on
    the card, then a prefix of it on the card and on the CPU (byte-equal).
    Returns the select kernel's launches of the batch run."""
    from hsa_tpu_torch.kernels import select
    extra = ("--ladder", LADDER)
    fq = os.path.join(workdir, "reads_ladder.fq")
    write_fastq(fq, reads[:BATCH])
    before = select.KERNEL.launches
    lines, met = run_align(prefix, fq, workdir, "cuda", "smoke_ladder",
                           extra=extra)
    launches = select.KERNEL.launches - before
    w = align_window(met)
    mapped, placed = check_placement(
        [l for l in lines if not l.startswith("@")], origin[:BATCH])
    rungs = len(LADDER.split(","))
    n_steps = READ_LEN + opt["max_gapo"] + opt["max_gape"]
    want = 2 * n_steps * rungs
    print(f"align --engine beam --ladder {LADDER}: {BATCH} reads in an align "
          f"window of {w:.3f} s ({BATCH / w:.1f} reads/s); mapped fraction "
          f"{mapped:.6f}, placed within 2 bp {placed:.6f} (min {PLACED_MIN}); "
          f"overflow reads {met.get('beam_overflow_reads', 0)} (a rung takes "
          f"an eighth of the batch: reads flagged beyond it keep the "
          f"narrower rung's hits); select_topk launches {launches} (expected "
          f"2 x {n_steps} steps x {rungs} rungs = {want})")
    if placed < PLACED_MIN:
        fail(f"ladder: placed fraction {placed} < {PLACED_MIN}")
    if launches != want:
        fail(f"ladder: select_topk launched {launches} times, expected {want}")
    fq = os.path.join(workdir, "reads_ladder_cross_check.fq")
    write_fastq(fq, reads[:CROSS_CHECK])
    t0 = time.perf_counter()
    card, _ = run_align(prefix, fq, workdir, "cuda", "ladder_cross_cuda",
                        extra=extra)
    cpu, _ = run_align(prefix, fq, workdir, "cpu", "ladder_cross_cpu",
                       extra=extra)
    if cpu != card:
        bad = next(j for j in range(max(len(cpu), len(card)))
                   if cpu[j:j + 1] != card[j:j + 1])
        fail(f"align --ladder {LADDER} on the CPU differs from the card at "
             f"line {bad}:\n  card: {card[bad:bad + 1]}\n  cpu:  "
             f"{cpu[bad:bad + 1]}")
    print(f"cross-check: align --engine beam --ladder {LADDER} on the first "
          f"{CROSS_CHECK} reads gives byte-equal SAMs on cuda and cpu "
          f"({time.perf_counter() - t0:.3f} s)")
    return launches


# -- 7d. the two-phase flow: aln, samse, sampe ---------------------------------------
def run_aln(prefix, fq, out_dir, device, tag, extra=()):
    """``hsa_tpu_torch.cli aln`` at the CLI defaults (plus ``extra``).
    Returns (.sai path, metrics dict)."""
    from hsa_tpu_torch import cli
    sai = os.path.join(out_dir, f"{tag}.sai.npz")
    met = os.path.join(out_dir, f"{tag}_metrics.json")
    if cli.main(["aln", prefix, fq, "--device", device, "-f", sai,
                 "--metrics", met, *extra]) != 0:
        fail(f"aln --device {device} on {fq} failed")
    with open(met) as fh:
        return sai, json.load(fh)


def run_resolve(prefix, sais, fqs, out_dir, device, tag):
    """``samse`` (one ``.sai``) or ``sampe`` (two) at the CLI defaults.
    Returns (SAM lines, header included; metrics dict)."""
    from hsa_tpu_torch import cli
    cmd = "samse" if len(sais) == 1 else "sampe"
    sam = os.path.join(out_dir, f"{tag}.sam")
    met = os.path.join(out_dir, f"{tag}_metrics.json")
    if cli.main([cmd, prefix, *sais, *fqs, "--device", device, "-f", sam,
                 "--metrics", met]) != 0:
        fail(f"{cmd} --device {device} failed")
    with open(met) as fh:
        return read_sam(sam), json.load(fh)


class FallbackClock:
    """Records each call of ``Aligner._beam_rerun`` (``aln``'s inline beam
    fallback, per batch) while it is entered: (reads, longest read,
    seconds).  The call ends in a host readback of its hits, so its host
    time is the card's time too."""

    def __enter__(self):
        from hsa_tpu_torch.pipeline import Aligner
        self.runs = []
        self._real = real = Aligner._beam_rerun

        def timed(al, bsub, *a, **kw):
            t0 = time.perf_counter()
            out = real(al, bsub, *a, **kw)
            self.runs.append((len(bsub), max(len(r) for r in bsub),
                              time.perf_counter() - t0))
            return out
        Aligner._beam_rerun = timed
        return self

    def __exit__(self, *exc):
        from hsa_tpu_torch.pipeline import Aligner
        Aligner._beam_rerun = self._real


def print_aln(name, met, runs):
    """One ``aln`` run: its window and its search split into the pigeon
    search and the inline beam fallback (``runs``: FallbackClock's)."""
    w = align_window(met)
    fb = sum(t for _, _, t in runs)
    for i, b in enumerate(met["batches"]):
        print(f"  {name} batch {i}: {b['n']} reads, profile {b['profile']}, "
              f"fallback {b['fallback']}, trunc {b['trunc']}, retry "
              f"{b['retry']}")
    print(f"{name}: {met['reads_in']} reads in a window of {w:.3f} s "
          f"({met['reads_in'] / w:.1f} reads/s); search {met['t_search_s']} "
          f"s, of it the inline beam fallback {fb:.3f} s in {len(runs)} runs "
          f"over {[n for n, _, _ in runs]} reads (longest "
          f"{[m for _, m, _ in runs]} bp: "
          f"{' '.join(f'{t:.3f}' for _, _, t in runs)} s) and the pigeon "
          f"route {met['t_search_s'] - fb:.3f} s; beam overflow reads "
          f"{met.get('beam_overflow_reads', 0)}; index load {met['t_index_load_s']} "
          f"s")
    return w


def two_phase_cross_check(prefix, r1s, r2s, workdir):
    """``aln`` x2 + ``sampe`` on the first PE_CROSS_CHECK pairs on the card
    and on the CPU (the plain path): the SAMs must be byte-equal."""
    fq1, fq2 = write_pairs(workdir, "two_phase_cross_check",
                           r1s[:PE_CROSS_CHECK], r2s[:PE_CROSS_CHECK])
    out = {}
    for device in ("cuda", "cpu"):
        sais = [run_aln(prefix, fq, workdir, device,
                        f"two_phase_cross_{device}_{m}")[0]
                for m, fq in ((1, fq1), (2, fq2))]
        out[device], _ = run_resolve(prefix, sais, (fq1, fq2), workdir,
                                     device, f"two_phase_cross_{device}")
    if out["cpu"] != out["cuda"]:
        card, cpu = out["cuda"], out["cpu"]
        bad = next(j for j in range(max(len(cpu), len(card)))
                   if cpu[j:j + 1] != card[j:j + 1])
        fail(f"aln x2 + sampe on the CPU differs from the card at line "
             f"{bad}:\n  card: {card[bad:bad + 1]}\n  cpu:  {cpu[bad:bad + 1]}")
    if not any("\tXT:Z:M" in line for line in out["cuda"]):
        fail("the two-phase cross-check's SAM holds no rescued mate")


def aln_resume_check(prefix, fq, sai, workdir, tag):
    """``aln --resume`` over a finished run: no index load, no search (no
    select_topk launch) and the ``.sai`` arrays unchanged."""
    from hsa_tpu_torch.kernels import select
    with np.load(sai) as z:
        before = {k: z[k] for k in z.files}
    launches = select.KERNEL.launches
    t0 = time.perf_counter()
    again, met = run_aln(prefix, fq, workdir, "cuda", tag, ("--resume",))
    if again != sai:
        fail("aln --resume wrote another file")
    with np.load(sai) as z:
        after = {k: z[k] for k in z.files}
    same = sorted(after) == sorted(before) and all(
        after[k].dtype == before[k].dtype and np.array_equal(after[k],
                                                             before[k])
        for k in before)
    n = select.KERNEL.launches - launches
    print(f"aln --resume over the finished run: {time.perf_counter() - t0:.3f} "
          f"s, {n} select_topk launches, .sai arrays "
          f"{'unchanged' if same else 'CHANGED'}, reads_in {met['reads_in']}")
    if n or not same or "t_search_s" in met or "t_index_load_s" in met:
        fail("aln --resume over a finished run loaded the index, searched "
             "again or changed the .sai")


# -- 8-10. the pigeon engine: align --engine auto -------------------------------------
def make_long_reads(genome, n, seed):
    """``n`` reads of PIGEON_LONG_LEN bp with 2 mismatches, odd ones
    reverse-strand: too long for the pigeon engine, so the router hands
    them to the beam.  Returns (codes, origins)."""
    rs = np.random.RandomState(seed + 5)
    L = PIGEON_LONG_LEN
    reads, origin = [], np.empty(n, np.int64)
    for j in range(n):
        p = rs.randint(0, len(genome) - L)
        r = genome[p:p + L].copy()
        q = rs.choice(L, size=2, replace=False)
        r[q] = (r[q] + rs.randint(1, 4, size=2)) % 4
        reads.append(revcomp(r) if j % 2 else r)
        origin[j] = p
    return reads, origin


def interleave_long(reads, origin, longs, long_origin):
    """A long read after every PIGEON_LONG_EVERY reads.  Returns (reads,
    origins, src) with src[j] the index into ``reads`` or -1 for a long
    read."""
    out, org, src = [], [], []
    for j, r in enumerate(reads):
        out.append(r)
        org.append(origin[j])
        src.append(j)
        if j % PIGEON_LONG_EVERY == PIGEON_LONG_EVERY - 1:
            i = j // PIGEON_LONG_EVERY
            out.append(longs[i])
            org.append(long_origin[i])
            src.append(-1)
    return out, np.asarray(org, np.int64), np.asarray(src, np.int64)


def kmer_table_phase(prefix):
    """The K-mer seed table of the index, built on the card and written
    beside the index (first use), then loaded from that file (every later
    run).  Returns the aligner that loaded it."""
    import torch
    from hsa_tpu_torch.pipeline import Aligner
    cache = os.path.join(prefix + ".hsa", "kmer12.npz")
    if os.path.exists(cache):
        os.remove(cache)
    out = None
    for want in ("built", "loaded"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        al = Aligner(prefix, engine="auto", device="cuda")
        if al._kmer_k != 12:
            fail(f"K-mer seeding depth {al._kmer_k} on {al.di.n} bp, not 12")
        tk, tl = al._kmer_tables()
        secs, how = al.kmer_table_s
        if how != want or not os.path.exists(cache):
            fail(f"K-mer table was {how}, expected {want} ({cache})")
        print(f"K-mer table (K=12, 2 x {tk.numel()} entries) {how} in "
              f"{secs:.3f} s; file {os.path.getsize(cache) / 1e6:.1f} MB; "
              f"{int((tk <= tl).sum())} 12-mers occur; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.6f} GB")
        out = al
    return out


def pigeon_batch_phase(al, mixed, n_long):
    """One batch (phase 8's first: 100 bp reads with the long ones between)
    through ``Aligner.align``: the engine's per-batch fractions."""
    import torch
    from hsa_tpu_torch.kernels import select
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = select.KERNEL.launches
    t0 = time.perf_counter()
    recs = al.align(mixed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fr = dict(fallback=al.last_fallback_frac,
              ineligible=al.last_ineligible_frac, trunc=al.last_trunc_frac,
              retry=al.last_retry_frac)
    print(f"one batch of {len(mixed)} reads through Aligner.align "
          f"(engine auto): {secs:.3f} s, fractions {json.dumps(fr)}, "
          f"profile {al._pigeon_profile}, select_topk launches "
          f"{select.KERNEL.launches - before} (the beam re-run of the "
          f"ineligible reads), mapped {sum(not r.flag & 4 for r in recs)}, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.6f} GB")
    if abs(fr["ineligible"] - n_long / len(mixed)) > 1e-12:
        fail(f"ineligible fraction {fr['ineligible']}, expected "
             f"{n_long}/{len(mixed)}")
    return fr


def pigeon_cross_check(prefix, reads, workdir):
    """The first PIGEON_CROSS_CHECK reads of the pigeon path (long reads
    among them) through ``align --engine auto`` on the card and on the CPU:
    byte-equal SAMs."""
    fq = os.path.join(workdir, "pigeon_cross_check.fq")
    write_fastq(fq, reads[:PIGEON_CROSS_CHECK])
    card, _ = run_align(prefix, fq, workdir, "cuda", "pigeon_cross_cuda",
                        "auto")
    cpu, _ = run_align(prefix, fq, workdir, "cpu", "pigeon_cross_cpu", "auto")
    if cpu != card:
        bad = next(j for j in range(max(len(cpu), len(card)))
                   if cpu[j:j + 1] != card[j:j + 1])
        fail(f"align --engine auto on the CPU differs from the card at line "
             f"{bad}:\n  card: {card[bad:bad + 1]}\n  cpu:  "
             f"{cpu[bad:bad + 1]}")
    return card


# tags that may differ between the engines on an exact score tie at one
# position (docs/PARITY.md, deviation 13: the pigeon engine keeps the minimum
# (score, gap opens, gap extensions, mismatches) composition)
TIE_TAGS = ("XM:i:", "XO:i:", "XG:i:")
# fields that count suboptimal or equal-best hits: what a beam that dropped
# frontier states under-counts (docs/PARITY.md, "DFS -> beam": the beam is
# exact only when no beam or hit-buffer overflow occurs)
COUNT_TAGS = ("XT:A:", "X0:i:", "X1:i:", "XA:Z:")


def _sam_score(fields):
    """Edit score of a mapped SAM record from its XM/XO/XG tags."""
    tag = {f[:5]: int(f[5:]) for f in fields[11:] if f.startswith(TIE_TAGS)}
    return sum(w * tag.get(t, 0) for w, t in zip(SCORES, TIE_TAGS))


def _explained(fp, fbm, lossy, origin):
    """Why a covered read's pigeon record (fields ``fp``) may differ from
    the beam's (``fbm``), or None.  ``lossy``: the beam dropped frontier
    states or hits for this read.  ``origin``: where the read was taken
    from; a pigeon record at another placement than the beam's, or where the
    beam has none, counts only when it lies within 2 bp of it."""
    if len(fp) == len(fbm) and all(
            x.startswith(TIE_TAGS) for x, y in zip(fp, fbm) if x != y):
        return "tie"
    if not lossy or int(fp[1]) & 4:
        return None
    at_origin = abs(int(fp[3]) - 1 - origin) <= 2
    if int(fbm[1]) & 4:
        return "beam lost the read" if at_origin else None
    if (fp[1], fp[2], fp[3], fp[5]) == (fbm[1], fbm[2], fbm[3], fbm[5]):
        rest_p = [x for x in fp[11:] if not x.startswith(COUNT_TAGS)]
        rest_b = [x for x in fbm[11:] if not x.startswith(COUNT_TAGS)]
        return "beam under-counted" if rest_p == rest_b else None
    return "beam missed a better hit" \
        if at_origin and _sam_score(fp) <= _sam_score(fbm) else None


def engine_compare(al_p, prefix, reads, beam_lines, origin):
    """The pigeon engine's records against the beam's on one batch of
    phase 3's reads, both through ``Aligner`` on the card with phase 3's
    names, qualities and read ordinals.

    Rule: a read is covered when the pigeon engine neither fell back nor
    truncated it (``fallback`` false, ``n_missed`` 0) and the beam reported
    its occurrence list untruncated.  A covered read's two SAM records must
    be byte-equal, but for the engines' documented differences
    (docs/PARITY.md), which are listed: deviation 13 (the XM/XO/XG tags on
    an exact score tie at one position); and, only where the beam dropped
    frontier states or hits for that read ("DFS -> beam": its search at
    W=64 is then not exhaustive, while the pigeon screen is), a pigeon record
    that is no worse: the read mapped, within 2 bp of where it was taken
    from (``origin``), where the beam lost it; the same placement and CIGAR
    with other MAPQ, XT, X0, X1 or XA; or another placement, within 2 bp of
    the read's origin, of a score no higher than the beam's.  Anything else
    fails.  The count of covered reads for which the beam dropped nothing,
    and which are therefore held to the strict rule alone, is printed.  The
    beam's records must be phase 3's own lines."""
    from collections import Counter
    from hsa_tpu_torch.pipeline import Aligner
    from hsa_tpu_torch.search import pigeon as pg
    n = len(reads)
    names = [f"r{j}" for j in range(n)]
    quals = ["I" * len(r) for r in reads]
    h = al_p._align_device(reads)
    if h[0] != "pigeon" or len(h[2]) != n:
        fail("phase 3's reads did not all route to the pigeon engine")
    _, fb, missed = pg.pigeon_occ_arrays(h[4], n, al_p.opt, h[5])
    sam_p = al_p._align_finish(h, names, quals, emit="sam")[0]
    al_b = Aligner(prefix, engine="beam", device="cuda")
    hb = al_b._align_device(reads)
    occ, trunc, c2x = al_b._align_occ(hb)
    ld, hd = (np.asarray(x, np.int64) for x in al_b.last_overflow)
    sam_b = al_b._resolve_occ(hb[1], names, quals, occ, trunc, c2x,
                              emit="sam")[0]
    if sam_b != beam_lines[:n]:
        fail("the beam's records through Aligner differ from phase 3's SAM")
    lossy = (ld[:n] + ld[n:] + hd[:n] + hd[n:]) > 0    # both strands' lanes
    covered = ~fb & (missed == 0) & ~np.asarray(trunc, bool)
    equal = np.fromiter((a == b for a, b in zip(sam_p, sam_b)), bool, n)
    kinds, shown, other = Counter(), Counter(), []
    for j in np.nonzero(covered & ~equal)[0]:
        why = _explained(sam_p[j].split("\t"), sam_b[j].split("\t"),
                         bool(lossy[j]), int(origin[j]))
        if why is None:
            other.append(j)
            continue
        kinds[why] += 1
        if shown[why] < 2:
            shown[why] += 1
            print(f"  listed ({why}): {sam_p[j]}\n      the beam's: {sam_b[j]}")
    print(f"engine comparison on {n} reads: {int(covered.sum())} covered "
          f"(pigeon fell back on {int(fb.sum())}, truncated "
          f"{int((missed > 0).sum())}; the beam truncated "
          f"{int(np.sum(trunc))}), of them {int((covered & equal).sum())} "
          f"byte-equal; the beam dropped states or hits on "
          f"{int(lossy.sum())} reads, so {int((covered & ~lossy).sum())} "
          f"covered reads are held to byte-equality or a tie alone, and a "
          f"record that differs otherwise must lie within 2 bp of its read's "
          f"origin; listed differences "
          f"{json.dumps(dict(kinds))} (docs/PARITY.md: deviation 13; DFS -> "
          f"beam); {len(other)} differ otherwise")
    if other:
        j = other[0]
        fail(f"{len(other)} covered reads differ between the engines in a way "
             f"no documented difference explains, first r{j} (beam dropped "
             f"states or hits: {bool(lossy[j])}):\n  pigeon: {sam_p[j]}\n  "
             f"beam:   {sam_b[j]}")
    if covered.sum() < 0.9 * n:
        fail(f"the comparison covered only {int(covered.sum())} of {n} reads")


def make_repeat_case(seed):
    """The repeat path's genome and reads (tests/test_pigeon_repeats.py's
    families in one text): i.i.d. background; an exact family of
    REPEAT['copies'] copies in the first quarter and a diverged one (about
    REPEAT['div'] differences a base) in the second.  Read classes by
    ``j % 8``: 0 inside an exact copy (capped enumeration: truncated), 1
    from a diverged copy with 2 mismatches (pass 1 misses it: seg_phase
    retry), 2 straddling a copy's start, 3 ten bases of flank with both
    mismatches there (over-extension), 4..7 background reads with 2
    mismatches, every other with a 1-bp deletion; after every
    ``long_every``-th read a 200 bp read for the beam.  Odd reads
    reverse-strand.  Returns (genome, reads, clean mask)."""
    c = REPEAT
    rs = np.random.RandomState(seed + 6)
    n, U, L = c["bp"], c["unit"], c["L"]
    g = rs.randint(0, 4, n).astype(np.int8)
    step = (n // 4) // (c["copies"] + 2)
    fams = []
    for f, div in enumerate((0.0, c["div"])):
        unit = rs.randint(0, 4, U).astype(np.int8)
        starts = []
        for i in range(c["copies"]):
            u = unit.copy()
            m = rs.rand(U) < div
            u[m] = (u[m] + rs.randint(1, 4, int(m.sum()))) % 4
            p = f * (n // 4) + (i + 1) * step
            g[p:p + U] = u
            starts.append(p)
        fams.append(starts)
    reads, clean = [], []

    def put(r, is_clean):
        reads.append(revcomp(r) if len(reads) % 2 else r.astype(np.int8))
        clean.append(is_clean)

    def mismatch(r, lo, hi, k=2):
        q = lo + rs.choice(hi - lo, size=k, replace=False)
        r[q] = (r[q] + rs.randint(1, 4, size=k)) % 4
        return r

    for j in range(c["reads"]):
        kind = j % 8
        if kind == 0:
            p = fams[0][rs.randint(c["copies"])] + rs.randint(0, U - L)
            put(g[p:p + L].copy(), False)
        elif kind == 1:
            p = fams[1][rs.randint(c["copies"])] + rs.randint(0, U - L)
            put(mismatch(g[p:p + L].copy(), 0, L), False)
        elif kind == 2:
            p = fams[0][rs.randint(c["copies"])] - 40
            put(g[p:p + L].copy(), False)
        elif kind == 3:
            p = fams[0][rs.randint(c["copies"])] - 10
            put(mismatch(g[p:p + L].copy(), 0, 10), False)
        else:
            dele = kind % 2
            p = rs.randint(n // 2 + 100, n - L - 2)
            r = g[p:p + L + dele].copy()
            if dele:
                cut = rs.randint(8, L - 8)
                r = np.concatenate([r[:cut], r[cut + 1:]])
            put(mismatch(r, 0, L), True)
        if j % c["long_every"] == c["long_every"] - 1:
            p = rs.randint(n // 2 + 100, n - PIGEON_LONG_LEN)
            put(mismatch(g[p:p + PIGEON_LONG_LEN].copy(), 0, PIGEON_LONG_LEN),
                True)
    return g, reads, np.asarray(clean, bool)


def repeat_run(cls, prefix, reads, device):
    """``align_stream`` of ``cls`` (an Aligner at REPEAT's small caps) over
    the repeat reads.  Returns (SAM lines, per-batch (fallback, trunc,
    retry) fractions, select launches)."""
    from hsa_tpu_torch.kernels import select
    al = cls(prefix, engine="auto", device=device)
    for k, v in REPEAT["caps"].items():
        setattr(al, k, v)
    B = REPEAT["batch"]

    def batches():
        for s in range(0, len(reads), B):
            yield s, None, reads[s:s + B], None
    before = select.KERNEL.launches
    lines, flags, stats = [], [], []
    for _, (ln, fl) in al.align_stream(batches(), emit="sam", fb_group=2):
        lines += ln
        flags += fl
        stats.append((al.last_fallback_frac, al.last_trunc_frac,
                      al.last_retry_frac))
    return lines, np.asarray(flags), stats, select.KERNEL.launches - before


def repeat_phase(seed, workdir):
    """The repeat path on the card and on the CPU, with full-segment
    anchors (K = 0, what a genome of this size gets) and with 6-mer seeds
    forced (so that the in-segment extension of wide K-mer anchors runs
    too): truncation, the seg_phase retry and the pooled beam flush (the
    long reads and the reads whose retry failed too) must all have
    happened, and the SAMs must be byte-equal."""
    from hsa_tpu_torch.pipeline import Aligner

    class Seeded(Aligner):
        _kmer_k = 6

    genome, reads, clean = make_repeat_case(seed)
    prefix, _ = ensure_index(genome, seed, workdir)
    total = 0
    for name, cls in (("K=0 full-segment anchors", Aligner),
                      ("K=6 seeds forced", Seeded)):
        t0 = time.perf_counter()
        card, flags, stats, launches = repeat_run(cls, prefix, reads, "cuda")
        t1 = time.perf_counter()
        cpu, _, cpu_stats, _ = repeat_run(cls, prefix, reads, "cpu")
        t2 = time.perf_counter()
        fbk, trunc, retry = (max(x[i] for x in stats) for i in range(3))
        mapped = float((flags[clean] & 4 == 0).mean())
        print(f"repeat path, {name}: {len(reads)} reads in {len(stats)} "
              f"batches on {len(genome)} bp; per batch at most fallback "
              f"{fbk:.6f}, trunc {trunc:.6f}, retry {retry:.6f}; "
              f"select_topk launches {launches} (the pooled beam flushes); "
              f"clean reads mapped {mapped:.6f} (min "
              f"{REPEAT_CLEAN_MAPPED_MIN}), all reads mapped "
              f"{float((flags & 4 == 0).mean()):.6f}; cuda {t1 - t0:.3f} s, "
              f"cpu {t2 - t1:.3f} s")
        if card != cpu or stats != cpu_stats:
            bad = next((j for j in range(len(card)) if card[j] != cpu[j]), -1)
            fail(f"repeat path ({name}): cuda and cpu differ at record {bad}"
                 f":\n  cuda: {card[bad:bad + 1]}\n  cpu:  {cpu[bad:bad + 1]}"
                 f"\n  stats {stats} / {cpu_stats}")
        if not (trunc > 0 and retry > 0 and launches > 0):
            fail(f"repeat path ({name}): truncation, the seg_phase retry and "
                 f"the pooled beam must all occur (trunc {trunc}, retry "
                 f"{retry}, select launches {launches})")
        if mapped < REPEAT_CLEAN_MAPPED_MIN:
            fail(f"repeat path ({name}): clean reads mapped {mapped}")
        total += launches
    return total


# -- 10b. the sharded index: ShardedIndex over meshes of ranks ----------------
def shard_inputs(prefix, reads, seed, workdir):
    """The sharded phase's inputs, written for the ranks, and the port's
    unsharded results on the card to hold them against.

    Pigeon: phase 3's first batch, both strands, at SHARD_PIGEON_OPT with
    phase 7a's 12-mer table; exact, width and beam: its first
    SHARD_BEAM_READS reads at the CLI defaults; locate: the ranks of the
    unsharded pigeon search's verified positions (inverse suffix array);
    the LF walk: the repeat path's genome indexed without the direct SA."""
    import torch
    from hsa_tpu_torch.config import AlnOpt
    from hsa_tpu_torch.index.layout import (DeviceIndex, build_device_index,
                                            to_device, words_to_device)
    from hsa_tpu_torch.search import fm, pigeon as pg
    from hsa_tpu_torch.search.beam import beam_search
    from hsa_tpu_torch.search.exact import as_wide, exact_search, pack_reads
    from hsa_tpu_torch.search.widths import cal_width_device

    idx_dir = prefix + ".hsa"
    di = DeviceIndex.load(os.path.join(idx_dir, "index.npz"))
    with np.load(os.path.join(idx_dir, "kmer12.npz")) as z:
        tk_np, tl_np = z["tk"], z["tl"]
    rows = pg.pack_text_rows(make_genome(GENOME_BP, seed))
    opt = AlnOpt(**SHARD_PIGEON_OPT)
    sub = reads[:BATCH]
    both = sub + [revcomp(r) for r in sub]
    batch = pg.pack_pigeon_batch(both, n_seg=SHARD_N_SEG,
                                 seed_len=opt.seed_len, kmer_k=12,
                                 anchor_tail=pg.auto_anchor_tail(di.n, 12),
                                 device_masks=True)
    md = np.full(len(both), opt.max_diff, np.int32)
    beam_reads = np.stack(reads[:SHARD_BEAM_READS]).astype(np.uint8)
    ex_reads, ex_lens = pack_reads(list(beam_reads), READ_LEN)
    cli_opt = AlnOpt()
    bm_lens = np.full(len(beam_reads), READ_LEN, np.int32)
    bm_md = np.full(len(beam_reads), cli_opt.diff_budget(READ_LEN), np.int32)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = to_device(di, "cuda")
    tk, tl = as_wide(tk_np, "cuda"), as_wide(tl_np, "cuda")
    trows = words_to_device(rows, "cuda")
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    ref, wall = {}, {}

    def warm(name, fn):
        """fn() twice (each ends in a readback): the second call's result,
        its wall seconds under ``name``."""
        fn()
        t1 = time.perf_counter()
        r = fn()
        wall[name] = time.perf_counter() - t1
        return r

    def pigeon():
        buf, shape = pg.pack_pigeon_upload(batch, md)
        (segs_rev, seg_lens, seg_off, kmer, kmer_ok, seg_short, rw, nmask,
         lens, md_t) = pg.unpack_pigeon_upload(words_to_device(buf, "cuda"),
                                               shape)
        B2 = len(both)
        return pg.result_to_host(pg.pigeon_search(
            dev, trows, segs_rev, seg_lens, seg_off, rw, nmask, None, None,
            lens, md_t, opt, n_seg=SHARD_N_SEG,
            cand_cap=SHARD_CAPS["cand_cap"], seg_cap=SHARD_CAPS["seg_cap"],
            pool=SHARD_CAPS["pool_mult"] * B2, gpool=B2,
            kmer_seed=(tk, tl, kmer, kmer_ok, seg_short)))._asdict()

    ref["pigeon"] = warm("pigeon_fn", pigeon)
    v = ref["pigeon"]["valid"]
    pos = ref["pigeon"]["pos"][v].astype(np.int64)
    isa = np.empty(di.sa_direct.shape[0], np.int64)
    isa[di.sa_direct] = np.arange(isa.size)
    ranks = isa[pos]
    del isa
    if ranks.size % 2:
        ranks = np.append(ranks, 0)
    ref["exact"] = warm("exact_fn", lambda: [
        x.cpu().numpy() for x in exact_search(
            dev, as_wide(ex_reads, "cuda"), as_wide(ex_lens, "cuda"))])
    fwd = as_wide(beam_reads, "cuda")
    ref["D"] = warm("width_fn", lambda: cal_width_device(
        dev, fwd, as_wide(bm_lens, "cuda")).cpu().numpy())
    ref["beam"] = warm("beam_fn", lambda: {
        f: x.cpu().numpy() for f, x in beam_search(
            dev, fwd, as_wide(bm_lens, "cuda"), as_wide(ref["D"], "cuda"),
            as_wide(bm_md, "cuda"), cli_opt, beam_width=SHARD_BEAM_W,
            max_hits=SHARD_BEAM_H)._asdict().items()})
    ref["locate"] = warm("locate_fn", lambda: fm.locate(
        dev, as_wide(ranks, "cuda")).cpu().numpy())
    if not np.array_equal(ref["locate"][:pos.size], pos):
        fail("locate of the pigeon positions' ranks does not give them back")
    api_ranks, api_width = fm_api_ranks(di, seed)
    ref["fm_api"] = fm_api(dev, api_ranks, api_width)
    del dev, tk, tl, trows, fwd
    print(f"unsharded on the card (this process; tables on the card in "
          f"{tables_s:.3f} s), the second of two calls: "
          + ", ".join(f"{k} {s:.6f} s" for k, s in wall.items()))

    # the LF walk: the repeat path's genome without the direct SA
    genome = make_repeat_case(seed)[0]
    walk = build_device_index(genome, sa_direct=False)
    walk.save(os.path.join(workdir, "shard_walk.npz"))
    sa = build_device_index(genome, with_reverse=False,
                            sa_direct=True).sa_direct.astype(np.int64)
    w_ranks = np.random.RandomState(seed + 10).randint(
        0, walk.n + 1, SHARD_WALK_RANKS)
    ref["walk"] = fm.locate(to_device(walk, "cuda"),
                            as_wide(w_ranks, "cuda")).cpu().numpy()
    if not np.array_equal(ref["walk"], sa[w_ranks]):
        fail("the LF walk on the card differs from the suffix array")
    np.savez(os.path.join(workdir, "shard_inputs.npz"), rows=rows, md=md,
             ex_reads=ex_reads, ex_lens=ex_lens, bm_fwd=beam_reads,
             bm_lens=bm_lens, bm_md=bm_md, ranks=ranks, w_ranks=w_ranks,
             api_ranks=api_ranks, api_width=api_width,
             tk=tk_np, tl=tl_np, **{f"pb_{k}": v for k, v in batch.items()})
    return ref, opt, len(both) // 2


def shard_rank(workdir, index_npz, backend, n_data, n_shard, rank, world,
               addr):
    """One rank of a sharded world (``chip_smoke.py --shard-rank ...``,
    started by :func:`shard_phase`): every ShardedIndex entry point on the
    whole inputs, twice and timed; the whole results, the merges' count,
    bytes and devices and select_topk's launches on the beam written to
    ``shard_{tag}_{rank}.npz`` / ``.json``."""
    import torch
    import torch.distributed as dist
    from hsa_tpu_torch.config import AlnOpt
    from hsa_tpu_torch.dist import (COLLECTIVES, ShardedIndex, init_multihost,
                                    make_mesh)
    from hsa_tpu_torch.index.layout import DeviceIndex
    from hsa_tpu_torch.kernels import select
    from hsa_tpu_torch.search import pigeon as pg
    from hsa_tpu_torch.search.exact import as_wide

    n_data, n_shard, rank, world = map(int, (n_data, n_shard, rank, world))
    torch.cuda.set_device(0)
    init_multihost(addr, world, rank, backend, timeout=SHARD_PG_TIMEOUT_S)
    mesh = make_mesh(n_data, n_shard)
    z = dict(np.load(os.path.join(workdir, "shard_inputs.npz")))
    batch = {k[3:]: v for k, v in z.items() if k.startswith("pb_")}
    t0 = time.perf_counter()
    si = ShardedIndex(DeviceIndex.load(index_npz), mesh, "cuda")
    tk, tl = as_wide(z["tk"], "cuda"), as_wide(z["tl"], "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out, entries = {}, []

    def timed(label, fn):
        """fn() twice, each call with the world's ranks starting together
        (the first in a fresh process, the second warm); records (label,
        first wall s, warm wall s, all-reduces, bytes a shard) of the
        second call and returns its result."""
        walls = []
        for _ in range(2):
            if world > 1:
                dist.barrier()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        entries.append((label, *walls, *COLLECTIVES.calls[-1][1:]))
        return r

    COLLECTIVES.reset()
    res = timed("pigeon_fn", lambda: pg.result_to_host(si.pigeon_fn(
        AlnOpt(**SHARD_PIGEON_OPT), SHARD_N_SEG, z["rows"], with_kmer=True,
        **SHARD_CAPS)(batch, z["md"], tk, tl)))
    out.update({f"pigeon_{f}": v for f, v in res._asdict().items()})
    out.update({f"exact_{i}": x.cpu().numpy() for i, x in enumerate(timed(
        "exact_fn", lambda: si.exact_fn()(z["ex_reads"], z["ex_lens"])))})
    D = timed("width_fn", lambda: si.width_fn()(z["bm_fwd"], z["bm_lens"]))
    out["D"] = D.cpu().numpy()
    torch.cuda.synchronize()
    select.KERNEL.launches = 0
    select.KERNEL.launch_shapes.clear()
    raw = timed("beam_fn", lambda: si.beam_fn(
        AlnOpt(), beam_width=SHARD_BEAM_W, max_hits=SHARD_BEAM_H)(
            z["bm_fwd"], z["bm_lens"], D, z["bm_md"]))
    launches = select.KERNEL.launches
    shapes = [[*k, n] for k, n in select.KERNEL.launch_shapes.items()]
    out.update({f"beam_{f}": x.cpu().numpy()
                for f, x in raw._asdict().items()})
    out["locate"] = timed("locate_fn", lambda: si.locate_fn()(
        z["ranks"])).cpu().numpy()
    if (n_data, n_shard) == SHARD_WALK_MESH:
        sw = ShardedIndex(DeviceIndex.load(
            os.path.join(workdir, "shard_walk.npz")), mesh, "cuda")
        out["walk"] = timed("locate_fn (LF walk)", lambda: sw.locate_fn()(
            z["w_ranks"])).cpu().numpy()
        # phase 10c's four device functions, counted as an entry point
        def fm_api_call():
            with COLLECTIVES.call(FM_API_LABEL):
                return fm_api(si.idx, z["api_ranks"], z["api_width"])
        out.update({f"fm_api_{k}": v
                    for k, v in timed(FM_API_LABEL, fm_api_call).items()})
    if set(COLLECTIVES.devices) != {"cuda"}:
        raise AssertionError(f"merges ran on {dict(COLLECTIVES.devices)}, not "
                             "on CUDA tensors only")
    tag = f"{backend}_{n_data}x{n_shard}"
    np.savez(os.path.join(workdir, f"shard_{tag}_{rank}.npz"), **out)
    with open(os.path.join(workdir, f"shard_{tag}_{rank}.json"), "w") as fh:
        json.dump(dict(backend=dist.get_backend(), setup_s=setup_s,
                       entries=entries,
                       merges_on=dict(COLLECTIVES.devices),
                       select_launches=launches, select_shapes=shapes), fh)
    dist.destroy_process_group()


def _pool_sets(p):
    """(slot id, pos, nmm) of the verified pool entries, and per lane the
    (start, key) set of its gapped entries (tests/test_dist.py:139-158)."""
    v = p["valid"]
    pool = set(zip(p["cidx"][v].tolist(), p["pos"][v].tolist(),
                   p["nmm"][v].tolist()))
    gaps = {}
    n_lanes = p["fallback"].shape[0]
    for i in np.nonzero(p["g_read"] < n_lanes)[0]:
        for s in np.nonzero(p["g_key"][i] != 0xFFFFFFFF)[0]:
            gaps.setdefault(int(p["g_read"][i]), set()).add(
                (int(p["g_q"][i, s]), int(p["g_key"][i, s])))
    return pool, gaps


def shard_compare(name, ref, got, n_data, opt, n_reads):
    """Every rank's whole result against the unsharded one, bit for bit;
    pigeon at n_data > 1 as the reference's per-slice pools allow."""
    from hsa_tpu_torch.search import pigeon as pg

    def same(what, a, b):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype or \
                not np.array_equal(a, b):
            fail(f"sharded {name}: {what} differs from the unsharded result "
                 f"({a.dtype}{list(a.shape)} against "
                 f"{b.dtype}{list(b.shape)})")

    for i, x in enumerate(ref["exact"]):
        same(f"exact_fn field {'klm'[i]}", x, got[f"exact_{i}"])
    same("width_fn D", ref["D"], got["D"])
    for f, x in ref["beam"].items():
        same(f"beam_fn {f}", x, got[f"beam_{f}"])
    same("locate_fn", ref["locate"], got["locate"])
    if "walk" in got:
        same("locate_fn (LF walk)", ref["walk"], got["walk"])
    if "fm_api_lf" in got:
        for f, x in ref["fm_api"].items():
            same(f"fm.{f}", x, got[f"fm_api_{f}"])
    p = {f: got[f"pigeon_{f}"] for f in ref["pigeon"]}
    if n_data == 1:
        for f, x in ref["pigeon"].items():
            same(f"pigeon_fn {f}", np.reshape(x, -1) if f == "n_gate" else x,
                 p[f])
        return
    for f in ("fallback", "n_cand", "n_missed"):
        same(f"pigeon_fn {f}", ref["pigeon"][f], p[f])
    if _pool_sets(ref["pigeon"]) != _pool_sets(p):
        fail(f"sharded {name}: pigeon_fn's pool or gapped sets differ")
    a = pg.pigeon_occ_arrays(pg.PigeonResult(**ref["pigeon"]), n_reads, opt,
                             SHARD_CAPS["cand_cap"])
    b = pg.pigeon_occ_arrays(pg.PigeonResult(**p), n_reads, opt,
                             SHARD_CAPS["cand_cap"])
    for f in a[0]:
        same(f"pigeon occurrences {f}", a[0][f], b[0][f])
    same("pigeon fallback reads", a[1], b[1])
    same("pigeon missed", a[2], b[2])


def shard_phase(prefix, reads, seed, workdir):
    """Phase 10b: each world of SHARD_WORLDS (ranks started as fresh
    processes, all on this card) runs every entry point; every rank's
    results must equal the unsharded ones.  Returns (select_topk launches
    in the ranks, their launch shapes)."""
    from collections import Counter
    from hsa_tpu_torch.config import AlnOpt
    from hsa_tpu_torch.dist.launch import run_world
    t_phase = time.perf_counter()
    ref, opt, n_reads = shard_inputs(prefix, reads, seed, workdir)
    index_npz = os.path.join(prefix + ".hsa", "index.npz")
    launches, shapes = 0, Counter()
    cli_opt = AlnOpt()
    n_steps = READ_LEN + cli_opt.max_gapo + cli_opt.max_gape
    for backend, nd, ns in SHARD_WORLDS:
        tag = f"{backend}_{nd}x{ns}"
        t0 = time.perf_counter()
        try:
            run_world([sys.executable, os.path.abspath(__file__),
                       "--shard-rank", workdir, index_npz, backend, str(nd),
                       str(ns)], nd * ns, timeout=SHARD_WORLD_TIMEOUT_S,
                      cwd=ROOT)
        except RuntimeError as e:
            fail(f"sharded world {tag}: {e}")
        world_s = time.perf_counter() - t0
        infos = []
        for r in range(nd * ns):
            with open(os.path.join(workdir, f"shard_{tag}_{r}.json")) as fh:
                infos.append(json.load(fh))
            got = dict(np.load(os.path.join(workdir, f"shard_{tag}_{r}.npz")))
            shard_compare(f"{tag} rank {r}", ref, got, nd, opt, n_reads)
            info = infos[-1]
            if info["backend"] != backend:
                fail(f"world {tag} ran on {info['backend']}")
            if info["select_launches"] != 2 * 2 * n_steps:
                fail(f"world {tag} rank {r}: select_topk launched "
                     f"{info['select_launches']} times on two beam_fn "
                     f"calls, expected 2 x 2 x {n_steps}")
            launches += info["select_launches"]
            for C, B, K, win, n in info["select_shapes"]:
                shapes[(C, B, K, bool(win))] += n
        for label, _, _, n, _ in infos[0]["entries"]:
            if label == FM_API_LABEL and n != len(FM_API_FNS):
                fail(f"world {tag}: the four device functions made {n} "
                     f"merges, not one each")
        # the ranks of one shard group made the same merges
        for r, info in enumerate(infos):
            lead = infos[r - r % ns]
            if [e[3:] for e in info["entries"]] != \
                    [e[3:] for e in lead["entries"]]:
                fail(f"world {tag}: rank {r} merged otherwise than rank "
                     f"{r - r % ns}")
        where = ("one rank on the card, merges by NCCL on the card"
                 if backend == "nccl" else
                 f"{nd * ns} ranks time-sharing one card, merges through host "
                 "memory: not a scaling figure for N hosts")
        print(f"world {tag} ({where}): backend {infos[0]['backend']}, merges "
              f"on {infos[0]['merges_on']}; world {world_s:.3f} s, set-up "
              f"{max(i['setup_s'] for i in infos):.3f} s; every rank's whole "
              f"result equals the unsharded one")
        for j, (label, _, _, n, nbytes) in enumerate(infos[0]["entries"]):
            first, again = (max(i["entries"][j][k] for i in infos)
                            for k in (1, 2))
            print(f"  {tag} {label}: wall {again:.6f} s warm, {first:.6f} s "
                  f"first call (slowest rank), {n} all-reduces, {nbytes} "
                  f"bytes a shard (a call of rank 0)")
    print(f"phase 10b took {time.perf_counter() - t_phase:.3f} s")
    return launches, dict(shapes)


# -- 10c. the rest of the device API ---------------------------------------------
FM_API_FNS = ("occ_lt4", "extend4", "bwt_char", "lf")
FM_API_LABEL = "occ_lt4 + extend4 + bwt_char + lf"


def fm_api_ranks(di, seed):
    """API_RANKS prefix lengths / ranks of an index of n bases, in [0, n +
    1]: the primary and its neighbours, both ends of the range, the first,
    last and next slot of API_BLOCKS random 32-rank blocks and of the
    primary's, the rest uniform; and per rank an interval width in [0, 64)
    for extend4."""
    n, prim = int(di.n), int(di.primary)
    rs = np.random.RandomState(seed + 17)
    blocks = np.append(rs.randint(1, (n + 1) // 32, API_BLOCKS), prim >> 5)
    special = np.concatenate([
        np.arange(prim - 40, prim + 41), np.arange(0, 64),
        np.arange(n - 62, n + 2), (32 * blocks[:, None] + [-1, 0, 31, 32])
        .reshape(-1)])
    special = np.clip(special, 0, n + 1)
    ranks = np.concatenate([special,
                            rs.randint(0, n + 2, API_RANKS - special.size)])
    return ranks.astype(np.int64), rs.randint(0, 64, API_RANKS)


def fm_api(idx, ranks, width):
    """The four device functions of ``search/fm.py`` on an index on any
    device (a shard's too): occ_lt4 at the prefix lengths ``ranks``;
    bwt_char and lf at the ranks clamped to n; extend4 of [r, min(r +
    width, n)].  Returns numpy arrays by name."""
    from hsa_tpu_torch.search import fm
    from hsa_tpu_torch.search.exact import as_wide
    p = as_wide(ranks, idx.device)
    r = p.clamp(max=idx.n)
    k4, l4 = fm.extend4(idx, r, (r + as_wide(width, idx.device)).clamp(
        max=idx.n))
    out = {"occ_lt4": fm.occ_lt4(idx, p), "extend4_k": k4, "extend4_l": l4,
           "bwt_char": fm.bwt_char(idx, r), "lf": fm.lf(idx, r)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def read_text(prefix):
    """The genome's codes, read back from the index's ``text.pac``."""
    from hsa_tpu_torch import refpack
    with open(os.path.join(prefix + ".hsa", "text.pac"), "rb") as fh:
        n = int(np.frombuffer(fh.read(8), np.int64)[0])
        packed = np.frombuffer(fh.read(), np.uint8)
    return refpack.unpack_2bit(packed, n).astype(np.int8)


def oracle_fm_index(text, sa_intv=32):
    """The oracle's ``FMIndex`` of ``text`` built by its fields, as
    ``FMIndex.build`` computes them, from the native suffix array
    (``refpack.suffix_array``) in place of the prefix doubling that
    ``FMIndex.build`` uses (``fmcore.py``: "good to ~1e6").  ``cum`` is
    summed a base at a time, without the one-hot matrix of the build: the
    same values in half the memory ((n + 1) x 4 x 8 bytes)."""
    from hsa_tpu_torch import refpack
    from hsa_tpu_torch.fmcore import FMIndex, bwt_from_sa
    t = np.asarray(text, np.int8)
    n = len(t)
    sa = refpack.suffix_array(t)
    bwt, primary = bwt_from_sa(t, sa)
    counts = np.bincount(t, minlength=4).astype(np.int64)
    C = np.concatenate([[1], 1 + np.cumsum(counts)])
    cum = np.zeros((n + 1, 4), np.int64)
    for a in range(4):
        cum[1:, a] = np.cumsum(bwt == a)
    marks = (sa % sa_intv) == 0
    mark_rank = np.concatenate([[0], np.cumsum(marks)[:-1]])
    return FMIndex(n=n, primary=primary, bwt=bwt, C=C, cum=cum,
                   sa_intv=sa_intv, marks=marks, mark_rank=mark_rank,
                   samples=sa[marks], sa=sa)


def fm_api_oracle_check(ref, ranks, width, got):
    """The four functions' results (``fm_api``) against the oracle's
    FMIndex methods at the same ranks: occ and extend vectorised, bwt_char
    and lf a rank at a time.  The primary's symbol, which FMIndex leaves
    undefined, must be the dummy 0."""
    n, prim = ref.n, ref.primary
    r = np.minimum(ranks, n)
    l = np.minimum(r + width, n)
    want = {"occ_lt4": np.stack([ref.occ(a, ranks - 1) for a in range(4)], 1)}
    ext = [ref.extend(a, r, l) for a in range(4)]
    want["extend4_k"] = np.stack([e[0] for e in ext], 1)
    want["extend4_l"] = np.stack([e[1] for e in ext], 1)
    want["bwt_char"] = np.array([ref.bwt_char(int(x)) for x in r])
    want["lf"] = np.array([ref.lf(int(x)) for x in r])
    at = r == prim
    if (got["bwt_char"][at] != 0).any():
        fail("bwt_char at the primary is not the dummy 0")
    want["bwt_char"][at] = 0
    for k, w in want.items():
        if not np.array_equal(w, got[k]):
            bad = np.nonzero((w != got[k]).reshape(len(ranks), -1).any(1))[0]
            fail(f"fm.{k} differs from the oracle's FMIndex at {bad.size} "
                 f"ranks, first {ranks[bad[0]]}: {got[k][bad[0]]} against "
                 f"{w[bad[0]]}")
    return int(at.sum())


def handle_cpu(prefix, reads_npy, out_path):
    """``chip_smoke.py --handle-cpu ...`` (started by phase 10c): the
    library's two-phase API, ``search_batch_device`` then
    ``resolve_handle``, on the CPU (the plain path), beside the card's
    work; writes the SAM records, one a line."""
    import torch
    from hsa_tpu_torch.pipeline import Aligner
    torch.set_num_threads(API_HANDLE_THREADS)
    reads = list(np.load(reads_npy).astype(np.int8))
    al = Aligner(prefix, engine="beam", device="cpu")
    recs = al.resolve_handle(al.search_batch_device(reads), reads,
                             *handle_names(reads))
    with open(out_path, "w") as fh:
        fh.write("".join(r.to_sam() + "\n" for r in recs))


def handle_names(reads):
    """The names and qualities phase 3's FASTQ gives these reads."""
    return ([f"r{j}" for j in range(len(reads))],
            ["I" * len(r) for r in reads])


def device_api_phase(prefix, reads, beam_lines, seed, workdir, int32_ops_s,
                     compared):
    """Phase 10c.  Returns (select_topk launches by route, select step rows
    by route)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hsa_tpu_torch import entry as tentry
    from hsa_tpu_torch.config import AlnOpt
    from hsa_tpu_torch.index.layout import DeviceIndex, to_device
    from hsa_tpu_torch.kernels import select
    from hsa_tpu_torch.pipeline import Aligner, oracle_align
    t_phase = time.perf_counter()
    sel, rows = {}, {}

    def card(fn):
        """fn() with select_topk's count set to 0 just before: (result,
        seconds, launches, launch shapes)."""
        torch.cuda.synchronize()
        select.KERNEL.launches = 0
        select.KERNEL.launch_shapes.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, select.KERNEL.launches,
                dict(select.KERNEL.launch_shapes))

    def path(route, n_sel, shapes, gated=True):
        """Records a route's select_topk launches; holds the kernel against
        plain at its shapes (a gated route must have launched it)."""
        sel[route] = n_sel
        if gated and n_sel == 0:
            fail(f"{route}: select_topk was launched no time")
        if n_sel:
            rows[route] = select_path_phase(route, shapes, compared, seed,
                                            int32_ops_s)

    # the CPU side of the two-phase library API runs beside the rest
    sub = reads[:API_HANDLE_READS]
    reads_npy = os.path.join(workdir, "api_handle_reads.npy")
    np.save(reads_npy, np.stack(sub).astype(np.uint8))
    cpu_sam = os.path.join(workdir, "api_handle_cpu.sam")
    t_cpu = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--handle-cpu", prefix, reads_npy, cpu_sam],
                            cwd=ROOT)
    try:
        # the four FM functions: the card, the CPU, the oracle's FMIndex
        di = DeviceIndex.load(os.path.join(prefix + ".hsa", "index.npz"))
        ranks, width = fm_api_ranks(di, seed)
        idx = to_device(di, "cuda")
        fm_api(idx, ranks, width)
        got, secs, _, _ = card(lambda: fm_api(idx, ranks, width))
        del idx
        plain = fm_api(to_device(di, "cpu"), ranks, width)
        for k, v in plain.items():
            if v.dtype != got[k].dtype or not np.array_equal(v, got[k]):
                fail(f"fm.{k} on the card differs from the CPU's")
        print(f"occ_lt4, extend4, bwt_char, lf at {API_RANKS} ranks of phase "
              f"3's index ({di.n} bp, sa_direct): card = cpu bit for bit; "
              f"the four on the card {secs:.6f} s (warm)")
        text = read_text(prefix)
        t0 = time.perf_counter()
        fm_f = oracle_fm_index(text)
        fm_r = oracle_fm_index(text[::-1].copy())
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_prim = fm_api_oracle_check(fm_f, ranks, width, plain)
        print(f"the oracle's FMIndex of phase 3's genome by its fields "
              f"(native suffix array; forward and reverse) in {build_s:.3f} "
              f"s, cum {fm_f.cum.nbytes} bytes each: the card's four equal "
              f"its occ, extend, bwt_char and lf at every rank ({n_prim} at "
              f"the primary, symbol 0) ({time.perf_counter() - t0:.3f} s)")

        # the oracle at phase 3's size against the card's engines
        oreads = oracle_reads(text, seed + 4, API_ORACLE_READS,
                              API_ORACLE_KINDS, boundary=None)
        names, quals = handle_names(oreads)
        opt = AlnOpt(max_diff=API_ORACLE_MAX_DIFF)
        t0 = time.perf_counter()
        want = [r.to_sam() for r in oracle_align(
            text, _oracle_meta(prefix), oreads, names, quals, opt,
            indexes=(fm_f, fm_r))]
        or_s = time.perf_counter() - t0
        del fm_f, fm_r
        print(f"oracle_align at {len(text)} bp: {len(oreads)} reads "
              f"({API_ORACLE_KINDS} in rotation), AlnOpt(max_diff="
              f"{API_ORACLE_MAX_DIFF}), {or_s:.3f} s ({or_s / len(oreads):.6f}"
              f" s a read)")
        kinds = [API_ORACLE_KINDS[j % len(API_ORACLE_KINDS)]
                 for j in range(len(oreads))]
        for engine, W in [("beam", W) for W in API_ORACLE_W] + [
                ("auto", API_ORACLE_W[0])]:
            route = f"10c oracle: align --engine {engine} -W {W}"
            al = Aligner(prefix, opt, engine=engine, device="cuda")
            recs, secs, n_sel, shapes = card(lambda: al.align(
                oreads, names, quals, beam_width=W))
            line = (f"{route}: {len(oreads)} reads in {secs:.3f} s on the "
                    f"card; select_topk launches {n_sel}")
            if engine == "beam":
                # the frontier states and hits the beam dropped, both
                # strands' lanes summed a read, by read kind
                ld, hd = (np.asarray(x, np.int64).reshape(-1, len(oreads))
                          .sum(0) for x in al.last_overflow)
                by_kind = {k: [int(v[[x == k for x in kinds]].sum())
                               for v in (ld > 0, ld, hd > 0)]
                           for k in API_ORACLE_KINDS}
                line += (f"; the beam dropped {int(ld.sum())} frontier states "
                         f"on {int((ld > 0).sum())} reads and {int(hd.sum())} "
                         f"hits; by kind [reads, states, reads that dropped "
                         f"hits] {json.dumps(by_kind)}")
            print(line)
            oracle_compare(route, [r.to_sam() for r in recs], want,
                           ties_ok=engine == "auto")
            path(route, n_sel, shapes, gated=engine == "beam")
            del al

        # entry(): the forward step, cuda against cpu
        step, args = tentry.entry("cuda")
        got = [x.cpu().numpy() for x in step(*args)]
        cstep, cargs = tentry.entry("cpu")
        for name, g, w in zip(("pos", "nmm", "valid", "fallback"), got,
                              (x.numpy() for x in cstep(*cargs))):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                fail(f"entry(): the step's {name} on cuda differs from cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(*args)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kern:
            fail("entry(): the profiler recorded no device kernel")
        print(f"entry(): step(*example_args) on cuda equals entry(device="
              f"'cpu') bit for bit ({int(got[2].sum())} verified of "
              f"{got[0].shape[0]} pool entries); warm step wall {wall:.6f} "
              f"s, {len(kern)} device kernels and copies under "
              f"torch.profiler, device busy "
              f"{sum(e.time_range.elapsed_us() for e in kern) / 1e6:.6f} s")

        # dryrun_multichip over nccl (1 rank) and gloo (4 on this card)
        dry_launches, dry_shapes = 0, defaultdict(int)
        for n in API_DRYRUNS:
            nd, ns = tentry.mesh_shape(n)
            backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
            t0 = time.perf_counter()
            ranks_out = tentry.dryrun_multichip(n, "cuda")
            world_s = time.perf_counter() - t0
            ref = tentry.dryrun_unsharded(nd, "cuda")
            for r, rec in enumerate(ranks_out):
                if rec["backend"] != backend or rec["mesh"] != [nd, ns]:
                    fail(f"dryrun_multichip({n}) rank {r} ran {rec['mesh']} "
                         f"over {rec['backend']}, not ({nd}, {ns}) over "
                         f"{backend}")
                if (rec["hits"], rec["pigeon_mapped"]) != \
                        (ref["hits"], ref["pigeon_mapped"]):
                    fail(f"dryrun_multichip({n}) rank {r}: hits "
                         f"{rec['hits']}, pigeon_mapped "
                         f"{rec['pigeon_mapped']}; unsharded {ref['hits']}, "
                         f"{ref['pigeon_mapped']}")
                if rec["select_launches"] == 0:
                    fail(f"dryrun_multichip({n}) rank {r}: select_topk was "
                         "launched no time")
                dry_launches += rec["select_launches"]
                for C, B, K, win, k in rec["select_shapes"]:
                    dry_shapes[(C, B, K, bool(win))] += k
            print(f"dryrun_multichip({n}) over {backend}: world {world_s:.3f} "
                  f"s; hits {ref['hits']} and pigeon_mapped "
                  f"{ref['pigeon_mapped']} on every rank, as unsharded; "
                  f"select_topk {sum(r['select_launches'] for r in ranks_out)}"
                  f" launches in the ranks")
        path("dryrun_multichip (1 and 4 ranks)", dry_launches,
             dict(dry_shapes))

        # the two-phase library API: cuda against the CPU process
        al = Aligner(prefix, engine="beam", device="cuda")
        recs, secs, n_sel, shapes = card(lambda: al.resolve_handle(
            al.search_batch_device(sub), sub, *handle_names(sub)))
        path("search_batch_device + resolve_handle", n_sel, shapes)
        del al
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    rc = proc.wait()
    cpu_s = time.perf_counter() - t_cpu
    if rc != 0:
        fail(f"the CPU side of resolve_handle exited {rc}")
    card_sam = [r.to_sam() for r in recs]
    with open(cpu_sam) as fh:
        if fh.read().split("\n")[:-1] != card_sam:
            fail("search_batch_device + resolve_handle: the records on cuda "
                 "differ from cpu")
    print(f"search_batch_device + resolve_handle on phase 3's first "
          f"{len(sub)} reads: cuda = cpu byte for byte ({secs:.3f} s on the "
          f"card; the CPU process {cpu_s:.3f} s, beside the rest)")
    if beam_lines is not None:
        diff = defaultdict(int)
        for g, w in zip(card_sam, sam_body(beam_lines)):
            if g != w:
                diff[first_field(g, w)] += 1
        print(f"  against align --engine beam (the array resolver; not gated):"
              f" {len(card_sam) - sum(diff.values())} of {len(card_sam)} "
              f"records equal, the others by first differing field "
              f"{json.dumps(diff)}")
    print(f"phase 10c took {time.perf_counter() - t_phase:.3f} s")
    return sel, rows


# -- 11. where the time goes (--profile) -----------------------------------------
def profile_phase(prefix, reads, opt_dict, fq, workdir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hsa_tpu_torch.pipeline import Aligner
    al = Aligner(prefix, engine="beam", device="cuda")
    if al.opt.to_dict() != opt_dict:
        fail("Aligner() defaults differ from the CLI defaults")
    seq = 0.0
    for s in range(0, len(reads), BATCH):
        t = [time.perf_counter()]
        h = al._align_device(reads[s:s + BATCH])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        occ, trunc, c2x = al._align_occ(h)
        t.append(time.perf_counter())
        al._resolve_occ(h[1], None, None, occ, trunc, c2x, read_offset=s,
                        emit="sam")
        t.append(time.perf_counter())
        d = np.diff(t)
        seq += t[-1] - t[0]
        print(f"sequential batch at {s}: search {d[0]:.6f} s, readback + "
              f"hits + locate {d[1]:.6f} s, resolve {d[2]:.6f} s, "
              f"sum {t[-1] - t[0]:.6f} s")
    print(f"sequential: {len(reads)} reads in {seq:.6f} s "
          f"({len(reads) / seq:.1f} reads/s)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        al._align_device(reads[:BATCH])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kern:
        fail("the profiler recorded no device kernels")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    host = sum(e.self_cpu_time_total for e in events
               if e.device_type == DeviceType.CPU) / 1e6
    print(f"profiled search of {BATCH} reads: wall {wall:.6f} s, "
          f"{len(kern)} device kernels, host self time in torch ops "
          f"{host:.6f} s, device busy {busy:.6f} s, idle share "
          f"{1 - busy / wall:.6f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.6f} GB")
    per = defaultdict(lambda: [0, 0.0])
    for e in kern:
        per[e.name][0] += 1
        per[e.name][1] += e.time_range.elapsed_us() / 1e3
    ranked = sorted(per.items(), key=lambda x: -x[1][1])
    own = [kv for kv in ranked[8:] if "select_topk_kernel" in kv[0]]
    for name, (n, ms) in ranked[:8] + own:      # the top 8 and the port's own
        print(f"  {ms:10.3f} ms {n:6d} launches  {name[:90]}")
    del al, events, kern, prof

    for rep in range(2):
        _, met = run_align(prefix, fq, workdir, "cuda", f"stream{rep}")
        w = align_window(met)
        print(f"warm align --device cuda, run {rep}: {met['reads_in']} reads "
              f"in an align window of {w:.3f} s ({met['reads_in'] / w:.1f} "
              f"reads/s), sequential sum {seq:.6f} s")


def profile_pe_phase(prefix, r1s, r2s, fq1, fq2, workdir):
    """align-pe's stream phases one after another per batch (search;
    readback + hits + locate; pairing + rescue + SAM, with the rescue
    timed apart), then ``align-pe --device cuda`` twice more, warm."""
    import torch
    from hsa_tpu_torch.pipeline import Aligner
    al = Aligner(prefix, engine="beam", device="cuda")
    rescue_s = []
    rescue = al._rescue

    def timed_rescue(*args):             # the rescue, drained and timed
        t0 = time.perf_counter()
        out = list(rescue(*args))
        torch.cuda.synchronize()
        rescue_s.append(time.perf_counter() - t0)
        return iter(out)
    al._rescue = timed_rescue
    seq = 0.0
    for s in range(0, len(r1s), BATCH):
        r1, r2 = r1s[s:s + BATCH], r2s[s:s + BATCH]
        rescue_s.clear()
        t = [time.perf_counter()]
        h = al._align_pe_device(r1, r2)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        occ, trunc, c2x, _, _ = al._align_pe_occ(h, list(r1) + list(r2))
        t.append(time.perf_counter())
        al._resolve_pe(r1, r2, None, None, None, occ, trunc, c2x,
                       read_offset=s, emit="sam")
        t.append(time.perf_counter())
        d = np.diff(t)
        seq += t[-1] - t[0]
        print(f"sequential pair batch at {s}: search {d[0]:.6f} s, readback "
              f"+ hits + locate {d[1]:.6f} s, pairing + rescue + SAM "
              f"{d[2]:.6f} s (rescue of {al.last_rescue_jobs} jobs "
              f"{sum(rescue_s):.6f} s), sum {t[-1] - t[0]:.6f} s")
    print(f"sequential: {len(r1s)} pairs in {seq:.6f} s "
          f"({len(r1s) / seq:.1f} pairs/s)")
    del al
    for rep in range(2):
        _, met = run_align_pe(prefix, fq1, fq2, workdir, "cuda",
                              f"stream_pe{rep}")
        w = align_window(met)
        print(f"warm align-pe --engine beam --device cuda, run {rep}: "
              f"{len(r1s)} pairs in "
              f"an align window of {w:.3f} s ({len(r1s) / w:.1f} pairs/s), "
              f"sequential sum {seq:.6f} s")


def profile_pe_pigeon_phase(prefix, r1s, r2s, fq1, fq2, workdir):
    """The paired pigeon route on the warm card: each batch's stages one
    after another with the device synchronised between them (pack; upload +
    search of the 2B reads; readback; host finalise; pairing + rescue + SAM,
    with the rescue timed apart and both kernels' launches counted); one
    batch's device search under ``torch.profiler`` (kernel launches, device
    busy, idle share, peak memory); then ``align-pe --device cuda`` at its
    default engine twice more on phase 6's pairs, which are all eligible."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hsa_tpu_torch.kernels import select, sw
    from hsa_tpu_torch.pipeline import Aligner, _pe_reads
    from hsa_tpu_torch.search import pigeon as pg
    al = Aligner(prefix, device="cuda")
    if al.engine != "auto":
        fail(f"Aligner() defaults to engine {al.engine!r}, not 'auto'")
    rescue_s = []
    rescue = al._rescue

    def timed_rescue(*args):             # the rescue, drained and timed
        t0 = time.perf_counter()
        out = list(rescue(*args))
        torch.cuda.synchronize()
        rescue_s.append(time.perf_counter() - t0)
        return iter(out)
    al._rescue = timed_rescue
    al.align_pe(r1s[:BATCH], r2s[:BATCH])         # warm: tables, text rows
    seq = 0.0
    for s in range(0, len(r1s), BATCH):
        r1, r2 = r1s[s:s + BATCH], r2s[s:s + BATCH]
        all_reads = _pe_reads(r1, r2)
        n_seg, elig = al._pigeon_split(all_reads)
        if len(elig) != len(all_reads):
            fail("phase 6's ends are not all eligible for the pigeon engine")
        rescue_s.clear()
        k0 = (select.KERNEL.launches, sw.KERNEL.launches)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        buf, shape = al._pigeon_pack(all_reads, n_seg)
        t.append(time.perf_counter())
        res = al._pigeon_device(buf, shape, n_seg)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        host = pg.fetch_result(res)
        t.append(time.perf_counter())
        h = ("pigeon", len(r1), n_seg, elig, list(elig), host,
             al._pigeon_caps("base")[1])
        occ, trunc, c2x, _, _ = al._align_pe_occ(h, all_reads)
        t.append(time.perf_counter())
        al._resolve_pe(r1, r2, None, None, None, occ, trunc, c2x,
                       read_offset=s, emit="sam")
        t.append(time.perf_counter())
        d = np.diff(t)
        seq += t[-1] - t[0]
        print(f"sequential pigeon pair batch at {s}: pack {d[0]:.6f} s, "
              f"upload + search {d[1]:.6f} s, readback {d[2]:.6f} s, host "
              f"finalise {d[3]:.6f} s, pairing + rescue + SAM {d[4]:.6f} s "
              f"(rescue of {al.last_rescue_jobs} jobs {sum(rescue_s):.6f} s), "
              f"sum {t[-1] - t[0]:.6f} s; launches: select_topk "
              f"{select.KERNEL.launches - k0[0]}, glocal_screen "
              f"{sw.KERNEL.launches - k0[1]}; fractions fallback "
              f"{al.last_fallback_frac}, retry {al.last_retry_frac}, "
              f"ineligible {al.last_ineligible_frac} (shape R, SL, B2, RW = "
              f"{shape}, n_seg {n_seg}, upload {buf.nbytes / 1e6:.3f} MB)")
    print(f"sequential paired pigeon: {len(r1s)} pairs in {seq:.6f} s "
          f"({len(r1s) / seq:.1f} pairs/s)")

    all_reads = _pe_reads(r1s[:BATCH], r2s[:BATCH])
    n_seg, _ = al._pigeon_split(all_reads)
    buf, shape = al._pigeon_pack(all_reads, n_seg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        al._pigeon_device(buf, shape, n_seg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        fail("the profiler recorded no device kernels")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    print(f"profiled paired pigeon search of {BATCH} pairs ({2 * BATCH} "
          f"reads): wall {wall:.6f} s, {len(kern)} device kernels and "
          f"copies, device busy {busy:.6f} s, idle share "
          f"{1 - busy / wall:.6f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.6f} GB")
    del al, prof, kern

    for rep in range(2):
        _, met = run_align_pe(prefix, fq1, fq2, workdir, "cuda",
                              f"stream_pe_pigeon{rep}", None)
        w = align_window(met)
        print(f"warm align-pe --device cuda (engine "
              f"{met['config']['engine']}), run {rep}: {len(r1s)} pairs in "
              f"an align window of {w:.3f} s ({len(r1s) / w:.1f} pairs/s), "
              f"sequential sum {seq:.6f} s; index load "
              f"{met['t_index_load_s']} s")


def profile_pigeon_phase(prefix, reads, fq, workdir):
    """The pigeon route on the warm card: each batch's pipeline stages one
    after another with the device synchronised between them (host clock);
    one batch's device search under ``torch.profiler``, whole (kernel
    launches, device busy, idle share, peak memory) and then split by the
    engine's stages (``pigeon_search``'s ``on_stage`` hook: the device is
    synchronised where a stage ends, so a stage's kernels lie inside its
    range); then ``align --engine auto --device cuda`` twice more on phase
    3's reads, which are all eligible."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function)
    from hsa_tpu_torch.pipeline import Aligner, ReadBatch
    from hsa_tpu_torch.search import pigeon as pg
    al = Aligner(prefix, engine="auto", device="cuda")
    al.align(reads[:BATCH])                     # warm: tables, text rows
    seq = 0.0
    for s in range(0, len(reads), BATCH):
        rb = ReadBatch.from_reads(reads[s:s + BATCH])
        n_seg, elig = al._pigeon_split(rb)
        if len(elig) != len(rb):
            fail("phase 3's reads are not all eligible for the pigeon engine")
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        buf, shape = al._pigeon_pack(rb, n_seg)
        t.append(time.perf_counter())
        res = al._pigeon_device(buf, shape, n_seg)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        host = pg.fetch_result(res)
        t.append(time.perf_counter())
        h = ("pigeon", rb, elig, rb, host, al._pigeon_caps("base")[1], n_seg)
        occ, trunc, c2x = al._align_occ(h)
        t.append(time.perf_counter())
        al._resolve_occ(rb, None, None, occ, trunc, c2x, read_offset=s,
                        emit="sam")
        t.append(time.perf_counter())
        d = np.diff(t)
        seq += t[-1] - t[0]
        print(f"sequential pigeon batch at {s}: pack {d[0]:.6f} s, upload + "
              f"search {d[1]:.6f} s, readback {d[2]:.6f} s, host finalise "
              f"{d[3]:.6f} s, resolve {d[4]:.6f} s, sum {t[-1] - t[0]:.6f} s "
              f"(shape R, SL, B2, RW = {shape}, n_seg {n_seg}, upload "
              f"{buf.nbytes / 1e6:.3f} MB)")
    print(f"sequential pigeon: {len(reads)} reads in {seq:.6f} s "
          f"({len(reads) / seq:.1f} reads/s)")

    rb = ReadBatch.from_reads(reads[:BATCH])
    n_seg, _ = al._pigeon_split(rb)
    buf, shape = al._pigeon_pack(rb, n_seg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_events(prof):      # kernels and copies, not the stages' ranges
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith("pigeon:")]
        if not kern:
            fail("the profiler recorded no device kernels")
        return kern

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        al._pigeon_device(buf, shape, n_seg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    print(f"profiled pigeon search of {BATCH} reads: wall {wall:.6f} s, "
          f"{len(kern)} device kernels and copies, device busy {busy:.6f} s, "
          f"idle share {1 - busy / wall:.6f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.6f} GB")
    per = defaultdict(lambda: [0, 0.0])
    for e in kern:
        per[e.name][0] += 1
        per[e.name][1] += e.time_range.elapsed_us() / 1e3
    for name, (n, ms) in sorted(per.items(), key=lambda x: -x[1][1])[:8]:
        print(f"  {ms:10.3f} ms {n:6d} launches  {name[:90]}")

    open_range = []

    def on_stage(name):     # close the stage that ends, drained; open the next
        if open_range:
            torch.cuda.synchronize()
            open_range.pop().__exit__(None, None, None)
        if name is not None:
            open_range.append(record_function(f"pigeon:{name}"))
            open_range[-1].__enter__()

    with profile(activities=acts) as prof:
        al._pigeon_device(buf, shape, n_seg, on_stage=on_stage)
        torch.cuda.synchronize()
    kern = device_events(prof)
    stages = [e for e in prof.events() if e.name.startswith("pigeon:")
              and e.device_type == DeviceType.CPU]
    if not stages:
        fail("the profiler recorded no pigeon stage")
    for st in stages:
        inside = [e for e in kern if st.time_range.start
                  <= e.time_range.start <= st.time_range.end]
        dev_ms = sum(e.time_range.elapsed_us() for e in inside) / 1e3
        wall_ms = st.time_range.elapsed_us() / 1e3
        print(f"  stage {st.name[7:]:12s} wall {wall_ms:9.3f} ms "
              f"(synchronised at its end), {len(inside):5d} device kernels "
              f"and copies, device busy {dev_ms:9.3f} ms, idle share "
              f"{1 - dev_ms / wall_ms:.3f}")
    del al, prof, kern

    for rep in range(2):
        _, met = run_align(prefix, fq, workdir, "cuda", f"stream_pigeon{rep}",
                           "auto")
        w = align_window(met)
        print(f"warm align --engine auto --device cuda, run {rep}: "
              f"{met['reads_in']} reads in an align window of {w:.3f} s "
              f"({met['reads_in'] / w:.1f} reads/s), sequential sum "
              f"{seq:.6f} s; index load {met['t_index_load_s']} s")


# -- 12. the oracle: the card's records against the port's branch-and-bound ----
def oracle_genome(seed, workdir):
    """The oracle phase's genome (ORACLE_BP i.i.d. bases from the seed, as
    two FASTA records) indexed by ``hsa_tpu_torch.cli index``, cached like
    phase 3's.  Returns (codes, index prefix)."""
    from hsa_tpu_torch import cli
    genome = make_genome(sum(ORACLE_BP), seed + 12)
    prefix = os.path.join(workdir, f"oracle_{len(genome)}_s{seed}")
    if not os.path.exists(os.path.join(prefix + ".hsa", "text.pac")):
        fa = prefix + ".fa"
        s = ACGT[genome].tobytes()
        with open(fa, "wb") as fh:
            for name, lo, hi in (("chrA", 0, ORACLE_BP[0]),
                                 ("chrB", ORACLE_BP[0], len(genome))):
                fh.write(f">{name}\n".encode() + s[lo:hi] + b"\n")
        if cli.main(["index", fa, "-p", prefix]) != 0:
            fail("the oracle phase's index build failed")
        os.remove(fa)
    return genome, prefix


def oracle_reads(genome, seed, n=ORACLE_READS, kinds=ORACLE_KINDS,
                 boundary=ORACLE_BP[0]):
    """``n`` reads of ORACLE_L bp, one kind of ``kinds`` after the other
    (indels at least 10 bases from either end, beyond the search's
    indel_end_skip of 5), then, with ``boundary``, two reads across that
    position (the boundary between the records)."""
    rs = np.random.RandomState(seed + 13)
    L, reads = ORACLE_L, []
    for j in range(n):
        kind = kinds[j % len(kinds)]
        p = rs.randint(0, len(genome) - L - 2)
        r = genome[p:p + L + 1].copy()
        if kind == "1-bp deletion":
            r = np.delete(r, rs.randint(10, L - 10))
        elif kind == "1-bp insertion":
            r = np.insert(r, rs.randint(10, L - 10), rs.randint(0, 4))
        r = r[:L]
        n_mm = {"1 mismatch": 1, "2 mismatches": 2}.get(kind, 0)
        q = rs.choice(L, n_mm, replace=False)
        r[q] = (r[q] + rs.randint(1, 4, n_mm)) % 4
        if kind == "one N":
            r[rs.randint(0, L)] = 4
        elif kind == "junk":
            r = rs.randint(0, 4, L)
        elif kind == "reverse strand":
            r = revcomp(r)
        reads.append(r.astype(np.int8))
    if boundary:
        reads += [genome[boundary - off:boundary - off + L].copy()
                  for off in (40, 70)]
    return reads


def oracle_pairs(genome, seed):
    """ORACLE_PAIRS FR pairs of ORACLE_L bp ends inside the first record,
    fragments about N(ORACLE_ISIZE, ORACLE_ISIZE_SD): every 3rd end 1 with
    a mismatch, every 8th end 2 with ORACLE_HEAVY substitutions (found by
    the rescue alone); the second to last pair's end 1 is junk, the last
    pair's end 2 is taken ORACLE_FAR bases downstream (discordant)."""
    rs = np.random.RandomState(seed + 14)
    L, r1s, r2s = ORACLE_L, [], []
    for j in range(ORACLE_PAIRS):
        ins = int(np.clip(rs.normal(ORACLE_ISIZE, ORACLE_ISIZE_SD), 2 * L + 10,
                          2 * ORACLE_ISIZE))
        p = rs.randint(0, ORACLE_BP[0] - ins - ORACLE_FAR - 1)
        r1 = genome[p:p + L].copy()
        far = ORACLE_FAR if j == ORACLE_PAIRS - 1 else 0
        r2 = revcomp(genome[p + far + ins - L:p + far + ins])
        if j % 3 == 0:
            q = rs.randint(0, L)
            r1[q] = (r1[q] + rs.randint(1, 4)) % 4
        if j % 8 == 0:
            q = rs.choice(L, ORACLE_HEAVY, replace=False)
            r2[q] = (r2[q] + rs.randint(1, 4, ORACLE_HEAVY)) % 4
        if j == ORACLE_PAIRS - 2:
            r1 = rs.randint(0, 4, L).astype(np.int8)
        r1s.append(r1)
        r2s.append(r2)
    return r1s, r2s


def oracle_compare(route, got, want, ties_ok):
    """The card's SAM records (``got``) against the oracle's, byte for byte;
    with ``ties_ok``, a record may differ in the XM/XO/XG tags alone
    (docs/PARITY.md deviation 13, the rule of ``engine_compare``): those are
    listed and counted.  Fails on any other difference; returns the count of
    listed records."""
    if len(got) != len(want):
        fail(f"{route}: {len(got)} records, the oracle {len(want)}")
    ties, other = [], []
    for j, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        fg, fw = g.split("\t"), w.split("\t")
        if ties_ok and len(fg) == len(fw) and all(
                x.startswith(TIE_TAGS) for x, y in zip(fg, fw) if x != y):
            ties.append(j)
        else:
            other.append(j)
    for j in ties:
        print(f"  listed (deviation 13): {got[j]}\n      the oracle's: {want[j]}")
    print(f"{route}: {len(got) - len(ties) - len(other)} of {len(got)} "
          f"records byte-equal to the oracle's, {len(ties)} listed "
          f"(deviation 13: XM/XO/XG on an exact score tie at one position), "
          f"{len(other)} differ otherwise")
    if other:
        j = other[0]
        fail(f"{route}: {len(other)} records differ from the oracle's, first "
             f"record {j}:\n  card:   {got[j]}\n  oracle: {want[j]}")
    return len(ties)


def first_field(a, b):
    """Name of the first SAM field (or tag) where two records differ."""
    fa, fb = a.split("\t"), b.split("\t")
    names = ("QNAME", "FLAG", "RNAME", "POS", "MAPQ", "CIGAR", "RNEXT",
             "PNEXT", "TLEN", "SEQ", "QUAL")
    for i in range(max(len(fa), len(fb))):
        x, y = fa[i] if i < len(fa) else "", fb[i] if i < len(fb) else ""
        if x != y:
            return names[i] if i < len(names) else (x or y)[:2]
    return None


def oracle_phase(seed, workdir, int32_ops_s, compared):
    """Phase 12: the card's engines held against the port's oracle
    (``pipeline.oracle_align``/``oracle_align_pe``: fmcore + the
    branch-and-bound search on the host, the list resolvers, the mate
    rescue's screen on the card).  Returns (select_topk launches by route,
    glocal_screen launches by route, select step rows by route, glocal rows).
    """
    import torch
    from hsa_tpu_torch.config import AlnOpt
    from hsa_tpu_torch.kernels import select, sw
    from hsa_tpu_torch.pipeline import Aligner, oracle_align, oracle_align_pe
    t_phase = time.perf_counter()
    genome, prefix = oracle_genome(seed, workdir)
    reads = oracle_reads(genome, seed)
    r1s, r2s = oracle_pairs(genome, seed)
    meta = _oracle_meta(prefix)
    opt = AlnOpt(max_diff=ORACLE_MAX_DIFF)
    names = [f"r{j}" for j in range(len(reads))]
    quals = ["I" * len(r) for r in reads]
    pnames = [f"p{j}" for j in range(len(r1s))]
    pquals = ["I" * ORACLE_L] * len(r1s)
    print(f"genome of {len(genome)} bp in two records {ORACLE_BP}, "
          f"{len(reads)} reads ({ORACLE_READS} in rotation over "
          f"{ORACLE_KINDS} + 2 across the records' boundary), {len(r1s)} "
          f"pairs; AlnOpt(max_diff={ORACLE_MAX_DIFF})")

    def card(fn):
        """Runs ``fn`` with both kernels' counts set to 0 just before;
        returns (result, seconds, select launches, their shapes, glocal
        launches, their shapes)."""
        torch.cuda.synchronize()
        for k in (select.KERNEL, sw.KERNEL):
            k.launches = 0
            k.launch_shapes.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (out, secs, select.KERNEL.launches,
                dict(select.KERNEL.launch_shapes), sw.KERNEL.launches,
                sorted(sw.KERNEL.launch_shapes))

    t0 = time.perf_counter()
    want = [r.to_sam() for r in oracle_align(
        genome, meta, reads, names, quals, opt)]
    se_oracle_s = time.perf_counter() - t0
    print(f"oracle_align: {len(reads)} reads in {se_oracle_s:.3f} s "
          f"({se_oracle_s / len(reads):.6f} s a read, both FM builds "
          f"included)")
    kinds = [ORACLE_KINDS[j % len(ORACLE_KINDS)]
             for j in range(ORACLE_READS)] + ["across the boundary"] * 2
    sel, glo, rows = {}, {}, {}
    for engine, W in (("beam", ORACLE_SE_W), ("auto", ORACLE_SE_W),
                      ("beam", ORACLE_FULL_W)):
        route = f"oracle phase: align --engine {engine} -W {W}"
        al = Aligner(prefix, opt, engine=engine, device="cuda")
        recs, secs, n_sel, shapes, n_glo, _ = card(lambda: al.align(
            reads, names, quals, beam_width=W))
        print(f"{route}: {len(reads)} reads in {secs:.3f} s on the card "
              f"({secs / len(reads):.6f} s a read, first run); select_topk "
              f"launches {n_sel}")
        if engine == "beam":
            ld, hd = (np.asarray(x, np.int64).reshape(-1, len(reads)).sum(0)
                      for x in al.last_overflow)    # both strands' lanes
            by_kind = {k: [int(v[[x == k for x in kinds]].sum())
                           for v in (ld > 0, ld, hd > 0)]
                       for k in dict.fromkeys(kinds)}
            print(f"{route}: the beam dropped {int(ld.sum())} frontier states "
                  f"on {int((ld > 0).sum())} reads and {int(hd.sum())} hits; "
                  f"by kind [reads, states, reads that dropped hits] "
                  f"{json.dumps(by_kind)}")
            if W == ORACLE_FULL_W and (ld.any() or hd.any()):
                fail(f"{route}: the beam dropped states or hits")
            if n_sel == 0:
                fail(f"{route}: select_topk was launched no time")
        oracle_compare(route, [r.to_sam() for r in recs], want,
                       ties_ok=engine == "auto")
        sel[route] = n_sel
        if n_sel:
            rows[route] = select_path_phase(route, shapes, compared, seed,
                                            int32_ops_s)

    (orecs, pe_oracle_s, n_sel, _, n_glo, glo_shapes) = card(
        lambda: oracle_align_pe(
            genome, meta, r1s, r2s, pnames, pquals, pquals,
            opt, device="cuda"))
    want_pe = [r.to_sam() for r in orecs]
    print(f"oracle_align_pe: {len(r1s)} pairs in {pe_oracle_s:.3f} s "
          f"({pe_oracle_s / len(r1s):.6f} s a pair, both FM builds "
          f"included); glocal_screen launches {n_glo} at {glo_shapes}; "
          f"select_topk launches {n_sel} (expected 0); rescued mates "
          f"{sum('XT:Z:M' in l for l in want_pe)}")
    if n_glo == 0 or n_sel:
        fail(f"oracle_align_pe launched glocal_screen {n_glo} times (expected "
             f"1 or more) and select_topk {n_sel} times (expected 0)")
    glo["oracle_align_pe"] = n_glo
    glocal_rows = [glocal_main_path_phase(seed, glo_shapes, int32_ops_s,
                                          path="oracle_align_pe")]
    for engine in ("beam", "auto"):
        route = f"oracle phase: align-pe --engine {engine} -W {ORACLE_PE_W}"
        al = Aligner(prefix, opt, engine=engine, device="cuda")
        recs, secs, n_sel, shapes, n_glo, _ = card(lambda: al.align_pe(
            r1s, r2s, pnames, pquals, pquals, beam_width=ORACLE_PE_W))
        ld, hd = (np.asarray(x, np.int64) for x in al.last_overflow)
        print(f"{route}: {len(r1s)} pairs in {secs:.3f} s on the card; "
              f"select_topk launches {n_sel}, glocal_screen {n_glo}; the beam "
              f"dropped {int(ld.sum())} frontier states on {int((ld > 0).sum())}"
              f" lanes and {int(hd.sum())} hits")
        oracle_compare(route, [r.to_sam() for r in recs], want_pe,
                       ties_ok=engine == "auto")
        sel[route], glo[route] = n_sel, n_glo
        if n_sel:
            rows[route] = select_path_phase(route, shapes, compared, seed,
                                            int32_ops_s)

    rs = np.random.RandomState(seed + 15)
    for case in [dict(ORACLE_TALL, name="tall frontier: W=512 at 16,384 "
                                         "columns"), *ORACLE_TALL_EDGES]:
        compared[select_key(case)] = select_compare(case, rs, int32_ops_s)

    # the CLI's defaults: printed, not gated (a beam of 64 is lossy by design)
    cli_reads, _ = make_reads(genome, ORACLE_CLI_READS, seed + 16)
    cnames = [f"r{j}" for j in range(len(cli_reads))]
    cquals = ["I" * len(r) for r in cli_reads]
    t0 = time.perf_counter()
    cwant = [r.to_sam() for r in oracle_align(
        genome, meta, cli_reads, cnames, cquals, AlnOpt())]
    cli_oracle_s = time.perf_counter() - t0
    print(f"oracle_align at the CLI defaults (AlnOpt()): "
          f"{len(cli_reads)} reads in {cli_oracle_s:.3f} s "
          f"({cli_oracle_s / len(cli_reads):.6f} s a read)")
    for engine in ("beam", "auto"):
        route = f"oracle phase: CLI defaults, --engine {engine} -W {ORACLE_CLI_W}"
        al = Aligner(prefix, AlnOpt(), engine=engine, device="cuda")
        recs, secs, n_sel, shapes, _, _ = card(lambda: al.align(
            cli_reads, cnames, cquals, beam_width=ORACLE_CLI_W))
        got = [r.to_sam() for r in recs]
        diff = {}
        for g, w in zip(got, cwant):
            if g != w:
                f = first_field(g, w)
                diff[f] = diff.get(f, 0) + 1
        print(f"{route}: {sum(g == w for g, w in zip(got, cwant))} of "
              f"{len(got)} records byte-equal to the oracle's; the others by "
              f"first differing field {json.dumps(diff)} (not gated); "
              f"{secs:.3f} s on the card, select_topk launches {n_sel}")
        sel[route] = n_sel
        if n_sel:
            rows[route] = select_path_phase(route, shapes, compared, seed,
                                            int32_ops_s)
    print(f"phase 12 took {time.perf_counter() - t_phase:.3f} s")
    return sel, glo, rows, glocal_rows


def _oracle_meta(prefix):
    """The index directory's RefMeta (the records' names and bounds)."""
    from hsa_tpu_torch.io.fastx import RefMeta
    with open(os.path.join(prefix + ".hsa", "meta.json")) as fh:
        return RefMeta.from_dict(json.load(fh)["ref"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="also break the warm run down by stream phase and "
                         "profile one batch's search")
    ap.add_argument("--glocal-only", metavar="R,L,G",
                    help="only phases 1 and 5 (the glocal kernel against "
                         "plain), then the same at this shape; prints no "
                         "result line.  For holding two checkouts' kernels "
                         "against each other in one call")
    ap.add_argument("--probes-only", action="store_true",
                    help="only phases 1 and 2b (the gather probes' kernels); "
                         "prints their kernel rows and no result line")
    ap.add_argument("--gather-only", action="store_true",
                    help="only phases 1, 2b and 4b (the gather kernels at "
                         "the probes' inputs and at the main path's table, "
                         "with phase 3's index and phase 6's pairs for the "
                         "extend's ids), with sweeps of gather_rows' and "
                         "table_take's plans; prints their kernel rows and "
                         "no result line")
    ap.add_argument("--baseline", metavar="DIR",
                    help="also build the earlier gather_rows.cu and "
                         "table_take.cu in DIR and hold and time them in "
                         "turns with the current ones in phases 2b and 4b")
    ap.add_argument("--oracle-only", action="store_true",
                    help="only phases 1 and 12 (the card's records against "
                         "the oracle); prints no result line")
    ap.add_argument("--api-only", action="store_true",
                    help="only phase 1, phase 3's index and reads, and phase "
                         "10c (the rest of the device API); prints no result "
                         "line")
    # one rank of a phase 10b world, as shard_phase starts it
    ap.add_argument("--shard-rank", nargs=8, help=argparse.SUPPRESS)
    # phase 10c's CPU side of resolve_handle, as device_api_phase starts it
    ap.add_argument("--handle-cpu", nargs=3, help=argparse.SUPPRESS)
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, ROOT)
    try:
        import hsa_tpu_torch  # noqa: F401
        from hsa_tpu_torch.kernels import gather, select, sw
    except ImportError as e:
        fail(f"the repository is not beside this script ({e})")
    if a.shard_rank:
        shard_rank(*a.shard_rank)
        return
    if a.handle_cpu:
        handle_cpu(*a.handle_cpu)
        return
    baseline = Baseline(a.baseline) if a.baseline else None

    phase("1. device and build")
    int32_ops_s = device_info()
    build_kernels(baseline)
    if a.glocal_only:
        phase("5. glocal_screen kernel against its plain version and the "
              "native DP")
        sass_summary(sw.KERNEL, "glocal_screen_kernelILi18ELb0E")
        glocal_phase(a.seed, int32_ops_s)
        glocal_main_path_phase(
            a.seed, [tuple(int(x) for x in a.glocal_only.split(","))],
            int32_ops_s)
        return

    if a.oracle_only:
        phase(ORACLE_PHASE)
        oracle_phase(a.seed, smoke_dir(), int32_ops_s, {})
        return

    if a.api_only:
        phase(API_PHASE)
        workdir = smoke_dir()
        genome = make_genome(GENOME_BP, a.seed)
        prefix, index_s = ensure_index(genome, a.seed, workdir)
        print(f"index build seconds: "
              f"{index_s if index_s is not None else 'cached'}")
        reads, _ = make_reads(genome, API_HANDLE_READS, a.seed)
        del genome
        device_api_phase(prefix, reads, None, a.seed, workdir, int32_ops_s,
                         {})
        return

    if a.probes_only or a.gather_only:
        phase(PROBE_PHASE)
        probe_launches, probe_rows = probe_phase(baseline=baseline,
                                                 sweep=a.gather_only)
        main_table = None
        if a.gather_only:
            phase(MAIN_TABLE_PHASE)
            t0 = time.perf_counter()
            genome = make_genome(GENOME_BP, a.seed)
            prefix, index_s = ensure_index(genome, a.seed, smoke_dir())
            r1s, r2s, _ = make_pairs(genome, PE_PAIRS, a.seed)
            del genome
            print(f"index build seconds: "
                  f"{index_s if index_s is not None else 'cached'}; index "
                  f"and pairs ready in {time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            main_table = main_table_phase(prefix, a.seed, r1s + r2s,
                                          baseline=baseline, sweep=True)
            print(f"phase 4b's gather at the main path's table took "
                  f"{time.perf_counter() - t0:.3f} s")
        print(json.dumps({"kernels": gather_rows_json(
            probe_launches, probe_rows, main_table)}))
        return

    phase("2. select_topk kernel against its plain version on the card")
    shapes, compared = kernel_phase(a.seed, int32_ops_s)

    phase(PROBE_PHASE)
    probe_launches, probe_rows = probe_phase(baseline=baseline)

    phase("3. main path: index + align --engine beam --device cuda")
    workdir = smoke_dir()
    t0 = time.perf_counter()
    genome = make_genome(GENOME_BP, a.seed)
    prefix, index_s = ensure_index(genome, a.seed, workdir)
    print(f"index build seconds: {index_s if index_s is not None else 'cached'}"
          f" ({GENOME_BP} bp)")
    reads, origin = make_reads(genome, N_READS, a.seed)
    r1s, r2s, pe_origin = make_pairs(genome, PE_PAIRS, a.seed)
    n_long_pairs = PE_PAIRS // PE_LONG_EVERY
    pp_r1s, pp_r2s, pp_origin, pp_heavy, pp_src = interleave_long_pairs(
        r1s, r2s, pe_origin, *make_long_pairs(genome, n_long_pairs, a.seed))
    n_long = N_READS // PIGEON_LONG_EVERY
    p_reads, p_origin, p_src = interleave_long(
        reads, origin, *make_long_reads(genome, n_long, a.seed))
    del genome
    fq = os.path.join(workdir, f"reads_{GENOME_BP}_s{a.seed}.fq")
    write_fastq(fq, reads)
    p_fq = os.path.join(workdir, f"reads_pigeon_{GENOME_BP}_s{a.seed}.fq")
    write_fastq(p_fq, p_reads)
    fq1, fq2 = write_pairs(workdir, f"pairs_{GENOME_BP}_s{a.seed}", r1s, r2s)
    pp_fq1, pp_fq2 = write_pairs(
        workdir, f"pairs_pigeon_{GENOME_BP}_s{a.seed}", pp_r1s, pp_r2s)
    print(f"genome + reads ready in {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    select.KERNEL.launches = 0
    select.KERNEL.launch_shapes.clear()
    # the gather kernels are on no main path: counted from here to phase 10,
    # less the launches that phase 4b makes to time them
    for k in gather.KERNELS.values():
        k.launches = 0
    lines, met = run_align(prefix, fq, workdir, "cuda", "smoke")
    launches = select.KERNEL.launches
    se_launched = dict(select.KERNEL.launch_shapes)

    phase("4. checks")
    batches = met.get("batches", [])
    for i, b in enumerate(batches):
        print(f"batch {i}: {b['n']} reads, yield waited for "
              f"{b['wait_s']:.6f} s")
    w = align_window(met)
    print(f"align: {met['reads_in']} reads in an align window of {w:.3f} s "
          f"({met['reads_in'] / w:.1f} reads/s, first run: includes "
          f"first-use warm-up); index load {met['t_index_load_s']} s")
    mapped, placed = check_placement(
        [l for l in lines if not l.startswith("@")], origin)
    overflow = met.get("beam_overflow_reads", 0)
    print(f"mapped fraction {mapped:.6f} (min {MAPPED_MIN}); placed within "
          f"2 bp {placed:.6f} (min {PLACED_MIN}); overflow reads {overflow}")
    opt = met["config"]["opt"]
    if met["config"]["batch"] != BATCH or len(batches) != -(-N_READS // BATCH):
        fail(f"align ran batches of {met['config']['batch']}, not {BATCH}")
    n_steps = READ_LEN + opt["max_gapo"] + opt["max_gape"]
    want = 2 * n_steps * len(batches)
    print(f"select_topk launches on the main path: {launches} "
          f"(expected 2 x {n_steps} steps x {len(batches)} batches = {want})")
    if mapped < MAPPED_MIN:
        fail(f"mapped fraction {mapped} < {MAPPED_MIN}")
    if placed < PLACED_MIN:
        fail(f"placed fraction {placed} < {PLACED_MIN}")
    if launches == 0 or launches != want:
        fail(f"select_topk launched {launches} times, expected {want}")
    by_path = {"align": select_path_phase(
        "align --engine beam", se_launched, compared, a.seed, int32_ops_s)}
    t0 = time.perf_counter()
    n = cross_check(prefix, reads, lines, workdir)
    print(f"cross-check: align --device cpu on the first {n} reads gives a "
          f"SAM byte-equal to the card's ({time.perf_counter() - t0:.3f} s)")

    phase(MAIN_TABLE_PHASE + "; occ_probe5 on phase 3's index")
    t0 = time.perf_counter()
    n0 = {name: k.launches for name, k in gather.KERNELS.items()}
    main_table = main_table_phase(prefix, a.seed, r1s + r2s,
                                  baseline=baseline)
    gather_timed = {name: k.launches - n0[name]
                    for name, k in gather.KERNELS.items()}
    from hsa_tpu_torch.tools import occ_probe5
    print(f"python -m hsa_tpu_torch.tools.occ_probe5 --index {prefix} "
          "--device cuda")
    occ_probe5.main(["--index", prefix, "--device", "cuda"])
    print(f"phase 4b took {time.perf_counter() - t0:.3f} s")

    phase("5. glocal_screen kernel against its plain version and the "
          "native DP")
    glocal = glocal_phase(a.seed, int32_ops_s)

    phase("6. paired-end main path: align-pe --engine beam --device cuda")
    torch.cuda.synchronize()
    select.KERNEL.launches = sw.KERNEL.launches = 0
    sw.KERNEL.launch_shapes.clear()
    select.KERNEL.launch_shapes.clear()
    pe_lines, pe_met = run_align_pe(prefix, fq1, fq2, workdir, "cuda",
                                    "smoke_pe")
    pe_select, pe_glocal = select.KERNEL.launches, sw.KERNEL.launches
    pe_launched = sorted(sw.KERNEL.launch_shapes.elements())
    pe_sel_launched = dict(select.KERNEL.launch_shapes)

    phase("7. paired-end checks")
    pe_batches = pe_met.get("batches", [])
    for i, b in enumerate(pe_batches):
        print(f"batch {i}: {b['n'] // 2} pairs, {b['rescue_jobs']} rescue "
              f"jobs, yield waited for {b['wait_s']:.6f} s")
    w = align_window(pe_met)
    print(f"align-pe: {PE_PAIRS} pairs in an align window of {w:.3f} s "
          f"({PE_PAIRS / w:.1f} pairs/s, first run); index load "
          f"{pe_met['t_index_load_s']} s")
    pe_mapped, pe_placed, rescued = check_pairs(
        [l for l in pe_lines if not l.startswith("@")], pe_origin)
    print(f"plain pairs: mapped ends {pe_mapped:.6f} (min {PE_MAPPED_MIN}), "
          f"placed within 2 bp {pe_placed:.6f} (min {PE_PLACED_MIN}); heavy "
          f"mates rescued (XT:Z:M) at their origin {rescued:.6f} (min "
          f"{RESCUED_MIN}); overflow reads "
          f"{pe_met.get('beam_overflow_reads', 0)}")
    pe_opt = pe_met["config"]["opt"]
    if pe_met["config"]["batch"] != BATCH or \
            len(pe_batches) != -(-PE_PAIRS // BATCH):
        fail(f"align-pe ran batches of {pe_met['config']['batch']} pairs, "
             f"not {BATCH}")
    pe_steps = PE_LEN + pe_opt["max_gapo"] + pe_opt["max_gape"]
    want = 2 * pe_steps * len(pe_batches)
    want_g = sum(b["rescue_jobs"] > 0 for b in pe_batches)
    print(f"launches on the paired-end path: select_topk {pe_select} "
          f"(expected 2 x {pe_steps} steps x {len(pe_batches)} batches = "
          f"{want}); glocal_screen {pe_glocal} (expected one per batch with "
          f"rescue jobs = {want_g})")
    if pe_mapped < PE_MAPPED_MIN:
        fail(f"mapped end fraction {pe_mapped} < {PE_MAPPED_MIN}")
    if pe_placed < PE_PLACED_MIN:
        fail(f"placed end fraction {pe_placed} < {PE_PLACED_MIN}")
    if rescued < RESCUED_MIN:
        fail(f"rescued heavy-mate fraction {rescued} < {RESCUED_MIN}")
    if pe_select != want:
        fail(f"select_topk launched {pe_select} times on align-pe, "
             f"expected {want}")
    if pe_glocal == 0 or pe_glocal != want_g:
        fail(f"glocal_screen launched {pe_glocal} times, expected {want_g} "
             "(and more than 0)")
    t0 = time.perf_counter()
    pe_cross_check(prefix, r1s, r2s, workdir)
    print(f"cross-check: align-pe --engine beam on {PE_CROSS_CHECK} pairs "
          f"gives byte-equal SAMs on cuda and cpu "
          f"({time.perf_counter() - t0:.3f} s)")
    want_r = sorted(b["rescue_jobs"] for b in pe_batches if b["rescue_jobs"])
    if sorted(r for r, _, _ in pe_launched) != want_r:
        fail(f"glocal_screen was launched at {pe_launched}, the batches had "
             f"{want_r} rescue jobs")
    glocal.append(glocal_main_path_phase(a.seed, pe_launched, int32_ops_s))
    by_path["align-pe"] = select_path_phase(
        "align-pe --engine beam", pe_sel_launched, compared, a.seed,
        int32_ops_s)

    phase("7a. paired ends on the pigeon route: align-pe --device cuda at "
          "the CLI's default engine (auto)")
    al_p = kmer_table_phase(prefix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    select.KERNEL.launches = sw.KERNEL.launches = 0
    sw.KERNEL.launch_shapes.clear()
    select.KERNEL.launch_shapes.clear()
    pp_lines, pp_met = run_align_pe(prefix, pp_fq1, pp_fq2, workdir, "cuda",
                                    "smoke_pe_pigeon", None)
    pp_select, pp_glocal = select.KERNEL.launches, sw.KERNEL.launches
    pp_launched = sorted(sw.KERNEL.launch_shapes.elements())
    pp_sel_launched = dict(select.KERNEL.launch_shapes)
    pp_peak = torch.cuda.max_memory_allocated() / 1e9

    phase("7b. paired pigeon checks")
    pp_batches = pp_met.get("batches", [])
    for i, b in enumerate(pp_batches):
        print(f"batch {i}: {b['n'] // 2} pairs, profile {b['profile']}, "
              f"fallback {b['fallback']}, trunc {b['trunc']}, retry "
              f"{b['retry']}, {b['rescue_jobs']} rescue jobs, yield waited "
              f"for {b['wait_s']:.6f} s")
    w = align_window(pp_met)
    print(f"align-pe (engine {pp_met['config']['engine']}): {len(pp_r1s)} "
          f"pairs ({n_long_pairs} of {PE_LONG_LEN} bp ends for the beam) in "
          f"an align window of {w:.3f} s ({len(pp_r1s) / w:.1f} pairs/s, "
          f"first run); index load, with the K-mer table's, "
          f"{pp_met['t_index_load_s']} s; peak device memory {pp_peak:.6f} GB")
    if pp_met["config"]["engine"] != "auto" or \
            pp_met["config"]["batch"] != BATCH or \
            len(pp_batches) != -(-len(pp_r1s) // BATCH):
        fail(f"align-pe ran {len(pp_batches)} batches of "
             f"{pp_met['config']['batch']} pairs with engine "
             f"{pp_met['config']['engine']}")
    pp_records = [l for l in pp_lines if not l.startswith("@")]
    pp_mapped, pp_placed, pp_rescued = check_pairs(pp_records, pp_origin,
                                                   pp_heavy)
    long_mapped = sum(not int(pp_records[2 * j + e].split("\t", 2)[1]) & 4
                      for j in np.nonzero(pp_src < 0)[0] for e in (0, 1))
    print(f"plain pairs: mapped ends {pp_mapped:.6f} (min {PE_MAPPED_MIN}), "
          f"placed within 2 bp {pp_placed:.6f} (min {PE_PLACED_MIN}); heavy "
          f"mates rescued (XT:Z:M) at their origin {pp_rescued:.6f} (min "
          f"{RESCUED_MIN}); long ends mapped {long_mapped} of "
          f"{2 * n_long_pairs}; overflow reads "
          f"{pp_met.get('beam_overflow_reads', 0)}")
    long_steps = PE_LONG_LEN + pe_opt["max_gapo"] + pe_opt["max_gape"]
    want_g = sum(b["rescue_jobs"] > 0 for b in pp_batches)
    print(f"launches on the paired pigeon path: select_topk {pp_select} (2 x "
          f"{long_steps} steps = {2 * long_steps} for each pooled beam run "
          f"of the paired stream's flush); glocal_screen {pp_glocal} "
          f"(expected one per batch with rescue jobs = {want_g})")
    if pp_mapped < PE_MAPPED_MIN:
        fail(f"paired pigeon: mapped end fraction {pp_mapped} < "
             f"{PE_MAPPED_MIN}")
    if pp_placed < PE_PLACED_MIN:
        fail(f"paired pigeon: placed end fraction {pp_placed} < "
             f"{PE_PLACED_MIN}")
    if pp_rescued < RESCUED_MIN:
        fail(f"paired pigeon: rescued heavy-mate fraction {pp_rescued} < "
             f"{RESCUED_MIN}")
    if pp_select == 0 or sum(pp_sel_launched.values()) != pp_select:
        fail(f"select_topk was launched {pp_select} times on the paired "
             f"pigeon path and recorded {sum(pp_sel_launched.values())} "
             f"launch shapes")
    if pp_glocal == 0 or pp_glocal != want_g:
        fail(f"glocal_screen launched {pp_glocal} times on the paired pigeon "
             f"path, expected {want_g} (and more than 0)")
    want_r = sorted(b["rescue_jobs"] for b in pp_batches if b["rescue_jobs"])
    if sorted(r for r, _, _ in pp_launched) != want_r:
        fail(f"glocal_screen was launched at {pp_launched}, the batches had "
             f"{want_r} rescue jobs")
    glocal.append(glocal_main_path_phase(a.seed, pp_launched, int32_ops_s,
                                         "align-pe --engine auto"))
    by_path["align-pe --engine auto"] = select_path_phase(
        "align-pe --engine auto", pp_sel_launched, compared, a.seed,
        int32_ops_s)
    t0 = time.perf_counter()
    pe_cross_check(prefix, pp_r1s, pp_r2s, workdir, "auto")
    print(f"cross-check: align-pe --engine auto on the first "
          f"{PE_CROSS_CHECK} pairs ({int((pp_src[:PE_CROSS_CHECK] < 0).sum())} "
          f"of them long) gives byte-equal SAMs on cuda and cpu "
          f"({time.perf_counter() - t0:.3f} s)")
    n_hdr = sum(l.startswith("@") for l in pe_lines)
    t0 = time.perf_counter()
    pe_engine_compare(al_p, prefix, r1s[:BATCH], r2s[:BATCH],
                      pe_origin[:BATCH], pe_lines[n_hdr:])
    print(f"engine comparison took {time.perf_counter() - t0:.3f} s")

    phase(f"7c. the beam ladder: align --engine beam --ladder {LADDER}")
    select.KERNEL.launch_shapes.clear()
    ladder_select = ladder_phase(prefix, reads, origin, opt, workdir)
    by_path[f"align --ladder {LADDER}"] = select_path_phase(
        f"align --ladder {LADDER}", dict(select.KERNEL.launch_shapes),
        compared, a.seed, int32_ops_s)

    phase("7d. the two-phase flow: aln x2 + sampe on phase 7a's pairs, aln + "
          "samse on phase 8's reads, --device cuda")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    select.KERNEL.launches = sw.KERNEL.launches = 0
    select.KERNEL.launch_shapes.clear()
    sw.KERNEL.launch_shapes.clear()
    with FallbackClock() as clock:
        tp_alns, tp_sais, tp_runs = [], [], []
        for m, fq in ((1, pp_fq1), (2, pp_fq2)):
            sai, met = run_aln(prefix, fq, workdir, "cuda", f"smoke_aln_pe{m}")
            tp_sais.append(sai)
            tp_alns.append(met)
            tp_runs.append(list(clock.runs))
            clock.runs.clear()
        marks = [select.KERNEL.launches]
        tp_lines, tp_met = run_resolve(prefix, tp_sais, (pp_fq1, pp_fq2),
                                       workdir, "cuda", "smoke_sampe")
        tp_glocal = sw.KERNEL.launches
        tp_glocal_launched = sorted(sw.KERNEL.launch_shapes.elements())
        marks.append(select.KERNEL.launches)
        se_sai, se_aln = run_aln(prefix, p_fq, workdir, "cuda", "smoke_aln_se")
        se_runs = list(clock.runs)
        marks.append(select.KERNEL.launches)
        se_lines, se_met = run_resolve(prefix, [se_sai], (p_fq,), workdir,
                                       "cuda", "smoke_samse")
        marks.append(select.KERNEL.launches)
    tp_select = select.KERNEL.launches
    tp_launched = dict(select.KERNEL.launch_shapes)
    # select_topk launches: aln on the mate files, sampe, aln on the single
    # ends, samse
    tp_aln_select, se_aln_select = marks[0], marks[2] - marks[1]
    tp_resolve_select = (marks[1] - marks[0]) + (marks[3] - marks[2])
    tp_aln_launches = tp_aln_select + se_aln_select
    ws = [print_aln(f"aln --device cuda on mate file {m + 1}", met, runs)
          for m, (met, runs) in enumerate(zip(tp_alns, tp_runs))]
    w_pe = align_window(tp_met)
    for i, b in enumerate(tp_met["batches"]):
        print(f"  sampe batch {i}: {b['n'] // 2} pairs, {b['rescue_jobs']} "
              f"rescue jobs")
    n_pairs = tp_met["reads_in"] // 2
    sizes = [os.path.getsize(s) for s in tp_sais]
    print(f"sampe --device cuda: {n_pairs} pairs in a window of {w_pe:.3f} s; "
          f"the two-phase flow {ws[0]:.3f} + {ws[1]:.3f} + {w_pe:.3f} = "
          f"{sum(ws) + w_pe:.3f} s, {n_pairs / (sum(ws) + w_pe):.1f} pairs/s "
          f"(first runs; align-pe's window in phase 7a "
          f"{align_window(pp_met):.3f} s); .sai sizes {sizes} bytes")
    w_se = print_aln("aln --device cuda on phase 8's reads", se_aln, se_runs)
    w_samse = align_window(se_met)
    print(f"samse --device cuda: {se_met['reads_in']} reads in a window of "
          f"{w_samse:.3f} s; the two-phase flow {w_se + w_samse:.3f} s, "
          f"{se_met['reads_in'] / (w_se + w_samse):.1f} reads/s; .sai size "
          f"{os.path.getsize(se_sai)} bytes")
    tp_records = sam_body(tp_lines)
    same = tp_records == pp_records
    print(f"sampe's records {'equal' if same else 'DIFFER FROM'} phase 7a's "
          f"align-pe records ({len(tp_records)} lines, byte for byte)")
    if not same:
        bad = next(j for j in range(max(len(tp_records), len(pp_records)))
                   if tp_records[j:j + 1] != pp_records[j:j + 1])
        fail(f"aln x2 + sampe differs from align-pe at record {bad}:\n  "
             f"align-pe: {pp_records[bad:bad + 1]}\n  sampe:    "
             f"{tp_records[bad:bad + 1]}")
    tp_steps = [2 * (mx + pe_opt["max_gapo"] + pe_opt["max_gape"])
                for runs in tp_runs + [se_runs] for _, mx, _ in runs]
    want_g = sum(b["rescue_jobs"] > 0 for b in tp_met["batches"])
    print(f"launches of the two-phase flow: select_topk {tp_aln_launches} in "
          f"aln ({tp_aln_select} on the mate files, {se_aln_select} on the "
          f"single ends; expected 2 x (longest read + "
          f"{pe_opt['max_gapo'] + pe_opt['max_gape']}) steps for each inline "
          f"beam run = {sum(tp_steps)}), {tp_resolve_select} in samse and "
          f"sampe; glocal_screen {tp_glocal} in sampe (expected one per batch "
          f"with rescue jobs = {want_g})")
    if tp_aln_launches == 0 or tp_aln_launches != sum(tp_steps) or \
            sum(tp_launched.values()) != tp_select or tp_resolve_select:
        fail(f"select_topk launched {tp_aln_launches} times in aln (expected "
             f"{sum(tp_steps)} and more than 0) and {tp_resolve_select} in "
             f"samse/sampe (expected 0)")
    if tp_glocal == 0 or tp_glocal != want_g or sorted(
            r for r, _, _ in tp_glocal_launched) != sorted(
            b["rescue_jobs"] for b in tp_met["batches"] if b["rescue_jobs"]):
        fail(f"glocal_screen was launched at {tp_glocal_launched} in sampe, "
             f"expected one launch per batch with rescue jobs "
             f"{[b['rescue_jobs'] for b in tp_met['batches']]}")
    by_path["aln"] = select_path_phase("aln", tp_launched, compared, a.seed,
                                       int32_ops_s)
    held = {g["shape"] for g in glocal}
    for R, L, G in sorted(set(tp_glocal_launched)):
        print(f"glocal_screen launch on sampe: R={R} L={L} G={G}"
              + (" (compared above)" if f"R={R} L={L} G={G}" in held else ""))
        if f"R={R} L={L} G={G}" not in held:
            glocal.append(glocal_compare(
                make_glocal_case(R, L, G, np.random.RandomState(a.seed + 9)),
                "main path (sampe)", int32_ops_s, native=True))
    t0 = time.perf_counter()
    two_phase_cross_check(prefix, pp_r1s, pp_r2s, workdir)
    print(f"cross-check: aln x2 + sampe on the first {PE_CROSS_CHECK} pairs "
          f"gives byte-equal SAMs on cuda and cpu "
          f"({time.perf_counter() - t0:.3f} s)")
    aln_resume_check(prefix, pp_fq1, tp_sais[0], workdir, "smoke_aln_pe1")
    print(f"phase 7d took {time.perf_counter() - t_phase:.3f} s")

    phase("8. pigeon main path: align --engine auto --device cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    select.KERNEL.launches = 0
    select.KERNEL.launch_shapes.clear()
    pg_lines, pg_met = run_align(prefix, p_fq, workdir, "cuda", "smoke_pigeon",
                                 "auto")
    pg_select = select.KERNEL.launches
    pg_launched = dict(select.KERNEL.launch_shapes)
    pg_peak = torch.cuda.max_memory_allocated() / 1e9

    phase("9. pigeon checks")
    pg_batches = pg_met.get("batches", [])
    for i, b in enumerate(pg_batches):
        print(f"batch {i}: {b['n']} reads, profile {b['profile']}, fallback "
              f"{b['fallback']}, trunc {b['trunc']}, retry {b['retry']}, yield "
              f"waited for {b['wait_s']:.6f} s")
    w = align_window(pg_met)
    print(f"align --engine auto: {pg_met['reads_in']} reads ({n_long} of "
          f"{PIGEON_LONG_LEN} bp for the beam) in an align window of {w:.3f} "
          f"s ({pg_met['reads_in'] / w:.1f} reads/s, first run: includes "
          f"first-use warm-up); index load, with the K-mer table's, "
          f"{pg_met['t_index_load_s']} s; peak device memory {pg_peak:.6f} "
          f"GB")
    if pg_met["config"]["engine"] != "auto" or \
            pg_met["config"]["batch"] != BATCH or \
            len(pg_batches) != -(-len(p_reads) // BATCH):
        fail(f"align --engine auto ran {len(pg_batches)} batches of "
             f"{pg_met['config']['batch']} with engine "
             f"{pg_met['config']['engine']}")
    pg_records = [l for l in pg_lines if not l.startswith("@")]
    pg_mapped, pg_placed = check_placement(pg_records, p_origin)
    long_mapped = sum(not int(pg_records[j].split("\t", 2)[1]) & 4
                      for j in np.nonzero(p_src < 0)[0])
    print(f"mapped fraction {pg_mapped:.6f} (min {MAPPED_MIN}); placed within "
          f"2 bp {pg_placed:.6f} (min {PLACED_MIN}); long reads mapped "
          f"{long_mapped} of {n_long}; overflow reads "
          f"{pg_met.get('beam_overflow_reads', 0)}")
    long_steps = PIGEON_LONG_LEN + opt["max_gapo"] + opt["max_gape"]
    print(f"select_topk launches on the pigeon path: {pg_select} (2 x "
          f"{long_steps} steps = {2 * long_steps} for each pooled beam run "
          f"over the reads the router or the engine handed to the beam)")
    if pg_mapped < MAPPED_MIN:
        fail(f"pigeon path: mapped fraction {pg_mapped} < {MAPPED_MIN}")
    if pg_placed < PLACED_MIN:
        fail(f"pigeon path: placed fraction {pg_placed} < {PLACED_MIN}")
    if pg_select == 0 or sum(pg_launched.values()) != pg_select:
        fail(f"select_topk was launched {pg_select} times on the pigeon path "
             f"and recorded {sum(pg_launched.values())} launch shapes")
    by_path["align --engine auto"] = select_path_phase(
        "align --engine auto", pg_launched, compared, a.seed, int32_ops_s)
    fractions = pigeon_batch_phase(al_p, p_reads[:BATCH], sum(p_src[:BATCH] < 0))
    t0 = time.perf_counter()
    card = pigeon_cross_check(prefix, p_reads, workdir)
    same = card == pg_lines[:len(card)]
    print(f"cross-check: align --engine auto on the first "
          f"{PIGEON_CROSS_CHECK} reads gives byte-equal SAMs on cuda and cpu "
          f"({time.perf_counter() - t0:.3f} s); they "
          f"{'equal' if same else 'DIFFER FROM'} the first records of the "
          f"full run")
    if not same:
        fail("the prefix's SAM differs from the full run's first records")
    same = sam_body(se_lines) == pg_records
    print(f"phase 7d's aln + samse records {'equal' if same else 'DIFFER FROM'}"
          f" align --engine auto's ({len(pg_records)} lines, byte for byte)")
    if not same:
        se_records = sam_body(se_lines)
        bad = next(j for j in range(max(len(se_records), len(pg_records)))
                   if se_records[j:j + 1] != pg_records[j:j + 1])
        fail(f"aln + samse differs from align --engine auto at record {bad}:"
             f"\n  align: {pg_records[bad:bad + 1]}\n  samse: "
             f"{se_records[bad:bad + 1]}")
    n_hdr = sum(l.startswith("@") for l in lines)
    engine_compare(al_p, prefix, reads[:BATCH], lines[n_hdr:], origin[:BATCH])
    del al_p

    phase("10. repeat path at small size: align_stream with small caps, "
          "cuda against cpu")
    select.KERNEL.launch_shapes.clear()
    repeat_select = repeat_phase(a.seed, workdir)
    rp_launched = dict(select.KERNEL.launch_shapes)
    if sum(rp_launched.values()) != repeat_select:
        fail(f"the repeat path launched select_topk {repeat_select} times and "
             f"recorded {sum(rp_launched.values())} launch shapes")
    by_path["repeat path (align_stream)"] = select_path_phase(
        "the repeat path", rp_launched, compared, a.seed, int32_ops_s)

    phase("10b. the sharded index: ShardedIndex over (data, shard) meshes of "
          "ranks on this card, against the unsharded search")
    shard_select, shard_launched = shard_phase(prefix, reads, a.seed, workdir)
    by_path["sharded beam"] = select_path_phase(
        "sharded beam", shard_launched, compared, a.seed, int32_ops_s)

    phase(API_PHASE)
    api_select, api_rows = device_api_phase(prefix, reads, lines, a.seed,
                                            workdir, int32_ops_s, compared)
    by_path.update(api_rows)

    if a.profile:
        phase("11. where the time goes (warm card)")
        profile_phase(prefix, reads, opt, fq, workdir)
        profile_pe_phase(prefix, r1s, r2s, fq1, fq2, workdir)
        profile_pe_pigeon_phase(prefix, r1s, r2s, fq1, fq2, workdir)
        profile_pigeon_phase(prefix, reads, fq, workdir)

    phase(ORACLE_PHASE)
    or_select, or_glocal, or_rows, or_glocal_rows = oracle_phase(
        a.seed, workdir, int32_ops_s, compared)
    by_path.update(or_rows)
    glocal += or_glocal_rows

    gather_main = {name: k.launches - gather_timed[name]
                   for name, k in gather.KERNELS.items()}
    print(f"gather kernel launches on the main paths (phases 3-12, less "
          f"phase 4b's {gather_timed}): {gather_main} (expected 0 each)")
    if any(gather_main.values()):
        fail(f"a gather kernel launched on a main path: {gather_main}")

    # per beam step: the frontier select and the hit merge, one launch each;
    # the row's own times are those of align --engine beam's step, and
    # step_by_path has every path's at the widest shape it launched
    step = by_path["align"]
    sums = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_sector_ms")
    shapes += [r for r in compared.values() if r not in shapes]
    print(json.dumps({"kernels": [{
        "name": "select_topk", "route": "cuda",
        "source": "hsa_tpu_torch/csrc/select_topk.cu",
        "replaces": "hsa_tpu/kernels/select.py:51",
        "launches": launches + pe_select + pp_select + ladder_select
        + tp_select + pg_select + shard_select + sum(api_select.values())
        + sum(or_select.values()),
        "launches_by_path": {"align": launches, "align-pe": pe_select,
                             "align-pe --engine auto": pp_select,
                             f"align --ladder {LADDER}": ladder_select,
                             "aln (x2 on phase 7a's pairs, once on phase "
                             "8's reads)": tp_aln_launches,
                             "align --engine auto": pg_select,
                             "repeat path (align_stream)": repeat_select,
                             "sharded beam (phase 10b's ranks, all worlds)":
                             shard_select, **api_select, **or_select},
        "launches_per_batch": {"align": launches // len(batches),
                               "align-pe": pe_select // len(pe_batches)},
        "pigeon_fractions": fractions,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": sum(s["ms"] for s in step),
        "plain_ms": sum(s["plain_ms"] for s in step),
        "bound_ms": sum(s["bound_ms"] for s in step),
        "bound_sector_ms": sum(s["bound_sector_ms"] for s in step),
        "bound_by": step[0]["bound_by"],
        "library_ms": sum(s["library_ms"] for s in step),
        "ms_per": "one beam step: frontier select + hit merge",
        "step_by_path": {
            path: dict({k: sum(r[k] for r in rows) for k in sums},
                       shapes=[r["shape"] for r in rows])
            for path, rows in by_path.items()},
        "shapes": shapes}, {
        "name": "glocal_screen", "route": "cuda",
        "source": "hsa_tpu_torch/csrc/glocal_screen.cu",
        "replaces": "hsa_tpu/kernels/sw.py:114",
        "launches": pe_glocal + pp_glocal + tp_glocal
        + sum(or_glocal.values()),
        "launches_by_path": {"align-pe": pe_glocal,
                             "align-pe --engine auto": pp_glocal,
                             "sampe": tp_glocal, **or_glocal},
        "launches_per_batch": {"align-pe": pe_glocal // len(pe_batches),
                               "align-pe --engine auto":
                               pp_glocal // len(pp_batches),
                               "sampe": tp_glocal // len(tp_met["batches"])},
        "max_abs_err": max(g["max_abs_err"] for g in glocal),
        "ms": glocal[0]["ms"], "plain_ms": glocal[0]["plain_ms"],
        "bound_ms": glocal[0]["bound_ms"],
        "bound_ops11_ms": glocal[0]["bound_ops11_ms"],
        "host_ms": glocal[0]["host_ms"],
        "bound_by": glocal[0]["bound_by"], "library_ms": None,
        "native_ms": glocal[0]["native_ms"],
        "ms_per": "one screen of all rescue jobs",
        "shape": glocal[0]["shape"], "shapes": glocal},
        *gather_rows_json(probe_launches, probe_rows, main_table,
                          gather_main)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
