#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (firedancer_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc (one process per source,
started together), holds each against its plain PyTorch version on the
card, runs every Wycheproof and malleability vector through the kernel
path, then drives the port's paths at bench.py's shape (8192 lanes x
1232-byte messages), each with the launch counts set to 0 just before it
and read just after:

  strict    phases 6-7: `verify_batch` (SHA-512's in-place entry
            `sha512_ram` with the prechecks, then the verify kernel), and
            the verify tile (synth -> shm ring -> VerifyTile(batch=2048)
            -> out ring);
  RLC       phase 8c: `rlc_verify_batch` on valid, forged, structurally
            masked and torsion batches (phases 8a-8b hold the two MSM
            kernels to their plain versions on every lane class, stage 2
            at 128, 32 and 79 blocks; 8d times them at 8192 and 2048
            lanes);
  flood     phase 9: the front door, VerifyTile(mode="bulk_prefilter",
            coalesce_us=150000) on forged-flood chunks, a mix with 256
            valid txns, and torsion forgeries;
  topology  phases 10a-10b: firedancer_tpu_torch/cfg/sigverify.toml
            booted by the topology launcher, synth -> verify -> dedup ->
            sink as four tile processes over shm (65,536 frames, 256
            unique), then the same with mode="bulk_prefilter" (16,384
            frames, the verify tile booted onto a full ingest ring, the
            saturation under which the prefilter runs): the verify tile
            runs the kernels in its own process, so its batch counts
            stand for their launches; each prints the record bench.py's
            _e2e_run prints; 10c runs 10a's topology as bench.py's
            _e2e_run runs it by default, with the fdprof sampler at 29 Hz
            on every tile, and prints its record with e2e_profile (every
            tile's region holds samples, the verify tile's top frames
            name its poll, no kernel loaded after the warmup);
  execution phases 11-12: the leader's execution leg. 11 holds the
            wave-scan kernel (csrc/wave_scan.cu) to its plain version,
            and times it, at five shapes (tools/wave_bench.py): bank0's
            wave at bench.py's shape (8 microblocks x 31 synth
            transfers from 16 signers: one warp, the table resident in
            shared memory), the wave the bank launches in phase 12 (4 x
            12), a random block of 4096 transfers over 768 accounts with
            u64 edge values (the table through the ring of slots),
            16,384 transfers over 40,000 accounts (the balances in
            device memory) and bank0's table with every lane inactive
            (the bare chain of waits and barriers); then it runs the
            pipelined WaveExecutor (stage k+1 before finalize k) against
            the serial oracle; 12 boots
            firedancer_tpu_torch/cfg/leader.toml (bench.py's leader
            topology: synth -> verify x2 -> dedup -> pack -> bank0 ->
            poh -> shred <-> sign -> shredsink, nine kinds in eleven
            processes, verify and bank on the card, the verify shards
            pinned by bench.py's rule, cpu0 = 1 when os.cpu_count() >=
            shards + 6, each shard's affinity checked),
            waits until all 4096 frames are accounted for by bench.py's
            conservation rule and prints the leader rate (bench.py's
            e2e_leader_tps); then drains the shred leg and holds
            shredsink's frames to the shreds made, the signed roots to
            the FEC sets, and every mirrored shred to its set's root and
            signature; the bank counts its own kernel launches;
  hashes    phases 13-16: the device ops of the shred leg and of the
            follower's replay and bank hash. 13: the SHA-256 kernel ==
            plain == hashlib at 8192 rows of 0-1296 bytes, at widths 1296
            and 1297 (one staging path for every width and alignment),
            then bmtree_root over 64 shred-sized trees and the merkle
            leaves of a 32:32 FEC set (the Shredder's parity from
            ops/reedsol on the card) through the kernel, each launch of
            theirs also == plain and timed; 14: poh_verify_entries on
            one slot at mainnet's 12,500 hashes a tick against the host
            chain, and kernel == plain at cfg/leader.toml's 64, each
            beside its chain floor and its one-warp issue floor; 15: the
            BLAKE3 kernel's two entries == plain at 4096 lanes of 0-2048
            bytes and at the bank hash's 4096 lanes of 81 (== blake3_ref
            on 512), each timed by a CUDA graph; 16: Reed-Solomon encode and
            recover on the card (torch.matmul, no hand-written kernel) at
            64 sets of 32:32 over the shredder's RS region;
  follower  phase 17: the follower's check. 17a runs phase 12's mirrored
            wires through the port's ShredRecoverCore and ReplayCore on
            the card (each launch of poh_verify and lthash held to its
            plain version, the median and largest timed by a CUDA graph)
            and on the CPU: every slot's bank hash and PoH tip equal, no
            PoH failure; a flipped entry hash is a PoH failure; FEC sets
            that lost as many data shreds as they have parity shreds
            recover into the same slices. 17c prints the record. (17b,
            cfg/leader_follower.toml booted on the card, was cut for the
            script's time: phase 24's leader -> shred -> recover ->
            replay tile path holds it, the replay's block frames to a
            CPU replay of the leader's mirrored wires.)
  faults    phase 18: the main path's fault drills and flight recorder.
            18a drives VerifyTile(batch=2048) in process on phase 7's
            frames with a chaos plan: two injected dispatch failures
            are absorbed by the retries, each verdict wait spinning on
            its event under a deadline (device_errors 2, cpu_fallback
            0, the same frames out as phase 7); a persistent failure
            makes poll_once raise after the retries, with nothing
            published (the port has no CPU path on the card's behalf:
            the stem marks such a tile FAIL and the supervisor restarts
            it, as 18c shows for the sink). 18b boots
            cfg/sigverify.toml at full width (65,536 frames) with [trace]
            on, reports its e2e_tps beside 10a's, and exports the rings
            with `python -m firedancer_tpu_torch.trace`: tpu_dispatch
            spans on verify, each unique frame's lineage verify -> dedup
            -> sink, the per-link summary. 18c boots
            firedancer_tpu_torch/cfg/chaos.toml on the card: its sink
            crashes at rx 32, the supervisor dumps the sink's ring (the
            crash, then its death) to the black box and respawns it once,
            every unique txn passes dedup, and every tile halts cleanly.
            Every verify tile outside 18a's drills must end with
            cpu_fallback 0 and device_errors 0.
  front     phase 19: the front door. 19a holds gossip/gossvf.py's
            packets of 1, 2, 7, 18, 32 and 33 CRDS values (valid, forged,
            torsion-malleated, unsigned) on the card to the plain
            versions in both modes, and times a packet a mode
            (tools/gossvf_bench.py); 19b runs three gossip tiles with
            device_verify and gossvf_bulk over UDP on localhost until
            they converge, then 512 flood_crds_spam datagrams and 16
            forged ones into one (its peer table at most 64, a staked
            origin's later value lands); 19c boots
            firedancer_tpu_torch/cfg/flood.toml (sock -> verify
            bulk_prefilter -> dedup -> sink) twice, as bench.py's
            _flood_bench does: first without the metric tile, with a
            staked sender that keeps the ring ahead of verify full of
            distinct valid txns (its bucket raised), whose goodput is the
            door's clean capacity, then on the same boot the clean
            reference at 0.33x that capacity (capped by the staked
            pool); then as written, its metric tile's SLO engine judging
            sink.rx rate > 0.8x the reference, with a staked paced sender
            at the reference's rate: the engine sees the floor held, a
            4 s baseline, then 24 unstaked Sybil sockets send forged
            frames at 4x the capacity for 4 s while the breach ticks are
            counted, then up to 30 s for a breach to clear: the door
            sheds unstaked frames, the prefilter runs, every staked txn
            is at the sink or covered by a counted drop (the door's,
            the host's before the door under the flood, counted as the
            datagrams sent less those the door read, or a chunk the
            prefilter shed), no forged frame past verify,
            peers <= 64, no watchdog trip, the door in overload whenever
            the engine reads a breach; bench.py's flood_* keys and
            flood_pass are printed, not gated. A pool of worker
            processes signs 19c's txns and runs 19a's plain versions
            while the card runs 19a and 19b.
  execution phase 20: the exec tile family over the shm account store.
  scaled    20a runs tools/exec_drills.py in process with every shard
  out       on the card: the bank's fan-out over two exec tiles gives
            the poh frames, done frags and balances of the in-process
            bank on the CPU's plain wave scan;
            no account key is in two shards' dispatch frames; a shard
            dead at dispatch makes the bank cancel and redispatch the
            wave (exec_redispatch, stale_xid) and balances come out
            exactly once; ReplayCore over ExecFanout and two shards
            gives the bank hash of InlineFanout on the CPU (plain wave
            scan and lthash) in each of 64 slots, and every account
            execute_block_serial's balance. 20b is
            bench.py's exec-scale stage (tools/exec_scale.py: synth ->
            verify x2 -> dedup -> resolv -> pack -> bank0 -> exec x N ->
            bank0 -> poh -> shred <-> sign -> shredsink, less core
            pinning) at N = 1, 2 and 4, 4096 frames unpaced, one boot
            each, timed from RUN to drained: exec_scale_tps, the
            saturating hop, every shard's txns and wave_launches, the
            bank's exec_waves and exec_redispatch, each N exact on its
            counts and every account in the shm store equal to
            execute_block_serial's over the frames synth sent. 20c boots firedancer_tpu_torch/cfg/exec.toml with
            exec0 crashing at its first frames under a restart policy:
            it restarts, the loop drains, the store's lamports are
            genesis's less the fees, every tile exits 0.
  observe   phase 21: the breach-triggered device capture.
            cfg/sigverify.toml with [prof] (47 Hz, 200 ms windows,
            breach_capture verify), an [slo] target that cannot hold
            (verify.work p99 < 1ns), a metric tile and a paced synth
            whose replays reach the card: the breach rings the verify
            tile's doorbell, its housekeeping opens a torch.profiler
            window around its own launches and acks; the manifest names
            sha512_kernel and ed25519_verify_kernel, the ring holds
            EV_PROF_CAPTURE and EV_COMPILE, /metrics, /healthz and
            /summary.json answer, the monitor recovers the breach, and
            the merged bundle puts the kernels beside the host slices;
            the card's busy share over the window is reported.
  cold      phase 22: the cold-start follower (tools/catchup.py).
  start     22a (only where the `zstandard` package imports; else
            snapdc and snapin format="archive" must refuse to boot,
            naming it, and only the fold below runs over the same
            accounts): 2^20 accounts from the seed (system accounts
            and 165-byte token-sized ones) written by
            write_snapshot_archive (its manifest's lattice on the card)
            and streamed through SnapLoader -> SnapDecompress ->
            ArchiveInserter on rings: lattice_ok, every account
            restored, the fold == the plain version's (and 4096 lanes
            one by one), an archive of 2048 accounts with one lamport
            flipped refused with nothing installed; the fold's launches
            timed with CUDA events beside their bound. 22b: bench.py's
            catch-up stage at its defaults (snapld -> snapin into the
            shm store, playback -> replay behind its restore gate over
            two exec shards): restore slot 4, no divergent slot, every
            replayed bank hash and every store account == the CPU
            oracle's, wave scans in both shards and lthash in the
            replay. 22c: the same with 2^17 funded accounts in the
            snapshot, the restore split (snapin's restore, the gate's
            store read and fold) and the gate's fold timed. 22d: the
            drills: corrupt_checkpt_frame and stale_snapshot_offer
            refused with the store untouched, crash_mid_snapshot on a
            supervised snapld (restarted, the stream from byte 0,
            restored) and on the replay's writer (the previous file
            intact, the .tmp refused), and the bank booted from a
            genesis_ckpt == booted from its dict.
  general   phase 23: general execution (tools/general_exec.py). 23a
            boots firedancer_tpu_torch/cfg/general.toml (sock -> verify
            x2 -> dedup -> pack -> bank0 exec="general" -> poh -> shred
            <-> sign -> shredsink) over a genesis of 512 validators
            (vote and stake accounts), 16 lookup tables, 256 users and
            four deployed sBPF programs (tools/sbpf_family.py), and
            sends 4,942 signed txns (4,104 votes, transfers, stake, ALUT
            and precompile txns, 11 loader v3 txns: a deploy sequence,
            an Upgrade, a SetAuthority and a Close; 384 sBPF invocations
            and three failing ones; 22 designed failures) to the
            sock door, draining after each slot of the deploy sequence:
            door rx = sent, every txn executed, failed or a counted
            drop, exec_fail = the CPU oracle's = 22, rewards paid,
            bank0's store == the plain general path over the microblocks
            it took, the sBPF family's own arithmetic on bank0's store
            (vault PDAs' and recipients' lamports, the programdata of
            the deployed and upgraded programs byte for byte, the
            consumed buffers) and on each of its txns' status, return
            data and log, no verify fallback, every tile exits 0; the
            host's us a txn and a CU by program. 23b replays the whole
            workload, v0 through the tables included, in process on the
            card and on the CPU: every slot's bank hash and every
            account equal, the sBPF arithmetic on both, poh_verify and
            lthash launched. 23c holds those launches to their plain
            versions and times lthash at a vote-heavy slot delta.
  voting    phase 24: the two-node cluster (tools/cluster.py). The
  non-      leader, firedancer_tpu_torch/cfg/leader.toml +
  leader    cfg/cluster.toml at full width, sends its turbine over UDP
            to cfg/nonleader.toml and withholds every fourth slot; the
            non-leader repairs each from the leader's serve-only repair
            tile, replays on the card (poh_verify, lthash) and its tower
            -> send -> sign tiles emit TowerSync votes to this process.
            Waits on metrics only; every block frame's bank hash ==
            a CPU replay of the leader's mirrored slices, every executed
            txn replayed, every vote signed by the non-leader (the
            strict verify on the card and ed25519_ref) for a replayed
            slot's bank hash.
  cluster   phase 25: a cluster from nothing (tools/cluster.py with a
  from      genesis). The port's app.genesis CLI writes the demo's
  nothing   genesis (1 validator, 16 users); firedancer_tpu_torch/cfg/
            follower.toml restores it (snapld -> snapin into the shm
            store as slot 0; the replay's restore gate folds it on
            lthash) and app.dev's leader (cfg/leader.toml with the
            genesis in bank0) + cfg/cluster.toml at full width, no slot
            dropped, sends it turbine; the follower replays on the card
            over two exec shards (wave scan), snapshots every 64 slots
            and votes. Waits on metrics only; snapin restored slot 0;
            every txn the leader executed after slot 0 replayed ok (the
            restore slot is never replayed, as in the reference); every
            block frame's bank hash == the port's CPU replay of the
            leader's mirrored slices from the same checkpoint; every vote
            signed by the follower for a replayed slot's bank hash; the
            replay's last snapshot (a multiple of 64) == that CPU
            replay's store at its slot, under its block frame's hash.

Phase 3 holds both SHA-512 entries to their plain versions (3b: every
precheck class, at two row widths: the kernel's two copy paths);
phase 6a times them and the verify kernel, at 8192 and 2048 lanes; phase
2 prints ptxas's registers, stack and shared memory per entry point.
Any mismatch raises. The last line of output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

and the line before it a JSON object with each of the nine kernels'
launches on the paths (phase 19's in process among them, and the
wave scans of phase 20's exec shards; the topology phases' verify
batches, and the launches phase 21's capture recorded), error against
its plain version, time, plain time and bound (poh_verify and lthash
also at the replay's own shapes, lthash at phase 22's restore shapes;
phase 22's wave scans and lthash launches are counted in, phase 23's
poh_verify and lthash, phase 24's leader's verify batches and wave
scans and its non-leader's poh_verify and lthash, and phase 25's, each
node's also in `follower_launches`; lthash also at phase 23c's
vote-heavy slot delta).
Without a CUDA card it exits 2 and prints no result. No JAX is used.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# torch is imported by main(), not here: every tile process the script
# spawns imports this file first, and a tile that runs no kernel boots
# without torch
torch = None

B = 8192                 # bench.py kernel batch
MSG_LEN = 1232           # protocol MTU: bench.py msg_len
TILE_BATCH = 2048        # bench.py e2e tile batch
TILE_UNIQUE = 256
TILE_CORRUPT = 1024
TILE_FRAMES = 16384
FLOOD_CHUNKS = 4          # all-forged chunks of TILE_BATCH frames (phase 9)
FLOOD_MIX_FORGED = 248    # forged frames after the 256 valid ones
TOPO_FRAMES = 65536       # phase 10a: cfg/sigverify.toml's synth count
TOPO_PREFILTER_FRAMES = 16384   # phase 10b, bulk_prefilter
E2E_PROF_HZ = 29.0        # phase 10c: bench.py's default FDTPU_BENCH_PROF_HZ
TRACE_DEPTH = 1 << 17     # phase 18b: records a tile ring (a 65,536-frame run)
PERSISTENT = {"events": [{"action": "fail_dispatch", "count": -1}]}
LEADER_FRAMES = 4096      # phase 12: cfg/leader.toml's synth count
PIPE_WAVES = 4            # phase 11: bank waves through the pipeline
# the wave scan's integer operations per active lane (the u64 need, two
# u64 compares, the charge select and subtract, the credit and the
# status: each u64 step as two 32-bit operations) and per account slot
# (the 64-bit load and store of the balance halves)
WAVE_OPS_PER_LANE = 20
WAVE_OPS_PER_ACCT = 4
ITERS = 20
N_UNIQUE = 256          # distinct signatures behind the 8192 lanes
DEVICE = "cuda"

# Least-time model (see PERF.md "Port: PyTorch/CUDA on H100"): the H100
# SXM's INT32 rate, 132 SMs x 64 INT32 lanes x 1.98 GHz boost, and its
# HBM3 rate of 3.35 TB/s.
CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * CLOCK_HZ
BYTES_PER_S = 3.35e12
# SHA-512, 32-bit instructions per 128-byte block at the fewest the
# algorithm allows on this ISA: a round is Sigma1 + Sigma0 (3 funnel-
# shift rotates of a 64-bit word, 6 SHF, and one LOP3 xor3 per half:
# 8 each), ch and maj (one LOP3 per half: 2 each), t1 (a 5-term 64-bit
# sum, 4 IADD3), e = d + t1 and a = t1 + Sigma0 + maj (2 each) = 28; a
# schedule word is sigma0 + sigma1 (8 each) and a 4-term sum (4) = 20;
# the state update is 8 64-bit adds (16).
SHA_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 16
# A field multiply is 100 32x32->64 products summed in int64: two INT32
# operations each. Adds, carries and table loads are not counted, so the
# bound stays below the true least time.
OPS_PER_FIELD_MUL = 200
# MSM stage 1's scalar work per lane, in int64 multiplies: sc_reduce64
# (14 folds of 6 and a final 6: 90) of k64, and sc_mul_mod_l of z k and
# z S (91 digit products and a sc_reduce64 each), counted at 4 INT32
# operations an int64 multiply.
SCALAR_OPS_PER_LANE = 4 * (90 + 2 * (91 + 90))
# SHA-256, 32-bit instructions per 64-byte block at the fewest this ISA
# allows: a round is Sigma1 and Sigma0 (3 funnel-shift rotates and one
# LOP3 xor3 each: 8), ch and maj (one LOP3 each: 2), t1 (a 5-term sum, 2
# IADD3), e = d + t1 and a = t1 + Sigma0 + maj (2) = 14; a schedule word is
# sigma0 and sigma1 (2 rotates, a shift and a LOP3 each: 8) and a 4-term
# sum (2) = 10; the state update is 8 adds.
SHA256_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8
# PoH's chain floor: a round's e = d + t1 hangs on the round before's e
# through three dependent instructions (the Sigma1 rotates, their LOP3
# xor3, the IADD3 of t1 and d), and an entry's rounds run one after the
# other; at one cycle an instruction an entry's rounds take at least 3
# cycles each at the boost clock. The card cannot reach it: a dependent
# instruction waits 4.4-4.6 clocks for its operand, and one warp's ALU
# instructions (a round's rotates and LOP3s) issue one every 2.09 clocks
# on its sub-partition's 16 INT32 lanes (tools/pipe_bench.cu on an
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6). The issue floor beside it
# (`issue_floor`) counts the SASS instructions the round warp issues.
SHA256_ROUND_CHAIN_OPS = 3
SHA256_B = 8192          # phase 13: rows of lengths 0-1296
SHA256_WIDTH = 1296
BMTREE_TREES = 64        # phase 13: shred-sized trees (a 32:32 FEC set)
BMTREE_LEAVES = 64
POH_TICKS = 64           # phase 14: one slot at mainnet's settings
POH_HASHES_PER_TICK = 12500   # Solana genesis hashes_per_tick
POH_SMALL_HASHES = 64    # cfg/leader.toml's hashes_per_tick
BLAKE3_B = 4096          # phase 15: lanes of lengths 0-2048, and of 81 bytes
RS_SETS = 64             # phase 16: 32:32 sets over the shredder's RS region
SMALL_B = TILE_BATCH     # the second timed size: the tile's chunk
RAGGED_B = 5000          # stage 2 at 79 blocks, the last chunk ragged
GOSSVF_ITERS = 20        # phase 19a: packets timed a mode and size
GOSSIP_SPAM = 512        # phase 19b: flood_crds_spam datagrams
GOSSIP_FORGED = 16       # phase 19b: spam datagrams with a forged value
# phase 19c, bench.py's flood stage defaults (bench.py:1150-1155):
# FDTPU_BENCH_FLOOD_MULT and _SYBILS; the attack runs 4 s, not bench.py's
# 8 (FDTPU_BENCH_FLOOD_S): over 8 s the swarm's four processes, sharing
# the host's eight cores with the tiles, once sent under 4x the capacity
FLOOD_MULT = 4.0
FLOOD_SYBILS = 24
FLOOD_ATTACK_S = 4.0
# 19c's capacity boot: the saturating sender's fill and window, its pool
# of distinct valid txns (the window's frames at the card's capacity
# with room to spare), and the least share of the window's lanes that
# must come in full gathers for the run to count as saturated
FLOOD_CAP_FILL_S = 0.5
FLOOD_CAP_S = 1.5
FLOOD_CAP_MIN_S = 0.5
FLOOD_CAP_POOL = 16000
FLOOD_CAP_FULL = 0.9
# 19c's clean reference and SLO judge (bench.py:1211-1330): the staked
# rate as a share of the capacity, capped by the staked pool over the
# seconds the staked sender runs (boot 1's settle and reference, boot
# 2's settle, baseline and attack, and FLOOD_STAKED_SLACK_S for the SLO
# wait and a breach's clearing: a boot breach took 17 s to clear on the
# card, its slow window full of the boot's samples; bench.py's cap allows
# 120 s of a longer protocol); the fast window by bench.py's rule (4 s
# on a host of four cores or more, against its 8 s attack) cut with the
# attack, so that a breach can fire inside it; and bench.py's longest
# waits
FLOOD_CLEAN_SHARE = 0.33
FLOOD_STAKED_POOL = 32000
FLOOD_REF_SETTLE_S = 2.0
FLOOD_REF_S = 4.0
FLOOD_SLO_FAST_S = (4.0 if (os.cpu_count() or 1) >= 4 else 8.0) \
    * FLOOD_ATTACK_S / 8.0
FLOOD_SLO_WAIT_S = 30.0
FLOOD_BASELINE_S = 4.0
FLOOD_CLEAR_S = 30.0
FLOOD_SLO_SETTLE_S = FLOOD_SLO_FAST_S + 1.0
FLOOD_TRIP_S = 0.5            # a breach read -> the door in overload
FLOOD_STAKED_SLACK_S = 30.0
FLOOD_PROTOCOL_S = (FLOOD_REF_SETTLE_S + FLOOD_REF_S + FLOOD_SLO_SETTLE_S
                    + FLOOD_BASELINE_S + FLOOD_ATTACK_S
                    + FLOOD_STAKED_SLACK_S)
# 19c's attack boot: the swarm's worker processes (one interpreter caps a
# Python sender near the rate needed; four sent 28,525/s against 4 x a
# capacity of 7,768 on one host, so six share it), and how far above
# FLOOD_MULT x the capacity it is paced so that what it sends is at least
# that
EXEC_SCALE_CNTS = (1, 2, 4)   # phase 20b: bench.py's exec_tile_cnt sweep
EXEC_REPLAY_SLOTS = 64    # phase 20a: the replay fan-out's slots
EXEC_REPLAY_PER_SLOT = 4  # transfers a slot
FLOOD_SWARM_PROCS = 6
FLOOD_PACE_OVER = 0.05
# phase 21: the synth's pace, frames (it runs on through the capture;
# the phase halts once the capture is acked) and unique pool, larger than
# the verify tile's in-flight window (CAPTURE_BATCH lanes x
# (FDTPU_VERIFY_INFLIGHT + 1)) so that a replay is never deferred behind
# its own first copy (the synth signs the pool at boot with the
# pure-Python signer: 8192 took minutes, so the batch is cut from the
# file's 2048); bench.py's leader tcache depth for that pool (max(16, 1
# << (bit_length(unique) - 4)), bench.py:434-442), so replays are
# verified again; and the trace ring that keeps the verify tile's boot
# records
CAPTURE_RATE_TPS = 50000.0
CAPTURE_FRAMES = 1 << 20
CAPTURE_BATCH = 256
CAPTURE_UNIQUE = 1024
CAPTURE_TCACHE = max(16, 1 << (CAPTURE_UNIQUE.bit_length() - 4))
CAPTURE_TRACE_DEPTH = 1 << 18
# phase 22: the real-format restore's accounts (22a) and the tamper
# drill's smaller archive, the snapshot of 22c (a mainnet snapshot's
# order of 10^9 accounts cut to 2^17 for the script's time: 2^18 until
# phase 25 came; PERF.md section 4), the lanes held one by one to the
# plain version, and the seed
COLD_ARCHIVE_ACCOUNTS = 1 << 20
COLD_TAMPER_ACCOUNTS = 2048
COLD_STATE_ACCOUNTS = 1 << 17
COLD_SAMPLE = 4096
COLD_SEED = 22


T_START = time.perf_counter()


def log(*a):
    """Print a line; a phase's header line ("== ...") carries the script's
    seconds so far."""
    if a and str(a[0]).startswith("== "):
        a = (f"== [{time.perf_counter() - T_START:.1f} s]"
             + str(a[0])[2:],) + a[1:]
    print(*a, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, CUDA events around the run."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def signed_batch(n_unique: int, n: int, msg_len: int, seed: int):
    """n lanes tiled from n_unique RFC 8032 signatures over random
    msg_len-byte messages (the pure-Python signer is slow, so keys and
    messages repeat). -> sig (n,64), pub (n,32), msg (n,msg_len) uint8,
    msg_len (n,) int32."""
    from firedancer_tpu_torch.utils import ed25519_ref as ref
    rng = np.random.default_rng(seed)
    sig = np.zeros((n_unique, 64), np.uint8)
    pub = np.zeros((n_unique, 32), np.uint8)
    msg = rng.integers(0, 256, (n_unique, msg_len), np.uint8)
    for i in range(n_unique):
        key = rng.bytes(32)
        pub[i] = np.frombuffer(ref.keypair(key)[2], np.uint8)
        sig[i] = np.frombuffer(ref.sign(key, msg[i].tobytes()), np.uint8)
    idx = np.arange(n) % n_unique
    return (sig[idx].copy(), pub[idx].copy(), msg[idx].copy(),
            np.full(n, msg_len, np.int32))


def corrupt(sig, pub, msg):
    """Mixed verdict pattern by lane % 8: 0, 5 valid; 1 R, 2 S, 3 msg,
    4 A flipped; 6 S = l + 5 (>= l); 7 small-order A. -> expected strict
    verdicts (B,) bool."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    kind = np.arange(len(sig)) % 8
    sig[kind == 1, 0] ^= 1
    sig[kind == 2, 32] ^= 1
    msg[kind == 3, -1] ^= 0x80
    pub[kind == 4, 0] ^= 1
    sig[kind == 6, 32:] = np.frombuffer((ed.L + 5).to_bytes(32, "little"),
                                        np.uint8)
    pub[kind == 7] = ed._small_order_encodings()[1]
    return (kind == 0) | (kind == 5)


def k64_of(sig, pub, msg, ln):
    return np.stack([np.frombuffer(hashlib.sha512(
        sig[i, :32].tobytes() + pub[i].tobytes()
        + msg[i, :ln[i]].tobytes()).digest(), np.uint8)
        for i in range(len(sig))])


def count_field_muls(fn, *args):
    """(fn(*args), the field multiplies it performed): a plain version
    computes every product with fe25519.mul on (..., 10) limb tensors,
    and a kernel performs the same sequence, so the count is the number
    of limb rows multiplied."""
    from firedancer_tpu_torch.ops import fe25519 as fe
    count, mul = [0], fe.mul

    def counted(f, g):
        count[0] += int(np.prod(torch.broadcast_shapes(f.shape, g.shape)[:-1]))
        return mul(f, g)
    fe.mul = counted
    try:
        out = fn(*args)
    finally:
        fe.mul = mul
    return out, count[0]


def field_muls_per_verify() -> int:
    """Field multiplies of one verify, counted on the plain version over
    one lane on the CPU."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops.params import fixed_base_tables
    sig, pub, msg, ln = signed_batch(1, 1, 32, 99)
    k64 = torch.from_numpy(k64_of(sig, pub, msg, ln))
    return count_field_muls(ed.verify_core, torch.from_numpy(sig),
                            torch.from_numpy(pub), k64,
                            fixed_base_tables("cpu"))[1]


def stats_of(ms, plain_ms, ops, nbytes) -> dict:
    """A kernel's time beside its bound: the larger of INT32 operations
    over the INT32 rate and bytes over the memory rate."""
    ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops=ops, bytes=nbytes, ops_ms=ops_ms, bytes_ms=bytes_ms)


def run_tile(waves, depth, trace=False, **kw):
    """synth -> shm ring -> VerifyTile(batch=TILE_BATCH, **kw) -> out ring,
    in process: each wave of frames is published, then polled through and
    flushed before the next (phase 18a's waves are one dispatch each).
    -> (out-ring payloads, metrics, decoded trace events, seconds of
    polling each wave)."""
    from firedancer_tpu_torch.runtime import (Ring, Tcache, TraceRing,
                                              Workspace)
    from firedancer_tpu_torch.tiles.synth import SynthTile
    from firedancer_tpu_torch.tiles.verify import VerifyTile
    from firedancer_tpu_torch.trace import TraceWriter, events
    w = Workspace(f"/fdtt_smoke_{os.getpid()}", 1 << 26)
    try:
        in_ring = Ring.create(w, depth=depth, mtu=1280)
        out_ring = Ring.create(w, depth=1024, mtu=1280)
        tr = TraceWriter(TraceRing.create(w, 1024)) if trace else None
        tile = VerifyTile(in_ring, out_ring, Tcache(w, depth=4096),
                          batch=TILE_BATCH, device=DEVICE, trace=tr, **kw)
        secs = []
        for wave in waves:
            SynthTile(in_ring, wave).run(len(wave))
            t0 = time.perf_counter()
            while tile.poll_once():
                pass
            tile.flush()
            secs.append(time.perf_counter() - t0)
        out, seq = [], 0
        while True:
            rc, frag = out_ring.consume(seq)
            if rc != 0:
                break
            out.append(bytes(out_ring.payload(frag)))
            seq += 1
        evs = [events.decode(r) for r in tr.ring.snapshot()[1]] if tr \
            else []
    finally:
        w.close()
        w.unlink()
    return out, dict(tile.metrics), evs, secs


def no_fallback(where: str, m: dict):
    """The gate of every verify tile outside phase 18a's drills: no device
    error and no CPU fallback."""
    assert m["cpu_fallback"] == 0 and m["device_errors"] == 0, \
        f"{where}: cpu_fallback {m['cpu_fallback']}, device_errors " \
        f"{m['device_errors']}"


def trace_report(root, runner, unique: int) -> dict:
    """Phase 18b's reads of a traced run after its halt: `python -m
    firedancer_tpu_torch.trace` exports the rings (the summary, and the
    Chrome JSON, which holds tpu_dispatch spans on verify); each unique
    frame's lineage crosses verify -> dedup -> sink; the verify tile's
    WORK spans and each link's per-hop latency."""
    import tempfile
    from firedancer_tpu_torch import trace as ftrace
    name = runner.plan["topology"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        r = subprocess.run(
            [sys.executable, "-m", "firedancer_tpu_torch.trace", name,
             "--out", path], cwd=root, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=root), timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        with open(path) as f:
            doc = json.load(f)
    log(r.stdout.rstrip())
    tids = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
            if e.get("name") == "thread_name"}
    dispatch = [e for e in doc["traceEvents"] if e.get("ph") == "X"
                and e["name"] == "tpu_dispatch"
                and e["tid"] == tids["verify"]]
    assert dispatch, "18b: no tpu_dispatch span on verify"
    evs = ftrace.read_rings(runner.plan, runner.wksp)
    for tn, e in evs.items():
        assert e[0]["_cursor"] <= TRACE_DEPTH, f"18b: {tn}'s ring wrapped"
    hops = [("verify", "publish"), ("dedup", "consume"),
            ("dedup", "publish"), ("sink", "consume")]
    per_link: dict = {}
    through = 0
    for chain in ftrace.lineage(evs).values():
        seen = [(tn, n) for _, tn, n, _ in chain]
        if all(h in seen for h in hops):
            through += 1
        pub = None
        for ts, _, n, link in chain:         # as export.summary counts
            if n == "publish":
                pub = ts
            elif n == "consume" and pub is not None and link:
                per_link.setdefault(link, []).append(ts - pub)
    assert through == unique, f"18b: {through} of {unique} frames lineaged"
    work = [e for e in evs["verify"] if e["ev"] == "work"]
    ns = [e["arg"] for e in work]
    k = int(np.argmax(ns))
    return {
        "verify_work_spans": len(work),
        "verify_first_work_ms": ns[0] / 1e6,
        "verify_max_work_ms": ns[k] / 1e6,
        # which productive poll it was, and the frags it consumed
        "verify_max_work_poll": k + 1,
        "verify_max_work_frags": work[k]["count"],
        "verify_work_ms": sum(ns) / 1e6,
        "tpu_dispatch_spans": len(dispatch),
        "tpu_dispatch_p50_ms": float(np.percentile(
            [e["dur"] for e in dispatch], 50)) / 1e3,
        "lineaged": through,
        "link_us": {ln: {"frags": len(v),
                         "p50": float(np.percentile(v, 50)) / 1e3,
                         "p99": float(np.percentile(v, 99)) / 1e3,
                         "max": max(v) / 1e3}
                    for ln, v in sorted(per_link.items())},
        "events": {tn: len(e) for tn, e in evs.items()}}


def run_chaos_drill(root, tag):
    """Phase 18c: firedancer_tpu_torch/cfg/chaos.toml on the card. Waits
    until the synth has published its frames, dedup has passed every
    unique txn and the sink, crashed by its plan at rx 32, is back; then
    reads the black box and halts. -> record."""
    from firedancer_tpu_torch import trace as ftrace
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    from firedancer_tpu_torch.trace.events import CHAOS_ACTION_IDS
    cfg = load_config(
        os.path.join(root, "firedancer_tpu_torch", "cfg", "chaos.toml"),
        overrides={"tile": [{"name": "verify", "device": DEVICE}]})
    syn = next(t for t in cfg["tile"] if t["name"] == "synth")
    count, unique = syn["count"], syn["unique"]
    name = f"smoke{tag}{os.getpid()}"
    runner = TopologyRunner(build_topology(cfg, name=name).build())
    path = ftrace.blackbox_path(name, "sink")
    try:
        runner.start()
        runner.wait_running(timeout_s=300)
        t0 = time.perf_counter()
        deadline = time.time() + 300
        while True:
            runner.check_failures()
            s, d = runner.metrics("sink"), runner.metrics("dedup")
            if runner.metrics("synth")["tx"] >= count and \
                    d["tx"] >= unique and s["sup_restarts"] >= 1 and \
                    s["sup_down"] == 0:
                break
            assert time.time() < deadline, f"18c: sink {s}, dedup {d}"
            time.sleep(0.01)
        runner.wait_running(timeout_s=120)   # the respawned sink is up
        wall = time.perf_counter() - t0
        v = runner.metrics("verify")
        no_fallback("18c verify", v)
        assert (v["tx"], v["verify_fail"], d["tx"]) == (unique, 0, unique), \
            f"18c: verify {v}, dedup {d}"
        assert runner.supervisor.blackbox == {"sink": path}, \
            runner.supervisor.blackbox
        with open(path) as f:
            dump = json.load(f)
        tail = dump["events"][-2:]
        assert [e["ev"] for e in tail] == ["chaos", "down"] and \
            tail[0]["count"] == CHAOS_ACTION_IDS["crash"], tail
        time.sleep(0.3)
        runner.halt()
        for tn, proc in runner.procs.items():
            assert proc.exitcode == 0, f"18c: tile {tn} exit {proc.exitcode}"
        s = runner.metrics("sink")
        assert (s["sup_restarts"], s["sup_watchdog_trips"]) == (1, 0), s
        live = ftrace.read_rings(runner.plan, runner.wksp)["sink"]
        i = max(k for k, e in enumerate(live) if e["ev"] == "restart")
        assert live[i + 1]["ev"] == "boot" and live[-1]["ev"] == "halt" \
            and "chaos" not in [e["ev"] for e in live[i:]], \
            [e["ev"] for e in live[i:i + 4]]
        return {"count": count, "unique": unique, "wall_s": wall,
                "dedup_tx": d["tx"],
                "sup_restarts": s["sup_restarts"],
                "blackbox_reason": dump["reason"],
                "blackbox_events": len(dump["events"]),
                # the crash's record to the respawned sink's boot
                "recovery_ms": (live[i + 1]["ts"] - tail[0]["ts"]) / 1e6,
                "verify_batches": v["batches"]}
    finally:
        runner.halt()
        runner.close()
        if os.path.exists(path):
            os.unlink(path)


def run_topology(root, tag, count, verify_last=False, trace=None,
                 on_halted=None, prof=None, **verify):
    """Phase 10: boot the port's main path as four tile processes,
    firedancer_tpu_torch/cfg/sigverify.toml with `count` frames and the
    verify args `verify`, through app.config and TopologyRunner, with
    FDTPU_VERIFY_INFLIGHT=3. verify_last boots the verify tile only once
    the synth has filled the ingest ring (ingest saturation: its first
    gather is full, which opens the bulk prefilter's window). Waits
    until every tile runs, then until the sink has the unique frames and
    verify has taken all `count`, and every frame is accounted for;
    then halts the tiles and reads their flushed telemetry, each link's
    producer and consumer counts held to the frames that crossed it.
    -> (record as bench.py's _e2e_run prints it, verify metrics). Raises
    on a count mismatch, a dead tile or a timeout. `trace` and `prof` are
    [trace] and [prof] sections to run with; `on_halted(runner)` reads
    the halted topology before its workspace goes, and its result joins
    the record as "trace"."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    from firedancer_tpu_torch.disco.metrics import (
        link_lag, merge_hists, quantile_ns, read_hists, read_link_metrics)
    over = {"tile": [{"name": "synth", "count": count},
                     {"name": "verify", "device": DEVICE, **verify}]}
    if trace is not None:
        over["trace"] = trace
    if prof is not None:
        over["prof"] = prof
    cfg = load_config(
        os.path.join(root, "firedancer_tpu_torch", "cfg", "sigverify.toml"),
        overrides=over)
    unique = next(t["unique"] for t in cfg["tile"] if t["name"] == "synth")
    env0 = os.environ.get("FDTPU_VERIFY_INFLIGHT")
    os.environ["FDTPU_VERIFY_INFLIGHT"] = "3"
    runner = TopologyRunner(build_topology(
        cfg, name=f"smoke{tag}{os.getpid()}").build())
    try:
        t_boot = time.perf_counter()
        if verify_last:
            runner.start([tn for tn in runner.plan["tiles"]
                          if tn != "verify"])
            runner.wait_idle("synth", "tx", min(
                count, runner.plan["links"]["ingest"]["depth"]),
                timeout_s=300, poll_s=0.002)
            runner.start(["verify"])
        else:
            runner.start()
        runner.wait_running(timeout_s=300)
        t0 = time.perf_counter()
        runner.wait_idle("sink", "rx", unique, timeout_s=300, poll_s=0.002)
        runner.wait_idle("verify", "rx", count, timeout_s=300, poll_s=0.002)
        wall = time.perf_counter() - t0
        deadline = time.time() + 60
        while True:
            runner.check_failures()
            v, d = runner.metrics("verify"), runner.metrics("dedup")
            if d["tx"] + v["dedup_drop"] + d["dup"] == count:
                break
            assert time.time() < deadline, \
                f"frames unaccounted for: verify {v}, dedup {d}"
            time.sleep(0.01)
        snk = runner.metrics("sink")
        for key, got, want in (("sink.rx", snk["rx"], unique),
                               ("verify.rx", v["rx"], count),
                               ("verify.verify_fail", v["verify_fail"], 0),
                               ("verify.parse_fail", v["parse_fail"], 0),
                               ("dedup.tx", d["tx"], unique)):
            assert got == want, f"{key} = {got}, expected {want}"
        no_fallback(f"{tag} verify", v)
        assert v["batches"] > 0, "no strict dispatch in the verify tile"
        # every stem flushes its histograms and link counters on a clean
        # exit; the workspace stays until close(), so what is read below
        # is what the run did
        runner.halt()
        for tn, p in runner.procs.items():
            assert p.exitcode == 0, f"tile {tn} exit code {p.exitcode}"
        traced = on_halted(runner) if on_halted is not None else None
        budget = {}
        for tn in ("synth", "verify", "dedup", "sink"):
            h = read_hists(runner.wksp, runner.plan, tn)
            work, wait = h["work"], h["wait"]
            busy = work["sum_ns"] + wait["sum_ns"]
            budget[tn] = {
                "work_p50_us": quantile_ns(work, 0.50) / 1e3,
                "work_p99_us": quantile_ns(work, 0.99) / 1e3,
                "occupancy": work["sum_ns"] / busy if busy else 0.0}
        links = {}
        for ln, rec in read_link_metrics(runner.wksp, runner.plan).items():
            cons = rec["consumers"]
            h = merge_hists(c["hist"] for c in cons.values())
            links[ln] = {
                "pub": rec["pub"],
                "consumed": sum(c["consumed"] for c in cons.values()),
                "lost": sum(link_lag(rec, tn) for tn in cons),
                "backpressure": rec["backpressure"],
                "consume_p99_us": quantile_ns(h, 0.99) / 1e3 if h else 0}
        for ln, want in (("ingest", count),
                         ("verify_dedup", count - v["dedup_drop"]),
                         ("dedup_sink", unique)):
            got = (links[ln]["pub"], links[ln]["consumed"],
                   links[ln]["lost"])
            assert got == (want, want, 0), \
                f"link {ln} pub/consumed/lost {got}, expected {want}"
        vh = read_hists(runner.wksp, runner.plan, "verify")
        rec = {
            "e2e_tps": count / wall, "e2e_count": count,
            "e2e_wall_s": wall, "boot_s": t0 - t_boot,
            "verify_work_p50_ms": quantile_ns(vh["work"], 0.50) / 1e6,
            "verify_work_p99_ms": quantile_ns(vh["work"], 0.99) / 1e6,
            "tpu_p50_ms": quantile_ns(vh["tpu"], 0.50) / 1e6,
            "tpu_p99_ms": quantile_ns(vh["tpu"], 0.99) / 1e6,
            "tpu_count": vh["tpu"]["count"],
            # verify's productive polls by log2 bucket upper bound
            "verify_work_polls_by_ms": {
                f"{2 ** (i + 1) / 1e6:g}": c
                for i, c in enumerate(vh["work"]["buckets"]) if c},
            # the device seam's share of the verify tile's productive
            # polls; dispatch and readback may also fall in idle polls
            "device_seam_share": vh["tpu"]["sum_ns"] / vh["work"]["sum_ns"],
            "device_seam_share_of_busy": vh["tpu"]["sum_ns"] / (
                vh["work"]["sum_ns"] + vh["wait"]["sum_ns"]),
            "stage_budget": budget, "link_budget": links}
        if traced is not None:
            rec["trace"] = traced
        return rec, v
    finally:
        runner.halt()
        runner.close()
        if env0 is None:
            os.environ.pop("FDTPU_VERIFY_INFLIGHT", None)
        else:
            os.environ["FDTPU_VERIFY_INFLIGHT"] = env0


def run_profiled_e2e(root, card, rec10a) -> dict:
    """Phase 10c: bench.py's _e2e_run as bench.py runs it by default
    (bench.py:205-325): cfg/sigverify.toml (10a's run) with [prof] on at
    E2E_PROF_HZ over every tile, the verify tile on the card. Prints
    bench.py's record (e2e_tps, e2e_verify_work_p99_ms, e2e_stage_budget,
    e2e_link_budget and e2e_profile: prof.profile_summary plus
    verify_device, the tpu histogram's sum over the wall, the kernel
    loads, the loads after the warmup and the warmup's seconds). Held:
    every tile's region holds samples, the verify tile's top frames name
    its poll, no kernel was loaded after the warmup, and run_topology's
    checks (every frame accounted for, cpu_fallback and device_errors
    0). -> the record."""
    from firedancer_tpu_torch.disco.metrics import read_hists
    from firedancer_tpu_torch.prof import profile_summary

    def on_halted(runner):
        return {"profile": profile_summary(runner.plan, runner.wksp),
                "tpu_sum_ns": read_hists(runner.wksp, runner.plan,
                                         "verify")["tpu"]["sum_ns"]}
    rec, v = run_topology(root, "10c", TOPO_FRAMES, on_halted=on_halted,
                          prof={"enable": True, "hz": E2E_PROF_HZ})
    got = rec.pop("trace")
    prof = got["profile"]
    assert set(prof) == {"synth", "verify", "dedup", "sink"}, sorted(prof)
    for tn, p in prof.items():
        assert p["samples"] > 0, f"10c: no samples in {tn}'s region"
    top = [t["stack"] for t in prof["verify"]["top"]]
    assert any("poll_once" in st for st in top), \
        f"10c: the verify tile's top frames name no poll: {top}"
    assert v["tpu_jit_compiles"] > 0 and v["tpu_jit_cache_miss"] == 0, \
        f"10c: kernel loads after the warmup: {v}"
    wall = rec["e2e_wall_s"]
    prof["verify_device"] = {
        "occupancy": got["tpu_sum_ns"] / 1e9 / wall if wall else 0.0,
        "compiles": v["tpu_jit_compiles"],
        "cache_miss": v["tpu_jit_cache_miss"],
        "compile_s": v["tpu_compile_ns"] / 1e9}
    out = {"e2e_tps": rec["e2e_tps"], "e2e_count": rec["e2e_count"],
           "e2e_wall_s": wall,
           "e2e_verify_work_p99_ms": rec["verify_work_p99_ms"],
           "e2e_stage_budget": rec["stage_budget"],
           "e2e_link_budget": rec["link_budget"], "e2e_profile": prof,
           "boot_s": rec["boot_s"], "verify_batches": v["batches"]}
    log(f"10c record {json.dumps(out)}")
    log(f"10c: e2e {out['e2e_tps']:.0f} frames/s with the sampler at "
        f"{E2E_PROF_HZ:g} Hz on every tile, against 10a's "
        f"{rec10a['e2e_tps']:.0f} in this call (the sampler's cost, not "
        f"gated); verify work p99 {out['e2e_verify_work_p99_ms']:.4f} ms; "
        f"samples " + ", ".join(f"{tn} {p['samples']}" for tn, p in
                                sorted(prof.items()) if "samples" in p)
        + f"; verify's top stack {top[0]!r}; device occupancy "
        f"{prof['verify_device']['occupancy']:.4f}, kernel loads "
        f"{v['tpu_jit_compiles']} (after the warmup "
        f"{v['tpu_jit_cache_miss']}), warmup {v['tpu_compile_ns'] / 1e9:.2f}"
        f" s {card}")
    return out


def run_leader(root, tag):
    """Phase 12: boot firedancer_tpu_torch/cfg/leader.toml with verify and
    bank on the card, its two verify shards pinned by bench.py's rule
    (cpu0 = 1 when os.cpu_count() >= shards + 6; each shard process's
    affinity held to one core of the launcher's set, avail[(cpu0 + i) %
    len(avail)]), wait until every tile runs, then until the synth
    has published its 4096 frames and every one is accounted for
    (bench.py's _leader_wait_drained: bank0 txns plus the frames dropped
    at a named hop equal the count, and pack has retired every
    microblock); then drain the shred leg (tools/leader_drain.py: halt
    every tile upstream of the shred tile, wait until it has taken every
    poh entry and shredsink every shred it made), halt the rest and read
    the tiles' flushed metrics, budgets and link counters, and hold every
    mirrored shred to its FEC set's root and signature. -> (record, the
    wires still in the mirror ring). Raises on a count mismatch, a dead
    tile or a timeout."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    from firedancer_tpu_torch.disco.metrics import (
        link_lag, quantile_ns, read_hists, read_link_metrics)
    from firedancer_tpu_torch.tools import leader_drain
    # bench.py's pinning rule (bench.py:444-445, :502): the verify shards
    # get a core each from cpu0 = 1 when the host has verify_tiles + 6
    cpus = os.cpu_count() or 1
    vt = next(t.get("tile_cnt", 1) for t in load_config(
        os.path.join(root, "firedancer_tpu_torch", "cfg", "leader.toml"))
        ["tile"] if t["name"] == "verify")
    cpu0 = 1 if cpus >= vt + 6 else None
    cfg = load_config(
        os.path.join(root, "firedancer_tpu_torch", "cfg", "leader.toml"),
        overrides={"tile": [{"name": "verify", "device": DEVICE,
                             **({} if cpu0 is None else {"cpu0": cpu0})},
                            {"name": "bank0", "device": DEVICE}]})
    count = next(t["count"] for t in cfg["tile"] if t["name"] == "synth")
    assert count == LEADER_FRAMES
    runner = TopologyRunner(build_topology(
        cfg, name=f"smoke{tag}{os.getpid()}").build())
    shards = [tn for tn in runner.plan["tiles"] if tn.startswith("verify")]
    avail = sorted(os.sched_getaffinity(0))
    try:
        t_boot = time.perf_counter()
        runner.start()
        runner.wait_running(timeout_s=300)
        pinned = {}
        for i, tn in enumerate(shards):
            got = os.sched_getaffinity(runner.procs[tn].pid)
            want = set(avail) if cpu0 is None \
                else {avail[(cpu0 + i) % len(avail)]}
            assert got == want, f"12: {tn} runs on {sorted(got)}, " \
                f"expected {sorted(want)}"
            pinned[tn] = sorted(got)
        log(f"12: os.cpu_count() {cpus}, the launcher's affinity set "
            f"{avail}; bench.py's rule (cpus >= {vt} + 6) gives cpu0 "
            f"{cpu0}: verify shards on {pinned}")
        t0 = time.perf_counter()
        # each tile's work so far (boot-time ticks and slot frags), so the
        # budget below counts the drain window's work only
        work0 = {tn: read_hists(runner.wksp, runner.plan, tn)["work"]
                 ["sum_ns"] for tn in runner.plan["tiles"]}
        runner.wait_idle("synth", "tx", count, timeout_s=300, poll_s=0.002)
        dropped = leader_drain.wait_drained(runner, count, timeout_s=300)
        wall = time.perf_counter() - t0
        # the stems flush their metrics, histograms and link counters on
        # a clean exit; the workspace stays until close()
        t1 = time.perf_counter()
        m = leader_drain.drain_shred_leg(runner, timeout_s=600)
        shred_drain_s = time.perf_counter() - t1
        for tn, proc in runner.procs.items():
            assert proc.exitcode == 0, f"tile {tn} exit code {proc.exitcode}"
        b, p, poh = m["bank0"], m["pack"], m["poh"]
        sh, sg, snk = m["shred"], m["sign"], m["shredsink"]
        wires = leader_drain.mirror_wires(runner)
        ident = bytes.fromhex(next(t["identity_hex"] for t in cfg["tile"]
                                   if t["name"] == "shred"))
        t1 = time.perf_counter()
        sets_checked = leader_drain.check_mirror(wires, ident)
        check_s = time.perf_counter() - t1
        parsed = b["txns"] - b["exec_skip"]
        for key, got, want in (
                ("bank0.txns + drops", b["txns"] + dropped, count),
                ("bank0.exec_fail", b["exec_fail"], 0),
                ("bank0.exec_skip", b["exec_skip"], 0),
                ("bank0.transfers", b["transfers"], parsed),
                ("poh.mixins", poh["mixins"], b["microblocks"]),
                ("pack.completions", p["completions"], p["microblocks"]),
                ("pack.scheduled", p["scheduled"], b["txns"]),
                ("shred.entries", sh["entries"], poh["entries"]),
                ("shredsink.rx", snk["rx"],
                 sh["data_shreds"] + sh["parity_shreds"]),
                ("sign.signed", sg["signed"], sh["fec_sets"]),
                ("sign.refused", sg["refused"], 0),
                ("shred.sign_fail", sh["sign_fail"], 0),
                ("shred.sent", sh["sent"], snk["rx"])):
            assert got == want, f"{key} = {got}, expected {want}"
        assert sh["fec_sets"] > 0 and sets_checked > 0
        assert b["wave_launches"] > 0, "the bank launched no wave scan"
        for tn in shards:
            assert m[tn]["batches"] > 0 and m[tn]["verify_fail"] == 0, \
                f"{tn}: {m[tn]}"
            no_fallback(f"12 {tn}", m[tn])
        budget = {}
        for tn in runner.plan["tiles"]:
            h = read_hists(runner.wksp, runner.plan, tn)
            work, wait = h["work"], h["wait"]
            busy = work["sum_ns"] + wait["sum_ns"]
            budget[tn] = {
                "work_p50_us": quantile_ns(work, 0.50) / 1e3,
                "work_p99_us": quantile_ns(work, 0.99) / 1e3,
                "occupancy": work["sum_ns"] / busy if busy else 0.0,
                # work from RUN to halt over the drain window's wall (the
                # shred leg's window runs on through its own drain)
                "window_work_s": (work["sum_ns"] - work0[tn]) / 1e9,
                "window_share": (work["sum_ns"] - work0[tn]) / 1e9 / (
                    wall + (shred_drain_s if tn in leader_drain.SHRED_LEG
                            else 0.0))}
        links = {}
        for ln, rec in read_link_metrics(runner.wksp, runner.plan).items():
            cons = rec["consumers"]
            links[ln] = {
                "pub": rec["pub"],
                "consumed": sum(c["consumed"] for c in cons.values()),
                "lost": sum(link_lag(rec, tn) for tn in cons),
                "backpressure": rec["backpressure"]}
            assert links[ln]["lost"] == 0, f"link {ln}: {links[ln]}"
        bh = read_hists(runner.wksp, runner.plan, "bank0")
        return {
            "cpu_count": cpus, "launcher_affinity": avail, "cpu0": cpu0,
            "verify_affinity": pinned,
            "e2e_leader_tps": b["txns"] / wall, "e2e_leader_count":
            b["txns"], "e2e_leader_wall_s": wall, "boot_s": t0 - t_boot,
            "bank_microblocks": b["microblocks"],
            "bank_wave_launches": b["wave_launches"],
            "txns_per_microblock": b["txns"] / b["microblocks"],
            "verify_batches": {tn: m[tn]["batches"] for tn in shards},
            "poh_ticks": poh["ticks"], "pack_blocks": p["blocks"],
            "bank_dispatch_spans": bh["tpu"]["count"],
            "bank_dispatch_p50_ms": quantile_ns(bh["tpu"], 0.50) / 1e6,
            "bank_dispatch_p99_ms": quantile_ns(bh["tpu"], 0.99) / 1e6,
            "bank_dispatch_share_of_work":
                bh["tpu"]["sum_ns"] / bh["work"]["sum_ns"],
            "shred": {k: sh[k] for k in ("entries", "batches", "fec_sets",
                                         "data_shreds", "parity_shreds",
                                         "sent", "slots", "sign_fail")},
            "sign_signed": sg["signed"], "shredsink_rx": snk["rx"],
            "shred_drain_s": shred_drain_s, "mirror_checked": len(wires),
            "mirror_sets_checked": sets_checked, "mirror_check_s": check_s,
            "stage_budget": budget, "link_budget": links}, wires
    finally:
        runner.halt()
        runner.close()


def poh_work(args, max_hashes: int):
    """(hashes, SHA-256 blocks) that verifying the entries `args` (prev,
    num_hashes, mixin, has_mixin, expected) needs: each entry's plain
    hashes up to max_hashes, one block each, and a mixin hash of two
    blocks where it has one."""
    num, has = args[1].astype(np.int64), args[3].astype(np.int64)
    plain = int(np.clip(num - has, 0, max_hashes).sum())
    return plain + int(has.sum()), plain + 2 * int(has.sum())


def poh_chain(args, max_hashes: int):
    """(rounds, ms) of the longest entry's chain in `args`: its plain
    hashes up to max_hashes of 64 dependent rounds each, and 128 for its
    mixin hash, at SHA256_ROUND_CHAIN_OPS cycles a round."""
    num, has = args[1].astype(np.int64), args[3].astype(np.int64)
    rounds = int((np.clip(num - has, 0, max_hashes) * 64 + has * 128).max())
    return rounds, rounds * SHA256_ROUND_CHAIN_OPS / CLOCK_HZ * 1e3


def issue_floor(kernel: str, steps: int, sass: dict):
    """(instructions, ms) of the round warp of `kernel` issuing `steps`
    passes of its loop in the SASS (`sass`: tools/sha256_bench's
    sass_report; one pass is a compression of poh_verify, a block of
    sha256), one instruction a cycle at the boost clock."""
    from firedancer_tpu_torch.tools.sha256_bench import round_loop
    n = round_loop(sass, kernel)["instrs"]
    return n, steps * n / CLOCK_HZ * 1e3


def run_hash_phases(dev, card, counts, reset_counts):
    """Phases 13-16: the SHA-256, PoH and BLAKE3 kernels against their
    plain versions and oracles, the paths through them (bmtree_root, the
    shred merkle leaves, poh_verify_entries, blake3_batch and
    lthash_batch, each read with the counts set to 0 just before it), and
    Reed-Solomon on the card. -> ({name: stats}, the paths' launch
    counts, {kernel: max_abs_err against its plain version})."""
    from firedancer_tpu_torch.ops import _build, cuda_blake3, cuda_sha256, sha2
    from firedancer_tpu_torch.tools import (blake3_bench, sha256_bench,
                                            wave_bench)
    stats = {}
    sass = sha256_bench.sass_report(_build._paths("sha256")[1])
    # 13. SHA-256: kernel == plain == hashlib at 8192 rows of lengths
    # 0-1296; then two paths through the kernel, each with the counts set
    # to 0 just before it: bmtree_root over 64 shred-sized trees (64
    # leaves, the 26-byte prefixes) == host_bmtree_root, and the merkle
    # leaves of the 64 wires of a 32:32 FEC set (the port's Shredder, its
    # parity from ops/reedsol on the card) == hashlib, whose tree gives
    # the set's signed root
    from firedancer_tpu_torch.ops import blake3 as b3, bmtree, poh, reedsol
    from firedancer_tpu_torch.shred import format as sfmt
    from firedancer_tpu_torch.shred.merkle import (
        LEAF_PREFIX, MerkleTree20, shred_merkle_leaf)
    from firedancer_tpu_torch.shred.merkle import \
        bmtree_depth as shred_tree_depth
    from firedancer_tpu_torch.shred.shredder import Shredder
    from firedancer_tpu_torch.utils import blake3_ref, gf256
    from firedancer_tpu_torch.utils import ed25519_ref as eref
    log(f"== 13. sha256 kernel vs plain vs hashlib; bmtree_root and shred "
        f"merkle leaves on the kernel {card}")
    rng = np.random.default_rng(13)
    lens = rng.integers(0, SHA256_WIDTH + 1, SHA256_B).astype(np.int32)
    lens[:12] = [0, 1, 55, 56, 63, 64, 119, 120, 127, 128, 1295,
                 SHA256_WIDTH]
    smsg = rng.integers(0, 256, (SHA256_B, SHA256_WIDTH), np.uint8)
    smsg[np.arange(SHA256_WIDTH)[None, :] >= lens[:, None]] = 0
    sm_d, sl_d = torch.from_numpy(smsg).to(dev), torch.from_numpy(lens).to(dev)
    got = cuda_sha256.sha256(sm_d, sl_d)
    plain = sha2.sha256(sm_d, sl_d)
    torch.cuda.synchronize()
    sha256_err = int((got.int() - plain.int()).abs().max())
    want = np.stack([np.frombuffer(hashlib.sha256(
        smsg[i, :n].tobytes()).digest(), np.uint8)
        for i, n in enumerate(lens)])
    assert sha256_err == 0, f"sha256 kernel != plain (max err {sha256_err})"
    assert np.array_equal(got.cpu().numpy(), want), "sha256 != hashlib"
    blocks = int(sha2.nblocks(torch.from_numpy(lens).long(), 64, 8).sum())
    ops = blocks * SHA256_OPS_PER_BLOCK
    nbytes = int(lens.sum()) + SHA256_B * (4 + 32)
    # the kernel's time from a CUDA graph of ITERS launches: a call from
    # Python costs more than the kernel at this size
    st = stats["sha256"] = stats_of(
        wave_bench.graph_ms(lambda: cuda_sha256.sha256(sm_d, sl_d), ITERS),
        cuda_ms(lambda: sha2.sha256(sm_d, sl_d), 1), ops, nbytes)
    st["call_ms"] = cuda_ms(lambda: cuda_sha256.sha256(sm_d, sl_d), ITERS)
    longest = int(sha2.nblocks(torch.from_numpy(lens).long(), 64, 8).max())
    st["issue_instrs"], st["issue_floor_ms"] = issue_floor(
        "sha256_kernel", longest, sass)
    log(f"sha256: {SHA256_B} rows of 0-{SHA256_WIDTH} bytes ({blocks} "
        f"blocks), kernel == plain == hashlib, max_abs_err 0; kernel "
        f"{st['ms']:.4f} ms (CUDA graph; {st['call_ms']:.4f} ms a call from "
        f"Python), plain {st['plain_ms']:.2f} ms, bound "
        f"{st['bound_ms']:.5f} ms ({ops} int32 ops -> {st['ops_ms']:.5f} "
        f"ms, {nbytes} B -> {st['bytes_ms']:.5f} ms), "
        f"{st['ms'] / st['bound_ms']:.1f}x the bound; issue floor "
        f"{st['issue_floor_ms']:.5f} ms (the round warp's {longest} blocks "
        f"of {st['issue_instrs']} SASS instructions), "
        f"{st['ms'] / st['issue_floor_ms']:.1f}x it {card}")
    # the same rows one byte wider: every row at another alignment, the
    # same staging path as bmtree's levels and the shred leaves take
    sm_odd = torch.nn.functional.pad(sm_d, (0, 1)).contiguous()
    got = cuda_sha256.sha256(sm_odd, sl_d)
    odd_err = int((got.int() - sha2.sha256(sm_odd, sl_d).int()).abs().max())
    assert odd_err == 0, f"sha256 at width 1297 != plain ({odd_err})"
    assert np.array_equal(got.cpu().numpy(), want), \
        "sha256 at width 1297 != hashlib"
    sha256_err = max(sha256_err, odd_err)
    st["ms_1297"] = wave_bench.graph_ms(
        lambda: cuda_sha256.sha256(sm_odd, sl_d), ITERS)
    log(f"sha256: the rows at width {SHA256_WIDTH + 1}, kernel == plain == "
        f"hashlib, max_abs_err 0; kernel {st['ms_1297']:.4f} ms (CUDA "
        f"graph), {st['ms_1297'] / st['ms']:.3f}x width {SHA256_WIDTH} {card}")
    leaves = rng.integers(0, 256, (BMTREE_TREES, BMTREE_LEAVES, 32),
                          np.uint8)
    cnt = np.full(BMTREE_TREES, BMTREE_LEAVES, np.int32)
    cnt[1:8] = [1, 2, 3, 33, 47, 63, 17]
    # bmtree_root's launches, recorded to hold each level to the plain
    # version after the path's counts are read
    levels, kernel_sha256 = [], cuda_sha256.sha256

    def recorded_sha256(m, n):
        out = kernel_sha256(m, n)
        levels.append((m, n, out))
        return out
    cuda_sha256.sha256 = recorded_sha256
    try:
        reset_counts()
        roots = bmtree.bmtree_root(leaves, cnt, BMTREE_LEAVES,
                                   bmtree.LEAF_PREFIX_SHREDS,
                                   bmtree.NODE_PREFIX_SHREDS,
                                   device=DEVICE).cpu().numpy()
        bmtree_path = counts()
    finally:
        cuda_sha256.sha256 = kernel_sha256
    level_err = max(int((out.int() - sha2.sha256(m, n).int()).abs().max())
                    for m, n, out in levels)
    assert level_err == 0, f"bmtree levels: kernel != plain ({level_err})"
    sha256_err = max(sha256_err, level_err)
    for t in range(BMTREE_TREES):
        assert bytes(roots[t]) == bmtree.host_bmtree_root(
            [bytes(x) for x in leaves[t, :cnt[t]]],
            bmtree.LEAF_PREFIX_SHREDS, bmtree.NODE_PREFIX_SHREDS), t
    assert bmtree_path["sha256"] == 1 + bmtree.bmtree_depth(BMTREE_LEAVES)
    seed = bytes(range(32))
    batch = rng.integers(0, 256, 63680, np.uint8).tobytes()
    fec = Shredder(lambda r: eref.sign(seed, r), rs_backend="torch",
                   device=DEVICE).shred_batch(batch, 5, 1, 0, False)
    fs = fec[0]
    assert (len(fs.data_shreds), len(fs.parity_shreds)) == (32, 32)
    dv, cv = fs.data_shreds[0][sfmt.VARIANT_OFF], \
        fs.parity_shreds[0][sfmt.VARIANT_OFF]
    regions = [w[64:64 + sfmt.data_merkle_region_sz(dv)]
               for w in fs.data_shreds] + \
        [w[64:64 + sfmt.code_merkle_region_sz(cv)] for w in fs.parity_shreds]
    lw = len(LEAF_PREFIX) + max(len(r) for r in regions)
    lmsg = np.zeros((len(regions), lw), np.uint8)
    for i, r in enumerate(regions):
        lmsg[i, :len(LEAF_PREFIX) + len(r)] = np.frombuffer(LEAF_PREFIX + r,
                                                            np.uint8)
    llen = torch.tensor([len(LEAF_PREFIX) + len(r) for r in regions],
                        dtype=torch.int32, device=dev)
    lmsg_d = torch.from_numpy(lmsg).to(dev)
    reset_counts()
    leaf_d = cuda_sha256.sha256(lmsg_d, llen)
    leaf_path = counts()
    leaf_err = int((leaf_d.int() - sha2.sha256(lmsg_d, llen).int())
                   .abs().max())
    assert leaf_err == 0, f"shred leaves: kernel != plain ({leaf_err})"
    sha256_err = max(sha256_err, leaf_err)
    leaf_h = leaf_d.cpu().numpy()
    assert [bytes(h) for h in leaf_h] == [shred_merkle_leaf(r)
                                          for r in regions]
    assert MerkleTree20.from_leaf_hashes(leaf_h).root == fs.merkle_root
    assert eref.verify(sfmt.parse_shred(fs.data_shreds[0]).signature,
                       eref.keypair(seed)[-1], fs.merkle_root)
    # each of the paths' launches timed on its own inputs: device time
    # from a CUDA graph of ITERS launches (a call from Python costs more
    # than these small launches)
    for m, n, _ in levels + [(lmsg_d, llen, None)]:
        log(f"sha256 at {m.shape[0]} rows x {m.shape[1]} bytes "
            f"({'shred leaves' if n is llen else 'a bmtree level'}): "
            f"{wave_bench.graph_ms(lambda: cuda_sha256.sha256(m, n), ITERS):.5f}"
            f" ms (CUDA graph) {card}")
    log(f"bmtree_root: {BMTREE_TREES} trees of up to {BMTREE_LEAVES} leaves "
        f"(26-byte prefixes) == host_bmtree_root, each level's launch "
        f"(row widths {sorted({m.shape[1] for m, _, _ in levels})}) == "
        f"plain, launches {bmtree_path}; the 64 merkle leaves of a 32:32 "
        f"FEC set (Shredder with rs_backend='torch' on the card, row width "
        f"{lw}) == plain == hashlib, their tree's root == the signed root, "
        f"launches {leaf_path} {card}")

    # 14. PoH: one slot at mainnet's published settings (Solana's genesis
    # hashes_per_tick, 12,500): 64 ticks, each after one mixin entry that
    # takes 1-64 of the tick's hashes, generated by the host chain
    # (PohChain: host_poh_append / host_poh_mixin), and the same entries
    # with one flipped byte in expected; the kernel's verdicts through
    # poh_verify_entries (the path, counts set to 0 before it) == the host
    # chain's. The plain version is compared at cfg/leader.toml's 64
    # hashes a tick only: at 12,500 it would issue some 4 x 10^7 launches.
    log(f"== 14. poh_verify: {POH_TICKS} ticks of {POH_HASHES_PER_TICK} "
        f"hashes and {POH_TICKS} mixin entries, valid and flipped {card}")

    def slot_entries(hashes_per_tick, rng):
        chain = poh.PohChain(rng.bytes(32))
        for _ in range(POH_TICKS):
            k = int(rng.integers(1, 65)) % hashes_per_tick or 1
            chain.record(rng.bytes(32), k)
            chain.tick(hashes_per_tick - k)
        prev, num, mix, has, exp = chain.entry_arrays(hashes_per_tick)
        bad = exp.copy()
        bad[np.arange(len(bad)), np.arange(len(bad)) % 32] ^= 1
        args = [np.concatenate([x, x]) for x in (prev, num, mix, has)]
        args.append(np.concatenate([exp, bad]))
        want = np.arange(2 * len(num)) < len(num)
        return args, want

    t0 = time.perf_counter()
    pargs, pwant = slot_entries(POH_HASHES_PER_TICK, rng)
    gen_s = time.perf_counter() - t0
    reset_counts()
    pok = poh.poh_verify_entries(*pargs, POH_HASHES_PER_TICK,
                                 device=DEVICE).cpu().numpy()
    poh_path = counts()
    assert np.array_equal(pok, pwant), "poh_verify != the host chain"
    assert poh_path["poh_verify"] == 1, poh_path
    pt = [torch.from_numpy(x).to(dev) for x in pargs]
    big_ms = cuda_ms(lambda: cuda_sha256.poh_verify(
        *pt, POH_HASHES_PER_TICK), 3)
    hashes, blocks = poh_work(pargs, POH_HASHES_PER_TICK)
    big_ops = blocks * SHA256_OPS_PER_BLOCK
    big_rounds, big_chain_ms = poh_chain(pargs, POH_HASHES_PER_TICK)
    issue_instrs, big_issue_ms = issue_floor("poh_verify_kernel",
                                             big_rounds // 64, sass)
    log(f"poh_verify at {POH_HASHES_PER_TICK} hashes a tick: "
        f"{len(pwant)} entries ({hashes} hashes, generated on the host in "
        f"{gen_s:.2f} s), verdicts == the host chain (valid {int(pok.sum())}"
        f", flipped {int((~pok).sum())} refused); kernel {big_ms:.3f} ms "
        f"({big_ms * 1e-3 * CLOCK_HZ / big_rounds:.1f} clocks a round); "
        f"bound {big_ops / INT32_OPS_PER_S * 1e3:.5f} ms by operations; "
        f"chain floor {big_chain_ms:.4f} ms (the longest entry's "
        f"{big_rounds} dependent rounds at {SHA256_ROUND_CHAIN_OPS} cycles), "
        f"{big_ms / big_chain_ms:.1f}x the chain floor; issue floor "
        f"{big_issue_ms:.4f} ms (the round warp's {issue_instrs} SASS "
        f"instructions a compression, one a cycle), "
        f"{big_ms / big_issue_ms:.2f}x it {card}")
    sargs, swant = slot_entries(POH_SMALL_HASHES, rng)
    st_ = [torch.from_numpy(x).to(dev) for x in sargs]
    sk = cuda_sha256.poh_verify(*st_, POH_SMALL_HASHES)
    sp = poh.poh_verify_plain(*st_, POH_SMALL_HASHES)
    poh_err = int((sk.int() - sp.int()).abs().max())
    assert poh_err == 0 and np.array_equal(sk.cpu().numpy(), swant), \
        "poh_verify kernel != plain at 64 hashes a tick"
    st = stats["poh_verify"] = stats_of(
        cuda_ms(lambda: cuda_sha256.poh_verify(*st_, POH_SMALL_HASHES),
                ITERS),
        cuda_ms(lambda: poh.poh_verify_plain(*st_, POH_SMALL_HASHES), 1),
        poh_work(sargs, POH_SMALL_HASHES)[1] * SHA256_OPS_PER_BLOCK,
        len(swant) * (3 * 32 + 4 + 1 + 1))
    st["mainnet_ms"] = big_ms
    st["chain_rounds"], st["chain_ms"] = poh_chain(sargs, POH_SMALL_HASHES)
    st["issue_instrs"], st["issue_floor_ms"] = issue_floor(
        "poh_verify_kernel", st["chain_rounds"] // 64, sass)
    log(f"poh_verify at {POH_SMALL_HASHES} hashes a tick: {len(swant)} "
        f"entries, kernel == plain == the host chain, max_abs_err 0; kernel "
        f"{st['ms']:.4f} ms, plain {st['plain_ms']:.2f} ms, bound "
        f"{st['bound_ms']:.6f} ms by {st['bound_by']}; chain floor "
        f"{st['chain_ms']:.6f} ms (the longest entry's {st['chain_rounds']} "
        f"dependent rounds), {st['ms'] / st['chain_ms']:.1f}x the chain "
        f"floor; issue floor {st['issue_floor_ms']:.6f} ms, "
        f"{st['ms'] / st['issue_floor_ms']:.2f}x it {card}")

    # 15. BLAKE3 and lthash: kernel == plain at 4096 lanes of lengths 0-2048
    # (the bank hash's lane cap), the 1024/1025 chunk edge included, and ==
    # blake3_ref on the first 512 lanes (the pure-Python oracle is slow);
    # the path is blake3_batch and lthash_batch, counts set to 0 before.
    # Then the bank hash's shape: 4096 lanes of 81 bytes (a serialized
    # data-less system account, flamenco/bank_hash.py:30-40), rows at
    # width 81, every row at another alignment
    log(f"== 15. blake3 and lthash kernels vs plain vs blake3_ref, "
        f"{BLAKE3_B} lanes of 0-2048 bytes and {BLAKE3_B} of "
        f"{blake3_bench.BANK_HASH_LEN} {card}")
    blens = rng.integers(0, 2049, BLAKE3_B).astype(np.int32)
    blens[:11] = [0, 1, 63, 64, 65, 1023, 1024, 1025, 2047, 2048, 3]
    bmsg = rng.integers(0, 256, (BLAKE3_B, 2048), np.uint8)
    bmsg[np.arange(2048)[None, :] >= blens[:, None]] = 0
    reset_counts()
    bd = b3.blake3_batch(bmsg, blens, device=DEVICE)
    bl = b3.lthash_batch(bmsg, blens, device=DEVICE)
    b3_path = counts()
    assert b3_path["blake3"] == 1 and b3_path["lthash"] == 1, b3_path
    bank_msg, bank_lens = blake3_bench.rows(
        BLAKE3_B, blake3_bench.BANK_HASH_LEN, blake3_bench.BANK_HASH_LEN,
        blake3_bench.BANK_HASH_LEN, int(rng.integers(1 << 30)))
    b3_err = lt_err = 0
    for shape, msg_h, lens_h, dig, lan in (
            ("0-2048", bmsg, blens, bd, bl),
            ("81", bank_msg, bank_lens, None, None)):
        m_d, l_d = torch.from_numpy(msg_h).to(dev), \
            torch.from_numpy(lens_h).to(dev)
        if dig is None:
            dig, lan = cuda_blake3.blake3(m_d, l_d), cuda_blake3.lthash(m_d,
                                                                       l_d)
        e_d = int((dig.int() - b3.blake3_plain(m_d, l_d).int()).abs().max())
        e_l = int((lan - b3.lthash_plain(m_d, l_d)).abs().max())
        assert e_d == 0 and e_l == 0, (shape, e_d, e_l)
        b3_err, lt_err = max(b3_err, e_d), max(lt_err, e_l)
        d_h, l_h = dig.cpu().numpy(), lan.cpu().numpy()
        for i in range(min(512, BLAKE3_B)):
            m_ = msg_h[i, :lens_h[i]].tobytes()
            assert bytes(d_h[i]) == blake3_ref.blake3(m_), (shape, i)
            assert np.array_equal(l_h[i], np.frombuffer(
                blake3_ref.lthash(m_), np.uint16)), (shape, i)
        for name, kern, plain in (
                ("blake3", cuda_blake3.blake3, b3.blake3_plain),
                ("lthash", cuda_blake3.lthash, b3.lthash_plain)):
            w = blake3_bench.work(lens_h, name)
            # the kernel's time from a CUDA graph of ITERS launches: a call
            # from Python costs more than the kernel at these sizes
            ms = wave_bench.graph_ms(lambda: kern(m_d, l_d), ITERS)
            call_ms = cuda_ms(lambda: kern(m_d, l_d), ITERS)
            if shape == "0-2048":
                st = stats[name] = stats_of(ms, cuda_ms(
                    lambda: plain(m_d, l_d), 1), w["ops"], w["bytes"])
                st.update(call_ms=call_ms, chain_floor_ms=w["chain_floor_ms"])
            else:
                st = stats[name]
                st.update(bank_hash_ms=ms, bank_hash_call_ms=call_ms,
                          bank_hash_bound_ms=w["bound_ms"],
                          bank_hash_bound_by=w["bound_by"])
            plain_txt = (f", plain {st['plain_ms']:.2f} ms"
                         if shape == "0-2048" else "")
            log(f"{name} at {BLAKE3_B} lanes of {shape} bytes (width "
                f"{msg_h.shape[1]}): kernel == plain (== blake3_ref on 512 "
                f"lanes), max_abs_err 0; kernel {ms:.4f} ms (CUDA graph; "
                f"{call_ms:.4f} ms a call from Python){plain_txt}, bound "
                f"{w['bound_ms']:.5f} ms ({w['ops']} int32 ops -> "
                f"{w['ops_ms']:.5f} ms, {w['bytes']} B -> "
                f"{w['bytes_ms']:.5f} ms), {ms / w['bound_ms']:.1f}x the "
                f"bound; chain floor {w['chain_floor_ms']:.5f} ms (the "
                f"longest message's {w['chain']} dependent compressions, "
                f"its chunks side by side), {ms / w['chain_floor_ms']:.1f}x "
                f"it {card}")

    # 16. Reed-Solomon (torch.matmul on the card, no hand-written kernel):
    # encode 64 sets at the shredder's 32:32 over its RS region, == the CPU
    # port on every set and == gf256 on four; recover from 32 survivors
    proof_nodes = shred_tree_depth(64) - 1     # a 32:32 set's 64 leaves
    d_var = sfmt.TYPE_MERKLE_DATA | proof_nodes
    rs_region = sfmt.payload_capacity(d_var) + sfmt.DATA_HEADER_SZ \
        - sfmt.SIGNATURE_SZ
    log(f"== 16. reedsol on the card: {RS_SETS} sets of 32:32 over "
        f"{rs_region} bytes ({proof_nodes} proof nodes) {card}")
    rdata = rng.integers(0, 256, (RS_SETS, 32, rs_region), np.uint8)
    rd_d = torch.from_numpy(rdata).to(dev)
    par = reedsol.encode(rd_d, 32, device=DEVICE)
    par_h = par.cpu().numpy()
    assert np.array_equal(par_h, reedsol.encode(rdata, 32,
                                                device="cpu").numpy())
    for k in range(4):
        assert np.array_equal(par_h[k], gf256.encode(rdata[k], 32)), k
    present = tuple(range(1, 64, 2))
    code = torch.cat([rd_d, par], dim=1)[:, list(present)].contiguous()
    rec_d = reedsol.recover(code, present, 32, 32, device=DEVICE)
    assert torch.equal(rec_d, rd_d), "reedsol.recover != the data"
    enc_ms = cuda_ms(lambda: reedsol.encode(rd_d, 32, device=DEVICE), ITERS)
    rec_ms = cuda_ms(lambda: reedsol.recover(code, present, 32, 32,
                                             device=DEVICE), ITERS)
    flops = 2 * 256 * 256 * RS_SETS * rs_region
    rs_bytes = 2 * RS_SETS * 32 * rs_region
    stats["reedsol"] = dict(ms=enc_ms, recover_ms=rec_ms, flops=flops,
                            bound_ms=max(flops / 67e12, rs_bytes / BYTES_PER_S)
                            * 1e3)
    log(f"reedsol: encode == CPU port (== gf256 on 4 sets), recover == "
        f"data; encode {enc_ms:.4f} ms, recover {rec_ms:.4f} ms (CUDA events "
        f"over {ITERS} calls, the bit expansion, torch.matmul and the parity "
        f"mask: several launches); the product alone {flops} float32 "
        f"operations, {flops / 67e12 * 1e3:.5f} ms at 67 TFLOP/s; bytes "
        f"{rs_bytes} -> {rs_bytes / BYTES_PER_S * 1e3:.5f} ms {card}")

    errs = {"sha256": sha256_err, "poh_verify": poh_err, "blake3": b3_err,
            "lthash": lt_err}
    return stats, (bmtree_path, leaf_path, poh_path, b3_path), errs


FOLLOWER_LOSSY_SETS = 6   # phase 17a: FEC sets recovered from their parity


class _Capture:
    """An out link that keeps what a core publishes (the in-process
    stand-in of a ring with one reliable consumer)."""

    def __init__(self):
        self.frames = []

    def publish(self, frame, sig=0):
        self.frames.append(bytes(frame))

    def credits(self, fseqs):
        return 1 << 30


def follower_cfg(root):
    """firedancer_tpu_torch/cfg/leader_follower.toml's follower leg: ->
    (the leader's pubkey, replay's genesis_synth and hashes_per_tick)."""
    from firedancer_tpu_torch.app.config import load_config
    cfg = load_config(os.path.join(root, "firedancer_tpu_torch", "cfg",
                                   "leader_follower.toml"))
    tiles = {t["name"]: t for t in cfg["tile"]}
    pub = bytes.fromhex(tiles["shredr"]["leader_pubkey_hex"])
    assert pub == bytes.fromhex(tiles["shred"]["identity_hex"])
    return (pub, tiles["replay"]["genesis_synth"],
            tiles["replay"]["hashes_per_tick"])


def recover_slices(pub, wires, drop=frozenset()):
    """The port's ShredRecoverCore over `wires` but the indices in
    `drop`. -> (slice frames, the core)."""
    from firedancer_tpu_torch.tiles.shred import ShredRecoverCore
    out = _Capture()
    rec = ShredRecoverCore(pub, out, None)
    for k, w in enumerate(wires):
        if k not in drop:
            rec.on_shred(w)
    assert rec.metrics["parse_fail"] == 0, rec.metrics
    return out.frames, rec


def replay_slices(slices, genesis, hashes_per_tick, device, per_slice,
                  on_span=None, verify_poh=True):
    """The port's ReplayCore over slice frames on `device`: one slice at
    a time (per_slice, as the replay tile releases slots when it keeps
    up) or all in one release; `verify_poh` False for an oracle of bank
    hashes alone (the PoH check takes most of a CPU replay's time, and a
    bank hash takes the entries' tips as given). -> (core, wall
    seconds)."""
    from firedancer_tpu_torch.tiles.replay import ReplayCore
    t0 = time.perf_counter()
    core = ReplayCore(out_ring=_Capture(), genesis=genesis,
                      hashes_per_tick=hashes_per_tick, device=device,
                      verify_poh=verify_poh, on_span=on_span)
    if per_slice:
        for f in slices:
            core.on_slice(f)
    else:
        core.on_slices(slices)
    if device != "cpu":
        torch.cuda.synchronize()
    return core, time.perf_counter() - t0


def lossy_drop(wires) -> set:
    """Indices of data shreds to lose: in FOLLOWER_LOSSY_SETS complete FEC
    sets (the two with the most data shreds, the rest spread over the
    run), as many as the set has parity shreds, at most all its data."""
    from firedancer_tpu_torch.shred import format as sfmt
    sets = {}
    for k, w in enumerate(wires):
        s = sfmt.parse_shred(w)
        e = sets.setdefault((s.slot, s.fec_set_idx),
                            {"data": [], "code": 0, "d": None, "p": None})
        if sfmt.is_data(w[sfmt.VARIANT_OFF]):
            e["data"].append(k)
        else:
            e["code"] += 1
            e["d"], e["p"] = s.data_cnt, s.code_cnt
    whole = [key for key, e in sorted(sets.items())
             if e["d"] == len(e["data"]) and e["p"] == e["code"]]
    big = sorted(whole, key=lambda key: -sets[key]["d"])[:2]
    rest = [key for key in whole if key not in big]
    step = max(1, len(rest) // (FOLLOWER_LOSSY_SETS - len(big)))
    chosen = big + rest[::step][:FOLLOWER_LOSSY_SETS - len(big)]
    drop = set()
    for key in chosen:
        e = sets[key]
        drop |= set(e["data"][:min(e["d"], e["p"])])
    return drop, chosen


def follower_kernel_times(launches, hashes_per_tick, b3_work):
    """The replay's own launches of poh_verify and lthash, held to their
    plain versions (every launch's rows in one plain call on the CPU:
    the verdicts and lanes are per row); the launch of the median and of
    the largest shape timed by a CUDA graph of ITERS launches beside its
    bound and the plain version's time on the card.
    -> ({kernel: max_abs_err}, {kernel: [stats]})."""
    from firedancer_tpu_torch.ops import blake3 as b3, cuda_blake3, \
        cuda_sha256, poh
    from firedancer_tpu_torch.tools import wave_bench
    errs = {}
    cpu = [[t.cpu() for t in a[:5]] for a, _ in launches["poh_verify"]]
    plain = poh.poh_verify_plain(*[torch.cat(c) for c in zip(*cpu)],
                                 hashes_per_tick)
    got = torch.cat([out.cpu() for _, out in launches["poh_verify"]])
    errs["poh_verify"] = int((got.int() - plain.int()).abs().max())
    width = max(a[0].shape[1] for a, _ in launches["lthash"])
    msg = torch.cat([torch.nn.functional.pad(a[0].cpu(), (
        0, width - a[0].shape[1])) for a, _ in launches["lthash"]])
    lens = torch.cat([a[1].cpu() for a, _ in launches["lthash"]])
    got = torch.cat([out.cpu() for _, out in launches["lthash"]])
    errs["lthash"] = int((got - b3.lthash_plain(msg, lens)).abs().max())
    timed = {}
    for name in ("poh_verify", "lthash"):
        ls = sorted(launches[name], key=lambda x: x[0][0].shape[0])
        timed[name] = []
        for a, _ in {id(x): x for x in (ls[len(ls) // 2], ls[-1])}.values():
            if name == "poh_verify":
                np_a = [t.cpu().numpy() for t in a[:5]]
                st = stats_of(
                    wave_bench.graph_ms(
                        lambda: cuda_sha256.poh_verify(*a), ITERS),
                    cuda_ms(lambda: poh.poh_verify_plain(*a), 1),
                    poh_work(np_a, hashes_per_tick)[1]
                    * SHA256_OPS_PER_BLOCK,
                    a[0].shape[0] * (3 * 32 + 4 + 1 + 1))
                st["shape"] = f"{a[0].shape[0]} entries"
            else:
                w = b3_work(a[1].cpu().numpy(), "lthash")
                st = stats_of(
                    wave_bench.graph_ms(lambda: cuda_blake3.lthash(*a),
                                        ITERS),
                    cuda_ms(lambda: b3.lthash_plain(*a), 1), w["ops"],
                    w["bytes"])
                st["shape"] = (f"{a[0].shape[0]} lanes x "
                               f"{a[0].shape[1]} bytes")
            timed[name].append(st)
    return errs, timed


def run_follower(root, dev, card, counts, reset_counts, wires12):
    """Phase 17: the follower's check. 17a in process on phase 12's
    mirrored wires: the port's ShredRecoverCore, then ReplayCore on the
    card (a slice at a time, each launch of poh_verify and lthash
    recorded and held to its plain version) and on the CPU (one
    release): every slot's bank hash and PoH tip equal, no PoH failure,
    the same executions; a flipped entry hash counted as a PoH failure;
    FEC sets that lost as many data shreds as they have parity shreds
    recovered into the same slices. (The topology's follower, booted by
    17b until it was cut for the script's time, runs in phase 24.)
    -> (record, the in-process path's launch counts, {kernel:
    max_abs_err}, {kernel: [stats]})."""
    from firedancer_tpu_torch.disco.tiles import _synth_genesis
    from firedancer_tpu_torch.ops import cuda_blake3, cuda_sha256
    from firedancer_tpu_torch.tiles.shred import parse_slice
    from firedancer_tpu_torch.tools import blake3_bench
    pub, gen_n, hpt = follower_cfg(root)
    genesis = _synth_genesis(gen_n)

    # 17a. in process, on phase 12's mirrored wires
    log(f"== 17a. follower in process: ShredRecoverCore and ReplayCore on "
        f"phase 12's {len(wires12)} mirrored wires, on the card and on the "
        f"CPU {card}")
    t0 = time.perf_counter()
    slices, rec = recover_slices(pub, wires12)
    recover_s = time.perf_counter() - t0
    assert slices and rec.metrics["slots_done"] > 1, rec.metrics
    launches = {"poh_verify": [], "lthash": []}
    k_poh, k_lt = cuda_sha256.poh_verify, cuda_blake3.lthash

    def rec_poh(*a):
        out = k_poh(*a)
        launches["poh_verify"].append((a, out))
        return out

    def rec_lt(*a):
        out = k_lt(*a)
        launches["lthash"].append((a, out))
        return out
    spans = {"poh": [], "bank_hash": []}
    cuda_sha256.poh_verify, cuda_blake3.lthash = rec_poh, rec_lt
    try:
        reset_counts()
        card_core, card_s = replay_slices(
            slices, genesis, hpt, DEVICE, True,
            on_span=lambda kind, ns: spans[kind].append(ns))
        path = counts()
    finally:
        cuda_sha256.poh_verify, cuda_blake3.lthash = k_poh, k_lt
    cpu_core, cpu_s = replay_slices(slices, genesis, hpt, "cpu", False)
    log(f"17a: card replay {card_s:.3f} s a slice at a time, CPU "
        f"{cpu_s:.3f} s in one release, recovery {recover_s:.3f} s "
        f"{card}")
    # the gauges (buffered, behind) are taken at a release: one a slice
    # on the card, one for all on the CPU
    cm, pm = ({k: v for k, v in c.metrics.items()
               if k not in ("buffered", "behind")}
              for c in (card_core, cpu_core))
    assert card_core.bank_hash_of == cpu_core.bank_hash_of, \
        "17a: bank hashes on the card != on the CPU"
    assert card_core.hash_of == cpu_core.hash_of
    assert card_core.out_ring.frames == cpu_core.out_ring.frames
    assert cm == pm, (cm, pm)
    assert cm["poh_fail"] == 0 and cm["slots_replayed"] == \
        rec.metrics["slots_done"], cm
    assert cm["txns"] > 0 and path["poh_verify"] > 0 and path["lthash"] > 0, \
        (cm, path)
    assert path["poh_verify"] == len(launches["poh_verify"]) and \
        path["lthash"] == len(launches["lthash"]), path
    errs, timed = follower_kernel_times(launches, hpt, blake3_bench.work)
    assert errs == {"poh_verify": 0, "lthash": 0}, errs
    # a flipped byte in the first entry hash of the second slot's first
    # slice (slice header 13 + num_hashes 4): its PoH check fails
    slot_of = [parse_slice(f)[0] for f in slices]
    k = next(i for i, sl in enumerate(slot_of) if sl != slot_of[0])
    end = max(i for i, sl in enumerate(slot_of) if sl == slot_of[k]) + 1
    bad = [bytearray(f) for f in slices[:end]]
    bad[k][17] ^= 1
    tamper_core, _ = replay_slices([bytes(f) for f in bad], genesis, hpt,
                                   DEVICE, True)
    assert tamper_core.metrics["poh_fail"] == 1, tamper_core.metrics
    drop, chosen = lossy_drop(wires12)
    t0 = time.perf_counter()
    lossy, lrec = recover_slices(pub, wires12, drop)
    lossy_s = time.perf_counter() - t0
    assert lossy == slices, "17a: recovered slices != the lossless ones"
    # beyond the sets the ring's oldest wires left short, which both runs
    # recover from parity alike
    recovered = lrec.resolver.metrics["recovered"] \
        - rec.resolver.metrics["recovered"]
    assert recovered == len(drop) > 0, (lrec.resolver.metrics, len(drop))
    log(f"17a: {len(slices)} slices, {cm['slots_replayed']} slots, "
        f"{cm['txns']} txns ({cm['exec_ok']} ok, {cm['exec_fail']} failed), "
        f"{cm['entries']} entries; card == CPU in every slot's bank hash "
        f"and PoH tip, poh_fail 0; launches {path}, each == plain "
        f"(max_abs_err 0); PoH span p50/p99 {np.percentile(spans['poh'], 50) / 1e6:.3f}"
        f"/{np.percentile(spans['poh'], 99) / 1e6:.3f} ms, bank-hash fold "
        f"{np.percentile(spans['bank_hash'], 50) / 1e6:.3f}/"
        f"{np.percentile(spans['bank_hash'], 99) / 1e6:.3f} ms; flipped "
        f"entry hash in slot {slot_of[k]}: poh_fail 1; {len(chosen)} FEC "
        f"sets lost {len(drop)} data shreds, all recovered "
        f"({recovered}) into the same slices in "
        f"{lossy_s:.2f} s {card}")
    for name, sts in timed.items():
        for st in sts:
            log(f"{name} at the replay's {st['shape']}: kernel "
                f"{st['ms']:.5f} ms (CUDA graph of {ITERS}), plain "
                f"{st['plain_ms']:.3f} ms, bound {st['bound_ms']:.6f} ms by "
                f"{st['bound_by']}, {st['ms'] / st['bound_ms']:.0f}x {card}")

    rec17 = {
        "slots_replayed": cm["slots_replayed"], "txns_replayed": cm["txns"],
        "exec_ok": cm["exec_ok"], "exec_fail": cm["exec_fail"],
        "entries": cm["entries"], "card_replay_s": card_s,
        "cpu_replay_s": cpu_s, "recover_s": recover_s,
        "lossy_recover_s": lossy_s,
        "inproc_poh_span_p50_ms": np.percentile(spans["poh"], 50) / 1e6,
        "inproc_poh_span_p99_ms": np.percentile(spans["poh"], 99) / 1e6,
        "inproc_hash_span_p50_ms":
            np.percentile(spans["bank_hash"], 50) / 1e6,
        "inproc_hash_span_p99_ms":
            np.percentile(spans["bank_hash"], 99) / 1e6,
        "kernel_ms": {name: [(st["shape"], st["ms"], st["bound_ms"])
                             for st in sts] for name, sts in timed.items()},
        "card": nvidia_smi()}
    return rec17, path, errs, timed


def run_fault_drills(root, card, frames7, out7, m7, rec10a) -> dict:
    """Phase 18 (18a in process, 18b traced topology, 18c the chaos
    drill). -> record."""
    # 18a. VerifyTile(batch=2048) in process with a chaos plan
    log(f"== 18a. verify tile faults in process: VerifyTile(batch="
        f"{TILE_BATCH}) on phase 7's frames {card}")
    # with a verdict deadline: each wait spins on Event.query
    out, m, _, _ = run_tile([frames7], TILE_FRAMES, device_timeout_s=30.0,
                            chaos={"events": [{"action": "fail_dispatch",
                                               "count": 2}]})
    assert (m["device_errors"], m["cpu_fallback"]) == (2, 0), m
    assert out == out7 and {k: m[k] for k in m if k != "device_errors"} \
        == {k: m7[k] for k in m7 if k != "device_errors"}, \
        "18a: the retried run's frames or counts differ from phase 7's"
    log(f"18a transient: fail_dispatch count=2 absorbed by the retries, "
        f"verdict waits under a 30 s deadline: device_errors 2, "
        f"cpu_fallback 0, {len(out)} frames out == phase 7's, "
        f"{m['batches']} batches")
    # a persistent failure: the first dispatch raises after its retries
    try:
        run_tile([frames7[:64]], 128, chaos=PERSISTENT)
        raise AssertionError("18a: a persistent dispatch failure did not "
                             "raise")
    except RuntimeError as e:
        assert "dispatch failed 3 times" in str(e), e
    log("18a persistent: fail_dispatch count=-1: poll_once raised after "
        "the 3 attempts (no CPU path)")

    # 18b. cfg/sigverify.toml at full width with [trace] on
    log(f"== 18b. topology traced: cfg/sigverify.toml, {TOPO_FRAMES} "
        f"frames, [trace] depth {TRACE_DEPTH}, four tile processes {card}")
    unique = TILE_UNIQUE
    rec18b, v = run_topology(
        root, "18b", TOPO_FRAMES, trace={"enable": True,
                                         "depth": TRACE_DEPTH},
        on_halted=lambda runner: trace_report(root, runner, unique))
    tr = rec18b["trace"]
    log(f"18b: traced e2e {rec18b['e2e_tps']:.0f} frames/s ({TOPO_FRAMES} "
        f"in {rec18b['e2e_wall_s']:.4f} s), untraced 10a "
        f"{rec10a['e2e_tps']:.0f} ({rec10a['e2e_wall_s']:.4f} s) in this "
        f"call; verify work p99 {rec18b['verify_work_p99_ms']:.3f} ms "
        f"(10a {rec10a['verify_work_p99_ms']:.3f}); verify WORK spans "
        f"{tr['verify_work_spans']}, the first {tr['verify_first_work_ms']:.3f}"
        f" ms, the longest {tr['verify_max_work_ms']:.3f} ms (productive "
        f"poll {tr['verify_max_work_poll']}, {tr['verify_max_work_frags']} "
        f"frags); "
        f"{tr['tpu_dispatch_spans']} tpu_dispatch spans; {tr['lineaged']} "
        f"frames lineaged verify -> dedup -> sink; per-link "
        f"{json.dumps(tr['link_us'])} {card}")

    # 18c. cfg/chaos.toml: the sink crash drill
    log(f"== 18c. topology: cfg/chaos.toml, the sink crash drill {card}")
    rec18c = run_chaos_drill(root, "18c")
    log(f"18c: the sink crashed once its rx reached 32 and restarted once "
        f"({rec18c['recovery_ms']:.1f} ms from the crash record to the "
        f"respawn's boot), black box '{rec18c['blackbox_reason']}' with "
        f"{rec18c['blackbox_events']} events ending chaos, down; dedup "
        f"passed {rec18c['dedup_tx']} of {rec18c['unique']} unique, every "
        f"tile halted with exit 0 {card}")
    return {"transient": {"device_errors": m["device_errors"],
                          "frames_out": len(out)},
            "traced": {k: rec18b[k] for k in (
                "e2e_tps", "e2e_wall_s", "boot_s", "verify_work_p50_ms",
                "verify_work_p99_ms", "tpu_p50_ms", "tpu_p99_ms", "trace")},
            "untraced_10a": {k: rec10a[k] for k in (
                "e2e_tps", "e2e_wall_s", "verify_work_p50_ms",
                "verify_work_p99_ms")},
            "chaos": rec18c, "card": nvidia_smi()}


def run_gossip_trio(card) -> dict:
    """Phase 19b: three gossip tiles on the card over UDP on localhost, in
    process (each polled, then its housekeeping run, as its stem would),
    with device_verify and gossvf_bulk: g0 bootstraps to g1 and g2 and
    polices its door with cfg/flood.toml's [shed] policy, the two others
    staked by origin and by socket. They converge (every node holds the
    three contact infos and votes); then GOSSIP_SPAM flood_crds_spam
    datagrams from as many fake TEST-NET-2 addresses (pushes: never
    answered) and GOSSIP_FORGED with a forged value go into g0's inject;
    g0's peer table stays at most max_peers after every one, and a value
    g1 publishes after the flood still lands on g0. -> record."""
    from firedancer_tpu_torch.flamenco import gossip_wire as gw
    from firedancer_tpu_torch.gossip.crds import KIND_NODE_INSTANCE, KIND_VOTE
    from firedancer_tpu_torch.tiles.gossip import GossipTile
    from firedancer_tpu_torch.tiles.synth import make_signed_txns
    from firedancer_tpu_torch.utils.chaos import attack_frames
    from firedancer_tpu_torch.utils.ed25519_ref import keypair
    seeds = [hashlib.sha256(b"smoke-gossip-%d" % i).digest()
             for i in range(3)]
    pubs = [keypair(sd)[2] for sd in seeds]
    vote_txn = make_signed_txns(1, seed=19)[0]
    t0 = time.perf_counter()
    kw = dict(device_verify=True, gossvf_bulk=True, device=DEVICE)
    g1, g2 = (GossipTile(sd, **kw) for sd in seeds[1:])
    shed = {"rate_pps": 300.0, "burst": 8, "max_peers": 64, "min_stake": 1,
            "overload_hold_s": 2.0, "stakes": {
                **{p.hex(): 1000 for p in pubs[1:]},
                **{f"127.0.0.1:{g.addr[1]}": 1000 for g in (g1, g2)}}}
    g0 = GossipTile(seeds[0], entrypoints=[g1.addr, g2.addr], shed=shed,
                    **kw)
    tiles = [g0, g1, g2]
    boot_s = time.perf_counter() - t0

    def drive(done, what, limit_s=120.0) -> tuple[int, float]:
        t = time.perf_counter()
        for r in range(100000):
            for g in tiles:
                g.poll_once()
            for g in tiles:
                g.housekeeping()
            if done():
                return r + 1, time.perf_counter() - t
            assert time.perf_counter() - t < limit_s, \
                f"19b: {what} not done: {[g.metrics for g in tiles]}"
            time.sleep(0.002)
    try:
        for i, g in enumerate(tiles):
            g.publish(KIND_VOTE, 0, gw.encode_vote(0, pubs[i], vote_txn,
                                                  1000 + i))
        rounds, conv_s = drive(lambda: all(
            g.metrics["values"] >= 6 and g.metrics["contacts"] == 3
            for g in tiles), "convergence")
        for g in tiles:
            votes = {v.origin for v in g.node.crds.values.values()
                     if v.kind == KIND_VOTE}
            assert votes == set(pubs), "19b: a node lacks a vote"
            assert g.metrics["bad_msg"] == 0 and g.metrics["gossvf_bad"] == 0
        spam = attack_frames("flood_crds_spam", GOSSIP_SPAM, seed=17)
        forged = []
        for f in spam[:GOSSIP_FORGED]:
            f = bytearray(f)
            f[44 + 40] ^= 0x10        # S of the first value's signature
            forged.append(bytes(f))
        peers_max = 0
        t = time.perf_counter()
        for k, f in enumerate(spam + forged):
            g0.inject(f, (f"198.51.100.{k % 254 + 1}", 1024 + k % 60000))
            peers_max = max(peers_max, len(g0.shed.peers))
        inject_s = time.perf_counter() - t
        assert peers_max <= 64, f"19b: peers reached {peers_max}"
        g0.poll_once()                # its gauges, before the late value
        m0 = dict(g0.metrics)
        late = gw.encode_node_instance(pubs[1], 99_000, 1, 2)
        g1.publish(KIND_NODE_INSTANCE, 0, late)
        drive(lambda: (g0.node.crds.get(pubs[1], KIND_NODE_INSTANCE)
                       is not None), "the staked value after the flood")
        assert g0.node.crds.get(pubs[1], KIND_NODE_INSTANCE).data == late
        g0.poll_once()
        m = dict(g0.metrics)
        assert m["peers"] <= 64 and m["gossvf_bad"] >= GOSSIP_FORGED
        rec = {"boot_s": boot_s, "converge_rounds": rounds,
               "converge_s": conv_s, "spam": len(spam),
               "spam_forged": len(forged), "inject_s": inject_s,
               "peers_max": peers_max, "gossvf_bad": m["gossvf_bad"],
               "shed": m["shed"], "shed_unstaked": m["shed_unstaked"],
               "bad_msg": m["bad_msg"], "values": m["values"],
               "after_flood": {k: m0[k] for k in ("rx", "values", "peers")}}
        log(f"19b: converged in {rounds} rounds ({conv_s:.2f} s, boot "
            f"{boot_s:.2f} s with the bulk warmups); {len(spam)} spam + "
            f"{len(forged)} forged datagrams into g0 in {inject_s:.2f} s, "
            f"peers at most {peers_max}; g0 gossvf_bad {m['gossvf_bad']}, "
            f"shed {m['shed']}, shed_unstaked {m['shed_unstaked']}, "
            f"values {m['values']} {card}")
        return rec
    finally:
        for g in tiles:
            g.close()


def _flood_boot(root, tag, shed, slo=None):
    """cfg/flood.toml with `shed` over its [shed] section and the verify
    tile on DEVICE, booted as tile processes -> (runner, boot s, sock
    port). With `slo` (an [slo] section over the file's) the metric tile
    runs and judges; without it the boot drops the metric tile and the
    [slo] section, as bench.py's capacity boot has none."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    cfg = load_config(
        os.path.join(root, "firedancer_tpu_torch", "cfg", "flood.toml"),
        overrides={"shed": shed,
                   "tile": [{"name": "verify", "device": DEVICE}],
                   **({} if slo is None else {"slo": slo})})
    if slo is None:
        cfg.pop("slo")
        cfg["tile"] = [t for t in cfg["tile"] if t["kind"] != "metric"]
    runner = TopologyRunner(build_topology(
        cfg, name=f"smoke19{tag}{os.getpid()}").build())
    t0 = time.perf_counter()
    try:
        runner.start()
        runner.wait_running(timeout_s=300)
    except BaseException:
        runner.halt()
        runner.close()
        raise
    return runner, time.perf_counter() - t0, \
        int(runner.metrics("sock")["port"])


def _flood_halt(runner, tag) -> dict:
    """Halt, require every tile's exit code 0 -> the last metrics."""
    runner.halt()
    for tn, p in runner.procs.items():
        assert p.exitcode == 0, f"19c {tag}: tile {tn} exit code {p.exitcode}"
    return {tn: runner.metrics(tn) for tn in runner.procs}


def _flood_drained(runner, tag, timeout_s=120):
    """Wait until every datagram the door took is decided, the sink has
    what dedup forwarded, and nothing moves for half a second."""
    deadline, last = time.time() + timeout_s, None
    while True:
        runner.check_failures()
        m = {tn: runner.metrics(tn)
             for tn in ("sock", "verify", "dedup", "sink")}
        v = m["verify"]
        now = (m["sock"]["rx"], v["rx"], v["tx"], m["sink"]["rx"])
        if v["rx"] == m["sock"]["rx"] and m["sink"]["rx"] == \
                m["dedup"]["tx"] and v["tx"] + v["verify_fail"] \
                + v["dedup_drop"] + v["parse_fail"] == v["rx"] \
                and now == last:
            return m
        assert time.time() < deadline, f"19c {tag}: not drained: {m}"
        last = now
        time.sleep(0.5)


def run_flood_capacity(root, card, pool, staked) -> dict:
    """Phase 19c, boot 1 (bench.py _flood_bench's boot 1, :1183-1241):
    cfg/flood.toml without its metric tile, two staked peers whose token
    buckets do not bind (rate and burst raised; the watermark, overload
    and drop-newest stay armed). First the capacity probe: a
    WindowSender keeps the ring ahead of verify full of distinct valid
    txns from `pool`; the sink's rate over FLOOD_CAP_S after
    FLOOD_CAP_FILL_S (or until the pool runs dry) is the capacity. Then,
    on the same boot once drained, the unsaturated clean reference: a
    PacedSender at clean_pps = FLOOD_CLEAN_SHARE x capacity, capped by
    the staked pool over FLOOD_PROTOCOL_S (bench.py caps it over 120 s
    of its longer protocol), from `staked`; the sink's rate over
    FLOOD_REF_S after FLOOD_REF_SETTLE_S is the reference. Held: the
    window lasted at least FLOOD_CAP_MIN_S, the verify tile saw a
    saturated ingest (at least FLOOD_CAP_FULL of the window's lanes went
    through the RLC prefilter, which runs on full gathers), every frame
    that reached the sink is valid and distinct (no drop but the
    door's), cpu_fallback and device_errors 0, every tile exits 0. ->
    record with capacity_fps, clean_pps, clean_ref_fps, floor (bench.py's
    0.8 x min(clean_ref, clean_pps)) and ref_sent (the staked txns the
    reference used)."""
    import socket
    from firedancer_tpu_torch.tools.paced_sender import (PacedSender,
                                                         WindowSender)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    ref = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    ref.bind(("127.0.0.1", 0))
    keys = {f"127.0.0.1:{s.getsockname()[1]}": 1000 for s in (probe, ref)}
    runner, boot_s, port = _flood_boot(
        root, "cap", {"stakes": keys, "rate_pps": 1e9, "burst": 1e9})
    sender = None
    try:
        depth = runner.plan["links"]["sock_verify"]["depth"]

        def sink_rx():
            runner.check_failures()
            return runner.metrics("sink")["rx"]
        sender = WindowSender(pool, port, sink_rx, depth - 64,
                              sock=probe).start()
        time.sleep(FLOOD_CAP_FILL_S)
        v0, rx0, c0 = runner.metrics("verify"), sink_rx(), \
            time.perf_counter()
        # the window ends FLOOD_CAP_S on, or when the pool runs dry (the
        # ring's backlog still holds verify saturated then)
        while time.perf_counter() - c0 < FLOOD_CAP_S and not sender.dry:
            time.sleep(0.01)
        v1, rx1, c1 = runner.metrics("verify"), sink_rx(), \
            time.perf_counter()
        sent = sender.stop()
        sender = None
        _flood_drained(runner, "capacity")
        assert c1 - c0 >= FLOOD_CAP_MIN_S, \
            f"19c capacity: the pool of {len(pool)} ran dry " \
            f"{c1 - c0:.3f} s into the window " \
            f"({(rx1 - rx0) / (c1 - c0):.1f} frames/s)"
        cap = (rx1 - rx0) / (c1 - c0)
        # the unsaturated clean reference on the same boot
        clean_pps = min(FLOOD_CLEAN_SHARE * cap,
                        len(staked) / FLOOD_PROTOCOL_S)
        sender = PacedSender(staked, port, clean_pps, sock=ref).start()
        time.sleep(FLOOD_REF_SETTLE_S)
        rx2, c2 = sink_rx(), time.perf_counter()
        time.sleep(FLOOD_REF_S)
        rx3, c3 = sink_rx(), time.perf_counter()
        ref_sent = sender.stop()
        sender = None
        clean_ref = (rx3 - rx2) / (c3 - c2)
        _flood_drained(runner, "clean reference")
        m = _flood_halt(runner, "capacity")
    finally:
        if sender is not None:
            sender.stop()
        runner.halt()
        runner.close()
    lanes = v1["rx"] - v0["rx"]
    full = (v1["rlc_lanes"] - v0["rlc_lanes"]) / max(1, lanes)
    sock, v = m["sock"], m["verify"]
    assert full >= FLOOD_CAP_FULL, \
        f"19c capacity: only {full:.3f} of the window's lanes came in " \
        f"full gathers; the probe did not saturate verify"
    assert m["sink"]["rx"] + sock["shed"] + sock["shed_overflow"] == \
        sent + ref_sent and v["verify_fail"] == v["dedup_drop"] == 0, \
        f"19c capacity: {sent} + {ref_sent} sent, sink {m['sink']['rx']}; " \
        f"sock {sock}, verify {v}"
    no_fallback("19c capacity verify", v)
    floor = 0.8 * min(clean_ref, clean_pps)
    rec = {"capacity_fps": cap, "boot_s": boot_s, "sent": sent,
           "window_lanes": lanes, "window_full_share": full,
           "clean_pps": clean_pps, "clean_ref_fps": clean_ref,
           "ref_sent": ref_sent, "floor": floor,
           "verify": {k: v[k] for k in ("rx", "tx", "batches",
                                        "rlc_batches", "rlc_pass",
                                        "rlc_lanes")},
           "sock": {k: sock[k] for k in ("rx", "shed", "shed_overflow",
                                         "backpressure")}}
    log(f"19c capacity: {cap:.2f} staked frames/s at the sink over "
        f"{c1 - c0:.3f} s with the ring ahead of verify kept full "
        f"({full:.4f} of the window's {lanes} lanes through the prefilter's "
        f"full gathers; {sent} sent, {sock['shed']} shed at the door, "
        f"{v['batches']} strict batches, {v['rlc_batches']} RLC, boot "
        f"{boot_s:.2f} s); clean reference {clean_ref:.2f} frames/s at "
        f"{clean_pps:.2f} offered ({FLOOD_CLEAN_SHARE:g} x capacity, "
        f"capped by {len(staked)} staked txns over {FLOOD_PROTOCOL_S:g} s)"
        f", floor {floor:.2f}/s {card}")
    return rec


def run_flood_door(root, card, txns, cap) -> dict:
    """Phase 19c, boot 2 (bench.py _flood_bench's boot 2, :1243-1330):
    cfg/flood.toml under attack, judged by its metric tile's SLO engine
    with the target `sink.rx rate > floor/s` (fast_window_s
    FLOOD_SLO_FAST_S on this host, bench.py's rule; slow 20, burns 1.0
    and 0.5) and bench.py's per-peer rate max(20, 3 x clean_pps). A
    staked PacedSender runs at clean_pps (boot 1's `cap` record) from its
    [shed.stakes] key. Once a fast window has passed (FLOOD_SLO_SETTLE_S:
    the boot's breach, if any, has fired), as bench.py runs it: wait
    until the engine has evaluated with no breach (asserted), take the
    clean baseline over FLOOD_BASELINE_S, run the attack (FLOOD_SYBILS
    unstaked sockets sending attack_frames("flood_forged", 64) for
    FLOOD_ATTACK_S, spread over FLOOD_SWARM_PROCS worker processes, paced
    FLOOD_PACE_OVER above FLOOD_MULT x the capacity) counting the ticks
    the engine reads a breach, then give a breach up to FLOOD_CLEAR_S to
    clear. Then it drains and halts.

    Held: slo_evals > 0 and no breach before the attack; the swarm sent
    at least FLOOD_MULT x the capacity; the door shed the flood
    (shed_unstaked > 0) and the sock-fed verify tile ran the RLC
    prefilter (rlc_batches > 0); the staked txns are held, each loss
    where it happened: before the door, the staked datagrams the door
    never read (sent less its rx_staked) are no more than every peer's
    datagrams that it never read (under the flood the host's network
    stack loses some at the door's full socket); at the door, every
    staked datagram it read was shed by its gate (shed_staked) or
    published to verify (a tap on sock_verify), but for a short
    publish's stake-blind drops (shed_overflow); past the door, every
    staked txn published to verify is at the sink but for the
    prefilter's sheds (rlc_shed: a full chunk whose halves both fail is
    shed whole, a staked lane in it too); every frame that passed verify
    (a tap on verify_dedup) is a staked txn; peers <= 64; no watchdog
    trip; the door's overload was up at every tick the engine read a
    breach, the boot's included (the `_shed_slo_poll` coupling); cpu_fallback and device_errors 0; every
    tile exits 0. `txns`: the staked sender's pool of distinct txns. ->
    record with bench.py's flood_* keys."""
    import multiprocessing as mp
    import socket
    from concurrent.futures import ProcessPoolExecutor
    from firedancer_tpu_torch.tools.leader_drain import LinkTap
    from firedancer_tpu_torch.tools.paced_sender import PacedSender, swarm
    from firedancer_tpu_torch.utils.chaos import attack_frames
    capacity, clean_pps, floor = cap["capacity_fps"], cap["clean_pps"], \
        cap["floor"]
    staked = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    staked.bind(("127.0.0.1", 0))
    key = f"127.0.0.1:{staked.getsockname()[1]}"
    pool = len(txns)
    forged = attack_frames("flood_forged", 64, seed=29)
    procs = FLOOD_SWARM_PROCS
    swarm_pool = ProcessPoolExecutor(procs,
                                     mp_context=mp.get_context("spawn"))
    # every worker up before the clock starts: each holds one of these
    for f in [swarm_pool.submit(time.sleep, 0.5) for _ in range(procs)]:
        f.result()
    slo = {"fast_window_s": FLOOD_SLO_FAST_S, "slow_window_s": 20.0,
           "burn_fast": 1.0, "burn_slow": 0.5,
           "target": [{"name": "flood-goodput",
                       "expr": f"sink.rx rate > {floor:.1f}/s"}]}
    try:
        runner, boot_s, port = _flood_boot(
            root, "c", {"stakes": {key: 1000},
                        "rate_pps": max(20.0, 3 * clean_pps)}, slo=slo)
    except BaseException:
        swarm_pool.shutdown()
        raise
    senders, taps = [], []
    try:
        taps = [LinkTap(runner, "sock_verify", batch=1024),
                LinkTap(runner, "verify_dedup")]

        def metric():
            runner.check_failures()
            return runner.metrics("metric")

        def door_overload():
            # the sock tile trips its door at its next housekeeping (some
            # 10 ms apart) after the metric tile flushed the breach, then
            # flushes; a door that is not up within FLOOD_TRIP_S is not
            # coupled
            deadline = time.monotonic() + FLOOD_TRIP_S
            while True:
                up = runner.metrics("sock")["overload"]
                if up or time.monotonic() > deadline:
                    return up
                time.sleep(0.02)
        sender = PacedSender(txns, port, clean_pps, sock=staked).start()
        senders.append(sender)
        # the boot window legitimately starts breached (the metric tile
        # samples the sink's rate from its own RUN, before the verify tile
        # runs and the staked traffic flows): let a fast window pass, so
        # a boot breach has fired, then wait for the engine to see the
        # floor held, as bench.py does; a tick that reads a breach reads
        # the door's overload too
        overload_at_breach = []
        boot_ticks = 0
        settle = time.monotonic() + FLOOD_SLO_SETTLE_S
        deadline = settle + FLOOD_SLO_WAIT_S
        while time.monotonic() < deadline:
            mm = metric()
            if mm["slo_breach"]:
                boot_ticks += 1
                overload_at_breach.append(door_overload())
            elif mm["slo_evals"] > 0 and time.monotonic() >= settle:
                break
            time.sleep(0.2)
        mm = metric()
        assert mm["slo_evals"] > 0 and mm["slo_breach"] == 0, \
            f"19c: clean staked traffic never satisfied the floor: {mm}"
        pre_breaches = mm["slo_breaches"]
        rx0, c0 = runner.metrics("sink")["rx"], time.perf_counter()
        time.sleep(FLOOD_BASELINE_S)
        rx1, c1 = runner.metrics("sink")["rx"], time.perf_counter()
        clean = (rx1 - rx0) / (c1 - c0)
        mm = metric()
        assert mm["slo_breach"] == 0 and mm["slo_breaches"] == \
            pre_breaches, f"19c: the floor broke before the attack: {mm}"
        attack_pps = FLOOD_MULT * capacity * (1 + FLOOD_PACE_OVER)
        jobs = [swarm_pool.submit(swarm, forged, port, attack_pps / procs,
                                  FLOOD_SYBILS // procs, FLOOD_ATTACK_S)
                for _ in range(procs)]
        peers_peak = breach_ticks = 0
        while time.perf_counter() - c1 < FLOOD_ATTACK_S:
            peers_peak = max(peers_peak, runner.metrics("sock")["peers"])
            if metric()["slo_breach"]:
                breach_ticks += 1
                overload_at_breach.append(door_overload())
            time.sleep(0.2)
        rx2, c2 = runner.metrics("sink")["rx"], time.perf_counter()
        attacked = (rx2 - rx1) / (c2 - c1)
        overload_attack = runner.metrics("sock")["overload"]
        done = [j.result() for j in jobs]
        sent_forged = sum(n for n, _ in done)
        forged_pps = sum(n / sec for n, sec in done)
        # recovery: the staked sender runs on, and the breach must clear
        t_clear = time.perf_counter()
        deadline = time.monotonic() + FLOOD_CLEAR_S
        while time.monotonic() < deadline:
            if metric()["slo_breach"] == 0:
                break
            overload_at_breach.append(door_overload())
            time.sleep(0.2)
        clear_s = time.perf_counter() - t_clear
        mm = metric()
        sent = sender.stop()
        senders.clear()
        _flood_drained(runner, "attack", timeout_s=60)
        published, passed = (t.stop() for t in taps)
        taps = []
        m = _flood_halt(runner, "attack")
    finally:
        for p in senders:
            p.stop()
        swarm_pool.shutdown()
        for t in taps:
            t.close()            # its thread reads the ring
        runner.halt()
        runner.close()
    sock, v = m["sock"], m["verify"]
    staked_set = set(txns[:min(sent, pool)])
    at_verify = sum(f in staked_set for f in published)
    missing = sent - m["sink"]["rx"]
    # datagrams every peer sent that the door never read: lost in the
    # host's network stack under the flood (the door counts each one it
    # reads: published, shed, oversized or dropped at a short publish)
    door_read = sock["rx"] + sock["shed"] + sock["oversz"] \
        + sock["shed_overflow"]
    lost_before_door = sent + sent_forged - door_read
    staked_lost = sent - sock["rx_staked"]
    staked_unpublished = sock["rx_staked"] - sock["shed_staked"] - at_verify
    staked_past_door = at_verify - m["sink"]["rx"]
    trips = sum(mt.get("sup_watchdog_trips", 0) for mt in m.values())
    breaches = mm["slo_breaches"] - pre_breaches
    assert sent <= pool, f"19c: the staked sender wrapped its pool ({sent})"
    assert forged_pps >= FLOOD_MULT * capacity, \
        f"19c: the swarm sent {forged_pps:.0f}/s, under {FLOOD_MULT:g} x " \
        f"capacity {capacity:.2f}"
    assert sock["shed_unstaked"] > 0, f"19c: the door shed no flood: {sock}"
    assert v["rlc_batches"] > 0, f"19c: the prefilter never ran: {v}"
    assert 0 <= staked_lost <= lost_before_door, \
        f"19c: {sent} staked sent, the door read {sock['rx_staked']} of " \
        f"them; it never read {lost_before_door} of all the " \
        f"{sent + sent_forged} sent: {sock}"
    assert 0 <= staked_unpublished <= sock["shed_overflow"], \
        f"19c: the door read {sock['rx_staked']} staked, shed " \
        f"{sock['shed_staked']} and published {at_verify} of them: {sock}"
    assert 0 <= staked_past_door <= v["rlc_shed"], \
        f"19c: {at_verify} staked published to verify, sink " \
        f"{m['sink']['rx']}, prefilter shed {v['rlc_shed']}: verify {v}"
    assert all(f in staked_set for f in passed), \
        "19c: a frame that is not a staked txn passed verify"
    assert len(passed) == m["dedup"]["rx"] == m["sink"]["rx"], \
        f"19c: tap {len(passed)}, dedup {m['dedup']['rx']}"
    assert sock["peers"] <= 64, f"19c: peers {sock['peers']}"
    assert trips == 0, f"19c: {trips} watchdog trips"
    assert all(overload_at_breach), \
        f"19c: a breach with the door not in overload: {overload_at_breach}"
    no_fallback("19c verify", v)
    clean_eff = min(clean, clean_pps)
    flood = {
        "flood_capacity_tps": capacity,
        "flood_clean_ref_tps": cap["clean_ref_fps"],
        "flood_clean_tps": clean,
        "flood_goodput_tps": attacked,
        "flood_goodput_ratio": attacked / clean_eff if clean_eff else 0.0,
        "flood_offered_attack_pps": forged_pps,
        "flood_attack_mult": forged_pps / clean if clean else 0.0,
        "flood_shed_pct": 100.0 * sock["shed"] / max(1, sock["shed"]
                                                     + sock["rx"]),
        "flood_peers_peak": peers_peak,
        "flood_peers_bound": sock["peers"] <= 64,
        "flood_slo_breaches": breaches,
        "flood_slo_breach_final": mm["slo_breach"],
        "flood_watchdog_trips": trips,
        "flood_rlc_shed": v["rlc_shed"],
        "flood_rlc_batches": v["rlc_batches"],
        "flood_rlc_lanes": v["rlc_lanes"],
        "flood_rlc_pass": v["rlc_pass"],
        "flood_verify_fail": v["verify_fail"],
    }
    flood["flood_pass"] = (breaches == 0 and trips == 0
                           and flood["flood_peers_bound"]
                           and flood["flood_goodput_ratio"] >= 0.8)
    rec = {**flood, "staked_sent": sent, "forged_sent": sent_forged,
           "sink_rx": m["sink"]["rx"], "staked_missing": missing,
           "staked_lost_before_door": staked_lost,
           "door_staked_read": sock["rx_staked"],
           "door_staked_shed": sock["shed_staked"],
           "staked_at_verify": at_verify,
           "lost_before_door": lost_before_door,
           "boot_s": boot_s, "clean_pps": clean_pps, "floor": floor,
           "slo_fast_window_s": FLOOD_SLO_FAST_S, "slo_evals":
           mm["slo_evals"], "slo_boot_breaches": pre_breaches,
           "boot_breach_ticks": boot_ticks, "breach_ticks": breach_ticks,
           "overload_at_breach_ticks": len(overload_at_breach),
           "breach_clear_s": clear_s,
           "attack_paced_pps": attack_pps, "swarm_procs": procs,
           "overload_at_attack_end": overload_attack,
           "verify": {k: v[k] for k in (
               "rx", "tx", "verify_fail", "dedup_drop", "batches",
               "rlc_batches", "rlc_pass", "rlc_lanes", "rlc_shed", "rlc_ns",
               "cpu_fallback", "device_errors")},
           "sock": {k: sock[k] for k in (
               "rx", "shed", "shed_unstaked", "shed_overflow", "overload",
               "backpressure", "peers")}}
    log(f"19c flood {json.dumps(flood)}")
    log(f"19c attack: staked goodput {clean:.2f} frames/s clean at "
        f"{clean_pps:.2f} offered, {attacked:.2f} while {FLOOD_SYBILS} "
        f"sybils in {procs} processes sent {forged_pps:.0f} forged/s "
        f"({forged_pps / capacity:.3f} x capacity {capacity:.2f}; paced at "
        f"{attack_pps:.0f}) (ratio {flood['flood_goodput_ratio']:.4f}); the "
        f"SLO engine (sink.rx rate > {floor:.1f}/s over "
        f"{FLOOD_SLO_FAST_S:g} s) evaluated {mm['slo_evals']} times, "
        f"{breaches} breaches, {breach_ticks} ticks breached in the "
        f"attack, final {mm['slo_breach']} after {clear_s:.1f} s; "
        f"flood_pass {flood['flood_pass']}; {sent_forged} forged and "
        f"{sent} staked sent: {staked_lost} lost before the door (of "
        f"{lost_before_door} datagrams of all peers the door never read), "
        f"{sock['rx_staked']} read by the door, {sock['shed_staked']} shed "
        f"there, {at_verify} published to verify, {m['sink']['rx']} at the "
        f"sink ({missing} missing) against "
        f"prefilter-shed lanes {v['rlc_shed']}; verify rx {v['rx']}, "
        f"rlc_batches {v['rlc_batches']}, rlc_pass {v['rlc_pass']}, "
        f"rlc_shed {v['rlc_shed']}, strict batches {v['batches']}; sock rx "
        f"{sock['rx']}, shed {sock['shed']}, shed_unstaked "
        f"{sock['shed_unstaked']}, shed_overflow {sock['shed_overflow']}, "
        f"overload {overload_attack} at the attack's end, backpressure "
        f"{sock['backpressure']}, peers {sock['peers']} {card}")
    return rec


def run_front_door(root, card, counts, reset_counts):
    """Phase 19: the front door. 19a gossvf's packets on the card
    (tools/gossvf_bench.py), 19b the gossip trio, 19c cfg/flood.toml. A
    pool of worker processes (one torch thread each) signs 19c's staked
    txns (the capacity probe's and the staked sender's) and runs 19a's
    plain versions meanwhile; 19a's times and 19c run after it has
    stopped. -> (launches of 19a and 19b, record)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from firedancer_tpu_torch.tools import gossvf_bench as gb
    from firedancer_tpu_torch.tools.paced_sender import staked_pool
    t0 = time.perf_counter()
    workers = max(1, (os.cpu_count() or 2) - 1)
    chunk = -(-FLOOD_STAKED_POOL // workers)
    cap_chunk = -(-FLOOD_CAP_POOL // workers)
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"),
                             initializer=gb.one_thread) as pool:
        # the widest packets first: they are the longest jobs
        plain = {name: pool.submit(gb.verdicts, name, "cpu")
                 for name in reversed(gb.PACKETS)}
        signing = [pool.submit(staked_pool, chunk, 23 + k)
                   for k in range(workers)]
        cap_signing = [pool.submit(staked_pool, cap_chunk, 1000 + k)
                       for k in range(workers)]
        log(f"== 19a. gossvf on the card: packets of "
            f"{', '.join(gb.PACKETS)} values, both modes")
        reset_counts()
        got = {name: gb.verdicts(name, DEVICE) for name in gb.PACKETS}
        path_a = counts()
        log(f"19a launches {path_a}")
        assert min(path_a[k] for k in ("sha512_ram", "ed25519_verify",
                                       "msm_stage1", "msm_stage2")) > 0
        log("== 19b. three gossip tiles on the card over UDP, then "
            f"{GOSSIP_SPAM} flood_crds_spam datagrams")
        reset_counts()
        rec_b = run_gossip_trio(card)
        path_b = counts()
        log(f"19b launches {path_b}")
        assert min(path_b[k] for k in ("sha512_ram", "msm_stage1",
                                       "msm_stage2", "ed25519_verify")) > 0
        gb.compare(got, {name: f.result() for name, f in plain.items()})
        txns = [t for f in signing for t in f.result()]
        cap_txns = [t for f in cap_signing for t in f.result()]
    assert len(set(txns + cap_txns)) == len(txns) + len(cap_txns), \
        "19c: the staked pools repeat"
    log(f"19a: every packet's verdicts on the card == plain in both modes; "
        f"{len(cap_txns)} + {len(txns)} staked txns signed for 19c (the "
        f"pool's "
        f"{workers} workers: {time.perf_counter() - t0:.1f} s)")
    for name, modes in got.items():
        log(f"  {name}: {sum(modes['individual'])} of "
            f"{len(modes['individual'])} valid, bulk == individual")
    times = gb.time_modes(iters=GOSSVF_ITERS)
    for mode, by_n in times.items():
        log(f"19a {mode}: ms per packet " + ", ".join(
            f"{n} values {ms:.4f}" for n, ms in by_n.items())
            + f" ({GOSSVF_ITERS} packets each, CUDA events) {card}")
    log(f"== 19c. cfg/flood.toml: boot 1, the door's clean capacity (a "
        f"saturating staked sender) and the clean reference at "
        f"{FLOOD_CLEAN_SHARE:g} x it; boot 2 with the metric tile judging "
        f"sink.rx rate > 0.8 x the reference: a staked sender at the "
        f"reference's rate and, after the SLO wait and a "
        f"{FLOOD_BASELINE_S:g} s baseline, {FLOOD_SYBILS} sybils at "
        f"{FLOOD_MULT:g} x the capacity for {FLOOD_ATTACK_S:g} s {card}")
    rec_cap = run_flood_capacity(root, card, cap_txns, txns)
    rec_c = run_flood_door(root, card, txns[rec_cap["ref_sent"]:], rec_cap)
    path = {k: path_a[k] + path_b[k] for k in path_a}
    return path, {"gossvf_ms": times, "gossip": rec_b,
                  "flood_capacity": rec_cap, "flood": rec_c,
                  "launches_19a": path_a, "launches_19b": path_b}


_PROM_SAMPLE = None


def kernel_base(name: str) -> str:
    """A demangled kernel name without its return type, template
    arguments and parameters: "void sha512_kernel<true>(...)" ->
    "sha512_kernel"."""
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].split("(")[0]


def _prometheus_labels(text: str) -> tuple[set, set]:
    """Every line of a /metrics body is a TYPE line or a sample of a
    TYPE-declared family with a label block -> (tile labels, link
    labels). Raises on a line that does not parse."""
    import re
    global _PROM_SAMPLE
    if _PROM_SAMPLE is None:
        _PROM_SAMPLE = re.compile(
            r'^([a-zA-Z_:][a-zA-Z0-9_:]*)\{(.*)\} '
            r'(-?[0-9.]+(?:[eE][+-]?[0-9]+)?|\+Inf|NaN)$')
    assert text.endswith("\n"), "/metrics does not end with a newline"
    types, tiles, links = set(), set(), set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            types.add(line.split()[2])
            continue
        m = _PROM_SAMPLE.match(line)
        assert m, f"/metrics: unparseable line {line!r}"
        fam = m.group(1)
        for suf in ("_bucket", "_sum", "_count"):
            if fam.endswith(suf) and fam[:-len(suf)] in types:
                fam = fam[:-len(suf)]
        assert fam in types, f"/metrics: {fam} has no TYPE line"
        labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                 m.group(2)))
        if "tile" in labels:
            tiles.add(labels["tile"])
        if "link" in labels:
            links.add(labels["link"])
    return tiles, links


def run_capture_drill(root, card) -> dict:
    """Phase 21: the breach-triggered device capture on the card (the
    reference's drill, tests/test_prof.py:357-420, made to launch through
    the window). cfg/sigverify.toml with [prof] as the JAX package's
    cfg/default.toml:33-39 (hz 47, capture_ms 200, breach_capture
    ["verify"]), [slo] with `impossible-latency` (verify.work p99 < 1ns,
    fast_window_s 0.4), [trace] on verify and metric, a metric tile, the
    synth paced at CAPTURE_RATE_TPS over CAPTURE_FRAMES frames, the
    verify batch at CAPTURE_BATCH and its tcache at bench.py's leader
    depth (bench.py:434-442: below the unique pool, so replays are
    verified again instead of dropped before the card; the pool,
    CAPTURE_UNIQUE, larger than the verify tile's in-flight window). The
    verify tile, which a breach captures, warms
    its profiler at boot. Held: the doorbell acked and prof_captures >= 1;
    the manifest ok; its kernels name sha512_kernel (sha512_ram's entry)
    and ed25519_verify_kernel, each launched at least once in the window;
    EV_PROF_CAPTURE and EV_COMPILE in the verify ring; /metrics parses
    and names every tile and link; /healthz 200; /summary.json's first
    slo_history entry is impossible-latency's breach; the monitor's
    slo_breach_events recovers it from shm; prof.merged_chrome puts host
    slices of at least two tiles and the verify tile's kernels on one
    timeline (the kernels inside the verify ring's span). Reported: the
    card's busy share over the window. -> record."""
    import urllib.error
    import urllib.request
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco import monitor
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    from firedancer_tpu_torch.prof import merged_chrome, region_for
    from firedancer_tpu_torch.prof.device import capture_manifest_path
    from firedancer_tpu_torch.trace import read_rings
    cfg = load_config(
        os.path.join(root, "firedancer_tpu_torch", "cfg", "sigverify.toml"),
        overrides={
            "prof": {"enable": True, "hz": 47, "slots": 256, "ring": 2048,
                     "capture_ms": 200.0, "breach_capture": ["verify"]},
            "slo": {"fast_window_s": 0.4, "slow_window_s": 30.0,
                    "target": [{"name": "impossible-latency",
                                "expr": "verify.work p99 < 1ns"}]},
            "trace": {"enable": True, "depth": CAPTURE_TRACE_DEPTH,
                      "sample": 16, "tiles": ["verify", "metric"]},
            "tcache": [{"name": "verify_tc", "depth": CAPTURE_TCACHE}],
            "tile": [{"name": "synth", "count": CAPTURE_FRAMES,
                      "unique": CAPTURE_UNIQUE,
                      "rate_tps": CAPTURE_RATE_TPS},
                     {"name": "verify", "device": DEVICE,
                      "batch": CAPTURE_BATCH},
                     {"name": "metric", "kind": "metric", "port": 0}]})
    runner = TopologyRunner(build_topology(
        cfg, name=f"smoke21{os.getpid()}").build())
    plan = runner.plan
    manifest = capture_manifest_path(plan["topology"], "verify")
    try:
        t0 = time.perf_counter()
        runner.start()
        runner.wait_running(timeout_s=300)
        boot_s = time.perf_counter() - t0
        runner.wait_idle("verify", "prof_captures", 1, timeout_s=120,
                         poll_s=0.02)
        captured_s = time.perf_counter() - t0 - boot_s
        region = region_for(plan, runner.wksp, "verify")
        assert region.capture_ack >= 1, "21: the doorbell was never acked"
        port = runner.metrics("metric")["port"]

        def get(path):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()
        status, body = get("/metrics")
        assert status == 200, f"21: /metrics {status}"
        tiles, links = _prometheus_labels(body.decode())
        assert tiles == set(plan["tiles"]) and links == set(plan["links"]),\
            f"21: /metrics names {sorted(tiles)}, {sorted(links)}"
        health_status, body = get("/healthz")
        health = json.loads(body)
        assert health_status == 200 and health["ok"], f"21: {health}"
        status, body = get("/summary.json")
        summary = json.loads(body)
        first = summary["slo_history"][0]
        assert (first["target"], first["kind"]) == \
            ("impossible-latency", "breach"), summary["slo_history"]
        events = monitor.slo_breach_events(plan, runner.wksp)
        assert events and events[0]["target"] == "impossible-latency", \
            events
        vm = runner.metrics("verify")
        mm = runner.metrics("metric")
        runner.halt()
        for tn, p in runner.procs.items():
            assert p.exitcode == 0, f"21: tile {tn} exit code {p.exitcode}"
        with open(manifest) as f:
            doc = json.load(f)
        assert doc["ok"], f"21: the capture failed: {doc['error']}"

        by = {}
        for name, k in doc["kernels"].items():
            b = by.setdefault(kernel_base(name), {"launches": 0, "us": 0.0})
            b["launches"] += k["launches"]
            b["us"] += k["us"]
        for want in ("sha512_kernel", "ed25519_verify_kernel"):
            assert by.get(want, {}).get("launches", 0) >= 1, \
                f"21: the capture recorded no {want}: {sorted(doc['kernels'])}"
        evs = read_rings(plan, runner.wksp, tiles=["verify"])["verify"]
        names = {e["ev"] for e in evs}
        assert {"prof_capture", "compile"} <= names, sorted(names)
        bundle = merged_chrome(plan, runner.wksp)
        thread = {e["tid"]: e["args"]["name"] for e in bundle["traceEvents"]
                  if e.get("name") == "thread_name"}
        slices = {}
        for e in bundle["traceEvents"]:
            if e.get("ph") == "X" and e.get("tid") in thread:
                slices.setdefault(thread[e["tid"]], []).append(e)
        hosts = [t for t in slices if t.endswith("/host")]
        assert len(hosts) >= 2, f"21: host slices of {hosts}"
        kern = slices.get("verify/device", [])
        assert kern, "21: no kernel on the verify tile's device track"
        ring_ts = [e["ts"] for e in evs]
        lo, hi = min(ring_ts) / 1e3, max(ring_ts) / 1e3
        assert all(lo <= e["ts"] <= hi for e in kern), \
            "21: a kernel lies outside the verify ring's span"
    finally:
        runner.halt()
        runner.close()
        for path in (manifest,):
            if os.path.exists(path):
                os.unlink(path)
    no_fallback("21 verify", vm)
    rec = {"boot_s": boot_s, "capture_after_run_s": captured_s,
           "prof_captures": vm["prof_captures"],
           "slo_breaches": mm["slo_breaches"], "slo_evals": mm["slo_evals"],
           "device_busy_share": doc["device_busy_share"],
           "device_busy_ms": doc["device_busy_ms"],
           "recorded_ms": doc["recorded_ms"], "window_ms": doc["window_ms"],
           "start_ms": doc["start_ms"], "stop_ms": doc["stop_ms"],
           "warm_ms": doc["warm_ms"], "clock": doc["clock"],
           "kernels": by, "kernel_names": sorted(doc["kernels"]),
           "verify_batches": vm["batches"],
           "tpu_jit_compiles": vm["tpu_jit_compiles"],
           "tpu_mem_bytes": vm["tpu_mem_bytes"],
           "host_tracks": sorted(hosts), "device_slices": len(kern),
           "healthz": health_status, "breach_events": events}
    log(f"21 record {json.dumps(rec)}")
    log(f"21: a breach of impossible-latency rang the verify tile's "
        f"doorbell {captured_s:.2f} s after RUN (boot {boot_s:.1f} s, the "
        f"profiler's start-up {doc['warm_ms']:.1f} ms paid at boot); the "
        f"{doc['recorded_ms']:.1f} ms window (start {doc['start_ms']:.2f} "
        f"ms, stop {doc['stop_ms']:.2f} ms) recorded " + ", ".join(
            f"{n} x{k['launches']} ({k['us']:.1f} µs)"
            for n, k in sorted(by.items()))
        + f"; the card busy {100 * doc['device_busy_share']:.2f}% of the "
        f"window ({doc['device_busy_ms']:.3f} ms) {card}")
    return rec


def run_exec_kill(root, card) -> dict:
    """Phase 20c: cfg/exec.toml (two exec shards) booted through the config
    loader and the runner app.run uses, verify, bank and exec tiles on
    the card; exec0 crashes at its first frames (a seeded chaos plan) and
    the restart policy respawns it. The loop drains by the conservation
    rule with the resolv tile's drops, every transfer applies exactly
    once (the store's lamports are genesis's less the fees burned), and
    every tile exits 0 after the halt. -> record."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    from firedancer_tpu_torch.disco.tiles import _synth_genesis
    from firedancer_tpu_torch.pack.scheduler import FEE_PER_SIGNATURE
    from firedancer_tpu_torch.tools import exec_scale, leader_drain
    cfg = load_config(
        os.path.join(root, "firedancer_tpu_torch", "cfg", "exec.toml"),
        overrides={"tile": [
            {"name": "verify", "device": DEVICE},
            {"name": "bank0", "device": DEVICE},
            {"name": "exec", "device": DEVICE,
             "chaos": [{"seed": 1, "events": [{"action": "crash",
                                                "at_rx": 1}]}, None],
             "supervise": {"policy": "restart", "backoff_s": 0.05,
                           "max_restarts": 3, "window_s": 60.0}}]})
    count = next(t["count"] for t in cfg["tile"] if t["name"] == "synth")
    unique = next(t["genesis_synth"] for t in cfg["tile"]
                  if t["name"] == "bank0")
    runner = TopologyRunner(build_topology(
        cfg, name=f"smoke20c{os.getpid()}").build())
    try:
        t0 = time.perf_counter()
        runner.start()
        runner.wait_running(timeout_s=300)
        boot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner.wait_idle("synth", "tx", count, timeout_s=300, poll_s=0.002)
        dropped = leader_drain.wait_drained(runner, count, timeout_s=300)
        wall = time.perf_counter() - t0
        leader_drain.wait_restarted(runner, "exec0", timeout_s=120)
        runner.halt()
        m = {tn: runner.metrics(tn) for tn in runner.plan["tiles"]}
        exits = {tn: p.exitcode for tn, p in runner.procs.items()}
        lamports = exec_scale.store_lamports(runner)
    finally:
        runner.halt()
        runner.close()
    b, p = m["bank0"], m["pack"]
    burned = FEE_PER_SIGNATURE * b["transfers"]
    genesis = sum(_synth_genesis(unique).values())
    for key, got, want in (
            ("bank0.txns + drops", b["txns"] + dropped, count),
            ("pack.completions", p["completions"], p["microblocks"]),
            ("bank0.transfers", b["transfers"], b["txns"] - b["exec_skip"]),
            ("bank0.exec_fail", b["exec_fail"], 0),
            ("store lamports", lamports, genesis - burned)):
        assert got == want, f"20c: {key} = {got}, expected {want}"
    assert m["exec0"]["sup_restarts"] >= 1, f"20c: no restart {m['exec0']}"
    assert all(c == 0 for c in exits.values()), f"20c: exit codes {exits}"
    no_fallback("20c verify", m["verify"])
    return {"boot_s": boot_s, "wall_s": wall, "count": count,
            "dropped": dropped, "transfers": b["transfers"],
            "exec_redispatch": b["exec_redispatch"],
            "exec_waves": b["exec_waves"],
            "exec0_restarts": m["exec0"]["sup_restarts"],
            "stale_xid": {f"exec{i}": m[f"exec{i}"]["stale_xid"]
                          for i in range(2)},
            "exec_txns": {f"exec{i}": m[f"exec{i}"]["txns"]
                          for i in range(2)},
            "wave_launches": {f"exec{i}": m[f"exec{i}"]["wave_launches"]
                              for i in range(2)},
            "store_lamports": lamports, "exit_codes": exits}


def run_exec_family(root, card, counts, reset_counts):
    """Phase 20: the exec tile family on the card. 20a runs
    tools/exec_drills.py in process (the fan-out over two shards byte for
    byte with the in-process bank on the CPU, conflict isolation, the
    shard death drill, and the replay's fan-out against InlineFanout on
    the CPU over EXEC_REPLAY_SLOTS slots); 20b bench.py's exec-scale stage
    (tools/exec_scale.py) at EXEC_SCALE_CNTS shards, one boot each; 20c
    the supervised kill. -> (wave-scan launches on the paths, record)."""
    from firedancer_tpu_torch.runtime import Workspace
    from firedancer_tpu_torch.tiles.synth import make_signed_txns
    from firedancer_tpu_torch.tools import exec_drills, exec_scale
    log(f"== 20a. exec tile family in process on the card {card}")
    t0 = time.perf_counter()
    txns = make_signed_txns(EXEC_REPLAY_SLOTS * EXEC_REPLAY_PER_SLOT,
                            seed=47)
    log(f"signed {len(txns)} transfers in {time.perf_counter() - t0:.1f} s")
    rec_a = {}
    w = Workspace(f"/fdtt_smoke20a{os.getpid()}", 1 << 26)
    try:
        reset_counts()
        bi = exec_drills.byte_identity(w, txns[:18], device=DEVICE)
        ci = exec_drills.conflict_isolation(w, device=DEVICE)
        sd = exec_drills.shard_death(w, txns[:12], device=DEVICE)
        launches_a = counts()["wave_scan"]
        rf = exec_drills.replay_fanout(w, txns, EXEC_REPLAY_SLOTS,
                                       device=DEVICE)
        launches_a += rf["launches"]
    finally:
        w.close()
        w.unlink()
    assert rf["launches"] >= EXEC_REPLAY_SLOTS, rf["launches"]
    rec_a = {"byte_identity": {"poh_frames": len(bi["poh"]),
                               "done_frags": len(bi["done"]),
                               "transfers": bi["transfers"],
                               "shard_txns": bi["shard_txns"]},
             "conflict_isolation": {"frames": [len(f) for f in ci["wire"]]},
             "shard_death": {k: sd[k] for k in ("exec_redispatch",
                                                "stale_xid")},
             "replay_fanout": {"slots": EXEC_REPLAY_SLOTS,
                               "wall_s": rf["wall_s"],
                               "exec_waves": rf["exec_waves"],
                               "shard_txns": rf["shard_txns"],
                               "launches": rf["launches"]},
             "wave_launches": launches_a}
    log(f"20a: fan-out over two shards == the in-process bank on the CPU "
        f"({len(bi['poh'])} poh frames, {len(bi['done'])} done frags, "
        f"{bi['transfers']} transfers, shards {bi['shard_txns']}); no "
        f"account in two shards' frames; shard death: redispatch "
        f"{sd['exec_redispatch']}, stale_xid {sd['stale_xid']}, balances "
        f"exactly once; replay fan-out: {EXEC_REPLAY_SLOTS} slots, every "
        f"bank hash == InlineFanout's on the CPU, {rf['exec_waves']} "
        f"waves, shards "
        f"{rf['shard_txns']} txns, {rf['launches']} wave scans, "
        f"{rf['wall_s']:.3f} s; {launches_a} wave-scan launches in 20a "
        f"{card}")
    rec_b = {}
    launches_b = 0
    for n in EXEC_SCALE_CNTS:
        log(f"== 20b. exec-scale stage: bench.py's exec leader loop at "
            f"{n} exec shard(s), {LEADER_FRAMES} frames, unpaced {card}")
        r = exec_scale.run_exec_scale(n, count=LEADER_FRAMES, device=DEVICE)
        launches_b += sum(r["wave_launches"].values())
        rec_b[n] = r
        log(f"20b N={n}: exec_scale_tps {r['exec_scale_tps']:.1f} "
            f"({r['txns']} bank txns in {r['wall_s']:.3f} s from RUN to "
            f"drained; boot {r['boot_s']:.1f} s, halt {r['halt_s']:.1f} s)"
            f", hop: top occupancy {r['top_occupancy_tile']}, first "
            f"backpressured link {r['first_backpressured_link']}; exec "
            f"txns {r['exec_txns']}, wave_launches {r['wave_launches']}; "
            f"bank exec_waves {r['bank_exec_waves']}, exec_redispatch "
            f"{r['bank_exec_redispatch']}; store lamports == genesis - "
            f"{r['fees_burned']} fees, every account == "
            f"execute_block_serial's {card}")
    tps = {n: rec_b[n]["exec_scale_tps"] for n in EXEC_SCALE_CNTS}
    mono = tps[2] >= tps[1] if 1 in tps and 2 in tps else None
    log(f"20b exec_scale_tps {json.dumps(tps)}, exec_scale_monotonic_1_2 "
        f"{mono} (reported, not gated) {card}")
    log(f"== 20c. cfg/exec.toml, two exec shards, exec0 crashes and "
        f"restarts {card}")
    rec_c = run_exec_kill(root, card)
    launches_c = sum(rec_c["wave_launches"].values())
    log(f"20c: exec0 restarted {rec_c['exec0_restarts']} time(s), "
        f"{rec_c['transfers']} transfers exactly once ({rec_c['dropped']} "
        f"frames dropped at named hops), redispatch "
        f"{rec_c['exec_redispatch']}, stale_xid {rec_c['stale_xid']}, "
        f"drained in {rec_c['wall_s']:.3f} s after a {rec_c['boot_s']:.1f} "
        f"s boot, every tile exit 0 {card}")
    for key, r in rec_b.items():
        r.pop("occupancy")
    return launches_a + launches_b + launches_c, {
        "20a": rec_a, "20b": {str(n): r for n, r in rec_b.items()},
        "exec_scale_tps": {str(n): t for n, t in tps.items()},
        "exec_scale_monotonic_1_2": mono, "20c": rec_c,
        "wave_launches": {"20a": launches_a, "20b": launches_b,
                          "20c": launches_c}}


def fold_timing(items, card, tag: str) -> dict:
    """The lthash fold of `items` [(pubkey, Account)] as a restore runs
    it (flamenco/bank_hash.accounts_lthash: LT_CHUNK lanes a launch, the
    partial sums added mod 2^16), with the lanes staged on the card first:
    the launches alone and the fold (launches and on-card sums) timed with
    CUDA events, the plain version's time and sum over the first chunk
    held to the kernel's, its first COLD_SAMPLE lanes lane by lane, and
    the bound of the launches' work (tools/blake3_bench.work)."""
    from firedancer_tpu_torch.flamenco.bank_hash import (
        LT_CHUNK, lane_msgs, serialize_account)
    from firedancer_tpu_torch.ops import blake3 as b3
    from firedancer_tpu_torch.ops import cuda_blake3
    from firedancer_tpu_torch.tools import blake3_bench
    raws = [serialize_account(pk, a) for pk, a in items if a.lamports]
    chunks = []
    for i in range(0, len(raws), LT_CHUNK):
        m, ln = lane_msgs(raws[i:i + LT_CHUNK])
        chunks.append((torch.from_numpy(m).to(DEVICE),
                       torch.from_numpy(ln).to(DEVICE)))

    def fold(kern):
        acc = None
        for m, ln in chunks:
            part = b3.lthash_reduce(kern(m, ln))
            acc = part if acc is None else b3.lthash_add(acc, part)
        return acc

    m0, l0 = chunks[0][0][:COLD_SAMPLE], chunks[0][1][:COLD_SAMPLE]
    lane_err = int((cuda_blake3.lthash(m0, l0)
                    - b3.lthash_plain(m0, l0)).abs().max())
    # the plain version is slow (13 s at 2^20 lanes): its time and its
    # sum are the first chunk's, held to the kernel's first chunk
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = b3.lthash_reduce(b3.lthash_plain(*chunks[0]))
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1)
    fold_err = int((b3.lthash_reduce(cuda_blake3.lthash(*chunks[0]))
                    - plain).abs().max())
    assert lane_err == 0 and fold_err == 0, (tag, lane_err, fold_err)
    ms = cuda_ms(lambda: [cuda_blake3.lthash(m, ln) for m, ln in chunks], 3)
    fold_ms = cuda_ms(lambda: fold(cuda_blake3.lthash), 3)
    lens = np.concatenate([ln.cpu().numpy() for _, ln in chunks])
    w = blake3_bench.work(lens, "lthash")
    rec = {"lanes": len(raws), "launches": len(chunks),
           "width": max(int(m.shape[1]) for m, _ in chunks),
           "ms": ms, "fold_ms": fold_ms, "plain_ms": plain_ms,
           "plain_lanes": int(chunks[0][0].shape[0]),
           "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
           "max_abs_err": max(lane_err, fold_err)}
    log(f"{tag}: lthash fold of {rec['lanes']} lanes (width {rec['width']},"
        f" {rec['launches']} launches of at most {LT_CHUNK}): kernel == "
        f"plain (the first launch's sum, and {COLD_SAMPLE} lanes one by "
        f"one), max_abs_err 0; launches {ms:.4f} ms, fold with the on-card "
        f"sums {fold_ms:.4f} ms (CUDA events), plain {plain_ms:.2f} ms for "
        f"the first {rec['plain_lanes']} lanes, bound "
        f"{w['bound_ms']:.5f} ms ({w['bound_by']}), "
        f"{ms / w['bound_ms']:.1f}x {card}")
    del chunks
    torch.cuda.empty_cache()
    return rec


def run_archive_restore(w, tmp, card, counts, reset_counts) -> dict:
    """22a: the real-format restore at COLD_ARCHIVE_ACCOUNTS, or, where
    the `zstandard` package does not import, the refusal of snapdc and
    snapin format="archive" to boot and the restore's lthash fold alone
    over the same accounts. -> its record ("lthash_launches": the
    manifest's and the restore's)."""
    from firedancer_tpu_torch.tools import catchup
    try:
        import zstandard
    except ImportError:
        log(f"== 22a. the `zstandard` package does not import: snapdc and "
            f"snapin format=\"archive\" must refuse to boot {card}")
        from firedancer_tpu_torch.runtime import Ring
        from firedancer_tpu_torch.tiles.snapshot import (ArchiveInserter,
                                                          SnapDecompress)
        ring = Ring.create(w, depth=8, mtu=4096)
        for make in (lambda: SnapDecompress(ring, ring, []),
                     lambda: ArchiveInserter(ring, device=DEVICE)):
            try:
                make()
            except ModuleNotFoundError as e:
                assert "zstandard" in str(e), e
            else:
                raise AssertionError("booted without zstandard")
        log("22a: snapdc and snapin format=\"archive\" raised "
            "ModuleNotFoundError naming zstandard; the restore's lthash "
            "fold alone, over the archive's accounts")
        accts = catchup.archive_accounts(COLD_ARCHIVE_ACCOUNTS,
                                         seed=COLD_SEED)
        return {"zstandard": None, "lthash_launches": 0,
                "fold": fold_timing(list(accts.items()), card, "22a")}
    log(f"== 22a. the real-format restore: {COLD_ARCHIVE_ACCOUNTS} accounts "
        f"through SnapLoader -> SnapDecompress -> ArchiveInserter, zstandard "
        f"{zstandard.__version__} {card}")
    t0 = time.perf_counter()
    accts = catchup.archive_accounts(COLD_ARCHIVE_ACCOUNTS, seed=COLD_SEED)
    make_s = time.perf_counter() - t0
    path = os.path.join(tmp, "snap.tar.zst")
    reset_counts()
    t0 = time.perf_counter()
    catchup.write_archive(path, 22, accts, device=DEVICE)
    write_s = time.perf_counter() - t0
    write_launches = counts()["lthash"]
    reset_counts()
    r = catchup.archive_restore(w, path, device=DEVICE)
    restore_launches = counts()["lthash"]
    m = r["metrics"]
    assert r["error"] is None and m["lattice_ok"] == 1 \
        and m["restored"] == 1 and m["slot"] == 22, r["error"]
    assert m["accounts"] == COLD_ARCHIVE_ACCOUNTS, m
    assert r["funk"].root_items() == accts, \
        "a restored account != the archive's"
    assert write_launches >= 1 and restore_launches >= 1, \
        (write_launches, restore_launches)
    out = {"zstandard": zstandard.__version__,
           "accounts": COLD_ARCHIVE_ACCOUNTS, "make_s": make_s,
           "write_s": write_s, "restore_s": r["wall_s"],
           "archive_bytes": os.path.getsize(path),
           "raw_bytes": r["raw_bytes"], "frags": r["frags"],
           "lthash_launches": write_launches + restore_launches}
    log(f"22a: {COLD_ARCHIVE_ACCOUNTS} accounts written in {write_s:.2f} s "
        f"({out['archive_bytes']} B of zstd, {r['raw_bytes']} B of tar; the "
        f"manifest's lattice in {write_launches} lthash launches), restored "
        f"in {r['wall_s']:.2f} s ({r['frags']} frags; lattice_ok 1 in "
        f"{restore_launches} launches), every account == the archive's "
        f"{card}")
    del r
    out["fold"] = fold_timing(list(accts.items()), card, "22a")
    small = dict(list(accts.items())[:COLD_TAMPER_ACCOUNTS])
    del accts
    good, bad = os.path.join(tmp, "s.tar.zst"), os.path.join(tmp, "t.tar.zst")
    catchup.write_archive(good, 7, small, device=DEVICE)
    catchup.tamper_archive(good, bad, 7)
    reset_counts()
    t = catchup.archive_restore(w, bad, device=DEVICE)
    out["lthash_launches"] += counts()["lthash"]
    assert t["error"] and "lattice" in t["error"] \
        and not t["funk"].root_items() \
        and t["metrics"]["lattice_ok"] == 0, (t["error"], t["metrics"])
    log(f"22a: an archive of {COLD_TAMPER_ACCOUNTS} accounts with one "
        f"lamport flipped: {t['error']!r}, nothing installed")
    return out


def run_cold_start(root, card, counts, reset_counts):
    """Phase 22: the cold-start follower on the card (tools/catchup.py).
    22c's fixture (its CPU oracle folds COLD_STATE_ACCOUNTS on the
    plain lthash) builds in a worker process while 22a and 22b run.
    -> ({"wave_scan": n, "lthash": n} launches on its paths, record)."""
    import multiprocessing as mp
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from firedancer_tpu_torch.runtime import Workspace
    from firedancer_tpu_torch.svm.accdb import Account
    from firedancer_tpu_torch.tiles.synth import make_signed_txns
    from firedancer_tpu_torch.tools import catchup, exec_drills
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fdtt_smoke22_")
    w = Workspace(f"/fdtt_smoke22{os.getpid()}", 1 << 27)
    pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    try:
        os.makedirs(os.path.join(tmp, "c"))
        fx_c = pool.submit(catchup.catchup_fixture, os.path.join(tmp, "c"),
                           accounts=COLD_STATE_ACCOUNTS, seed=COLD_SEED)
        rec = {"22a": run_archive_restore(w, tmp, card, counts,
                                          reset_counts)}
        launches = {"wave_scan": 0,
                    "lthash": rec["22a"].pop("lthash_launches")}
        fx_b = catchup.catchup_fixture(tmp)
        for tag, accounts in (("22b", 0), ("22c", COLD_STATE_ACCOUNTS)):
            log(f"== {tag}. bench.py's catch-up stage "
                f"({catchup.COUNT} txns, {catchup.UNIQUE} signers, "
                f"{catchup.SLOTS} slots, the snapshot at slot "
                f"{catchup.SNAP_SLOT}, {catchup.EXEC_TILES} exec shards)"
                + (f" with {accounts} funded accounts in the snapshot"
                   if accounts else "") + f" {card}")
            fx = fx_c.result() if accounts else fx_b
            r = catchup.run_catchup(device=DEVICE, accounts=accounts,
                                    fixture=fx)
            launches["wave_scan"] += sum(r["wave_launches"].values())
            launches["lthash"] += r["lthash_launches"]
            rec[tag] = r
            log(f"{tag}: replay_tps {r['replay_tps']:.1f} ({r['txns']} txns "
                f"over {r['catchup_slots']} slots in {r['catchup_s']:.3f} s "
                f"from RUN), catchup_s {r['catchup_s']:.3f}, restore slot "
                f"{r['catchup_restore_slot']}, divergent slot "
                f"{r['catchup_divergent_slot']}, exec waves "
                f"{r['catchup_exec_waves']}; {r['bank_hashes']} bank hashes "
                f"and {r['accounts']} store accounts == the CPU oracle's; "
                f"wave_launches {r['wave_launches']}, lthash_launches "
                f"{r['lthash_launches']}; snapin's restore "
                f"{r['snapin_restore_s']:.3f} s of {r['snapshot_bytes']} B, "
                f"the gate {r['gate_s']:.3f} s (store read "
                f"{r['gate_read_s']:.3f} s, fold {r['gate_fold_s']:.3f} s); "
                f"the CPU oracle's fixture {r['fixture_s']:.1f} s, boot "
                f"{r['boot_s']:.1f} s {card}")
        gen = catchup.funded_accounts(COLD_STATE_ACCOUNTS, seed=COLD_SEED)
        rec["22c"]["fold"] = fold_timing(
            [(k, Account(lamports=v)) for k, v in gen.items()], card, "22c")
        del gen, fx

        log(f"== 22d. the cold-start drills {card}")
        stale = catchup.stale_snapshot(fx_b, os.path.join(tmp, "stale.ckpt"),
                                       catchup.SNAP_SLOT - 2)
        d = {"snapshot": catchup.snapshot_drills(w, fx_b["snap"], stale,
                                                 catchup.SNAP_SLOT)}
        for action in ("corrupt_checkpt_frame", "stale_snapshot_offer"):
            log(f"22d {action}: snapin refused "
                f"({d['snapshot'][action]['error']!r}), no record and no "
                f"restore marker in the store")
        d["snapld_crash"] = catchup.snapld_crash_drill(fx_b["snap"],
                                                       catchup.SNAP_SLOT)
        log(f"22d crash_mid_snapshot on snapld: restarted "
            f"{d['snapld_crash']['restarts']} time, the stream from byte 0 "
            f"({d['snapld_crash']['loader_frags']} frags after the restart, "
            f"{d['snapld_crash']['snapin_frags']} at snapin), "
            f"{d['snapld_crash']['accounts']} accounts restored in "
            f"{d['snapld_crash']['wall_s']:.2f} s")
        d["writer_crash"] = catchup.writer_crash_drill(
            fx_b["snap"], fx_b["tail"], fx_b["expected"], catchup.SNAP_SLOT,
            tmp, device=DEVICE)
        log(f"22d crash_mid_snapshot on the replay's writer: exit "
            f"{d['writer_crash']['exitcode']}, the slot-"
            f"{d['writer_crash']['intact_slot']} snapshot intact and "
            f"restored with the oracle's bank hash, the "
            f"{d['writer_crash']['tmp_bytes']}-byte .tmp refused "
            f"({d['writer_crash']['tmp_refused']!r})")
        reset_counts()
        d["genesis_ckpt"] = exec_drills.genesis_ckpt_boot(
            w, make_signed_txns(18, seed=47), os.path.join(tmp, "g.ckpt"),
            device=DEVICE)
        gk = counts()["wave_scan"]
        assert gk >= 2 and all(n >= 1 for n in
                               d["genesis_ckpt"]["wave_launches"]), \
            (gk, d["genesis_ckpt"])
        launches["wave_scan"] += gk
        log(f"22d genesis_ckpt: the bank booted from the checkpoint == "
            f"booted from its dict ({d['genesis_ckpt']['transfers']} "
            f"transfers, {d['genesis_ckpt']['poh_frames']} poh frames, "
            f"{d['genesis_ckpt']['accounts']} accounts), wave scans "
            f"{d['genesis_ckpt']['wave_launches']} {card}")
        rec["22d"] = d
    finally:
        pool.shutdown(cancel_futures=True)
        w.close()
        w.unlink()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"22: {rec['wall_s']:.1f} s; launches on its paths {launches} {card}")
    return launches, rec


def run_general_exec(root, card, counts, reset_counts):
    """Phase 23: general execution. 23a: firedancer_tpu_torch/cfg/
    general.toml booted on the card (sock -> verify x2 -> dedup -> pack
    -> bank0 exec="general" -> poh -> shred <-> sign -> shredsink) over
    tools/general_exec.py's genesis (512 validators with vote and stake
    accounts, 16 lookup tables, 256 users, the sBPF family's programs),
    its 4,942 signed txns (4,104 votes, transfers, stake, ALUT and
    precompile txns, the sBPF family's 11 loader txns and 384
    invocations, the 22 designed failures) sent to the sock door by a
    WindowSender in the groups the deploy sequence's slots cut; the
    checks of general_exec.run_general (door rx = sent, every txn
    executed, failed or a counted drop, exec_fail = the oracle's = the
    designed, rewards paid, bank0's store == PlainBank's over the
    microblocks it took, the sBPF family's arithmetic on bank0's store
    and on PlainBank's results, no verify fallback, every tile exits 0).
    23b: ReplayCore on the card over the same genesis replays the whole
    workload, v0 included, as slices with a real PoH chain across an
    epoch boundary, each poh_verify and lthash launch recorded; the same
    on the CPU: every slot's bank hash and every account equal, the sBPF
    arithmetic on both stores, both kernels launched. 23c: every
    recorded launch held to its plain version, and lthash at the largest
    slot delta's shape (a vote-heavy slot) timed by a CUDA graph of
    ITERS launches beside its bound and its plain version; the host's us
    a txn by program family, and a txn and a CU by sBPF program, from
    23a's oracle. -> ({kernel: launches on the in-process path},
    record)."""
    from firedancer_tpu_torch.app.config import load_config
    from firedancer_tpu_torch.ops import blake3 as b3, cuda_blake3, \
        cuda_sha256
    from firedancer_tpu_torch.tools import blake3_bench, wave_bench
    from firedancer_tpu_torch.tools import general_exec as gx
    cfg_path = os.path.join(root, "firedancer_tpu_torch", "cfg",
                            "general.toml")
    build_dir = os.path.join(root, "firedancer_tpu_torch", "build",
                             "general")
    t0 = time.perf_counter()
    wl = gx.build()
    genesis = gx.write_genesis(wl, os.path.join(build_dir, "genesis.ckpt"))
    build_s = time.perf_counter() - t0
    log(f"== 23a. cfg/general.toml on the card: {len(wl.traffic)} txns "
        f"{wl.counts} from {gx.VALIDATORS} validators to the sock door, "
        f"bank0 exec=\"general\" over {len(wl.genesis)} genesis accounts "
        f"(signed in {build_s:.1f} s) {card}")
    t0 = time.perf_counter()
    rec_a = gx.run_general(cfg_path, wl, genesis, DEVICE,
                           f"smoke23{os.getpid()}",
                           os.path.join(build_dir, "final.ckpt"))
    a_s = time.perf_counter() - t0
    log(f"23a: {json.dumps(rec_a)} in {a_s:.1f} s {card}")

    # cfg/general.toml's epoch and PoH settings, as 23a ran them; the
    # slots start two before the first epoch boundary, so the replay
    # crosses it
    spe, hpt = gx.chain_settings(load_config(cfg_path))
    slices = gx.workload_slices(wl, spe - 2, hpt)
    log(f"== 23b. ReplayCore on the card and on the CPU: {len(slices)} "
        f"slots ({len(wl.traffic)} txns and {len(wl.v0)} v0 transfers "
        f"through the tables), slots_per_epoch {spe} {card}")
    launches = {"poh_verify": [], "lthash": []}
    k_poh, k_lt = cuda_sha256.poh_verify, cuda_blake3.lthash

    def rec_poh(*a):
        out = k_poh(*a)
        launches["poh_verify"].append((a, out))
        return out

    def rec_lt(*a):
        out = k_lt(*a)
        launches["lthash"].append((a, out))
        return out
    cuda_sha256.poh_verify, cuda_blake3.lthash = rec_poh, rec_lt
    try:
        reset_counts()
        on_card = gx.replay_workload(slices, genesis, DEVICE, hpt, spe)
        torch.cuda.synchronize()
        path = counts()
    finally:
        cuda_sha256.poh_verify, cuda_blake3.lthash = k_poh, k_lt
    on_cpu = gx.replay_workload(slices, genesis, "cpu", hpt, spe)
    assert on_card["bank_hashes"] == on_cpu["bank_hashes"], \
        "23b: bank hashes on the card != on the CPU"
    assert on_card["state"] == on_cpu["state"], \
        "23b: accounts on the card != on the CPU"
    cm = on_card["metrics"]
    assert cm == on_cpu["metrics"], (cm, on_cpu["metrics"])
    assert cm["poh_fail"] == 0 and cm["exec_fail"] == wl.designed_fail \
        and cm["txns"] == len(wl.traffic) + len(wl.v0), cm
    sbpf_b = wl.sbpf.check(on_card["state"])
    assert path["poh_verify"] == len(launches["poh_verify"]) > 0 and \
        path["lthash"] == len(launches["lthash"]) > 0, path
    log(f"23b: {len(slices)} slots, every bank hash and all "
        f"{len(on_card['state'])} accounts equal, the sBPF arithmetic "
        f"holds ({sbpf_b['lamports_checked']} balances, hash2 deployed at "
        f"slot {sbpf_b['hash2_slot']}); card {on_card['seconds']:.2f}"
        f" s, CPU {on_cpu['seconds']:.2f} s; launches poh_verify "
        f"{path['poh_verify']}, lthash {path['lthash']}; {cm} {card}")

    log(f"== 23c. the replay's launches held to their plain versions; "
        f"lthash at the vote-heavy slot delta's shape, CUDA graph of "
        f"{ITERS} {card}")
    errs, _ = follower_kernel_times(launches, hpt, blake3_bench.work)
    assert errs == {"poh_verify": 0, "lthash": 0}, errs
    # launch 0 folds the genesis store (the boot's lthash_of_root); the
    # largest after it is a slot delta's side
    a, _ = max(launches["lthash"][1:], key=lambda x: x[0][0].shape[0])
    w = blake3_bench.work(a[1].cpu().numpy(), "lthash")
    delta = stats_of(
        wave_bench.graph_ms(lambda: cuda_blake3.lthash(*a), ITERS),
        cuda_ms(lambda: b3.lthash_plain(*a), 1), w["ops"], w["bytes"])
    delta["max_abs_err"] = int((k_lt(*a) - b3.lthash_plain(*a))
                               .abs().max())
    assert delta["max_abs_err"] == 0
    lens = a[1].cpu().numpy()
    delta["shape"] = (f"{a[0].shape[0]} lanes x {a[0].shape[1]} B "
                      f"(mean {float(lens.mean()):.1f} B)")
    log(f"23c: lthash at {delta['shape']}: kernel {delta['ms']:.4f} ms, "
        f"plain {delta['plain_ms']:.2f} ms, bound {delta['bound_ms']:.6f} "
        f"ms by {delta['bound_by']}, {delta['ms'] / delta['bound_ms']:.1f}x "
        f"the bound, max_abs_err 0 {card}")
    log(f"23c: host us a txn by program family (23a's plain general "
        f"path): {json.dumps(rec_a['host_us_per_txn'])} {card}")
    log(f"23c: sBPF host cost by program (23a's oracle: txns, CU, us a "
        f"txn, us a CU; a coverage mix, no rate): "
        f"{json.dumps(rec_a['sbpf_host'])} {card}")
    rec = {"23a": rec_a, "23a_s": a_s, "workload_s": build_s,
           "23b": {"slots": len(slices), "accounts": len(on_card["state"]),
                   "card_s": on_card["seconds"],
                   "cpu_s": on_cpu["seconds"], "launches": path,
                   "metrics": cm},
           "23c": {"lthash_vote_delta": {k: delta[k] for k in (
               "shape", "ms", "plain_ms", "bound_ms", "bound_by",
               "max_abs_err")}, "host_us_per_txn": rec_a["host_us_per_txn"],
               "sbpf_host": rec_a["sbpf_host"]}}
    return {"poh_verify": path["poh_verify"], "lthash": path["lthash"]}, rec


def run_nonleader(root, card) -> dict:
    """Phase 24: the two-node cluster (tools/cluster.py). The leader,
    firedancer_tpu_torch/cfg/leader.toml + cfg/cluster.toml at full width
    (LEADER_FRAMES over 768 transfers, 64 hashes a tick, 8 ticks a slot)
    with verify x2 and bank0 on the card, its turbine over UDP to the
    non-leader and every fourth slot dropped; the non-leader,
    cfg/nonleader.toml (sock -> repair -> shred recover -> replay on the
    card -> tower -> send -> sign), its votes sent to a socket of this
    process. Waits on metrics only: the leader drops a slot, the
    non-leader requests repair, the leader's serve-only repair tile
    serves, responses come in; the leader's loop drains and closes the
    slot of its last microblock; the non-leader replays every slot up to
    it and votes; both halt with every tile's exit code 0. Then: the
    non-leader replayed every executed txn with
    no PoH failure, no divergence and both kernels launched in its
    replay tile; every block frame's bank hash equals a CPU replay of the
    leader's complete slices (its shred mirror, tapped, recovered on the
    host as 17a does), every dropped slot below the drain's among
    them; every vote datagram is a TowerSync signed by the non-leader
    (the strict verify on the card and utils/ed25519_ref) for a replayed
    slot's bank hash, its lockout slots ascending and replayed.
    -> record, with the leader's verify batches and wave scans and the
    replay tile's launches, work per poll and `tpu` spans."""
    from firedancer_tpu_torch.disco.metrics import quantile_ns, read_hists
    from firedancer_tpu_torch.disco.tiles import _synth_genesis
    from firedancer_tpu_torch.ops import cuda_ed
    from firedancer_tpu_torch.tiles.tower import parse_block
    from firedancer_tpu_torch.tools import cluster as tcluster
    log(f"== 24. the voting non-leader: cfg/leader.toml + cfg/cluster.toml "
        f"({LEADER_FRAMES} frames, every {tcluster.DROP_SLOT_EVERY}th slot "
        f"dropped from turbine) and cfg/nonleader.toml; verify x2, bank0 "
        f"and the non-leader's replay on the card {card}")
    t_phase = time.perf_counter()
    c = tcluster.Cluster("smoke24", DEVICE)
    waits = {}
    try:
        c.start(boot_timeout_s=300)
        boot_s = time.perf_counter() - t_phase
        a, b = c.a, c.b
        for what, cond in (
                ("dropped", lambda: a.metrics("shred")["dropped"] > 0),
                ("reqs_sent", lambda: b.metrics("repair")["reqs_sent"] >= 1),
                ("reqs_served",
                 lambda: a.metrics("arepair")["reqs_served"] >= 1),
                ("resps_in", lambda: b.metrics("repair")["resps_in"] >= 1)):
            t0 = time.perf_counter()
            c.wait(cond, 300, what)
            waits[what] = time.perf_counter() - t0
        d = c.drain(LEADER_FRAMES, 600)
        slots = d["slots"]
        t0 = time.perf_counter()
        c.wait(lambda: b.metrics("tower")["votes_out"] >= 1
               and len(c.votes()) >= 1, 300, "a vote datagram")
        waits["vote"] = time.perf_counter() - t0
        # every tile of both nodes exits 0 (Cluster.stop asserts it)
        got = c.stop()
        rh = read_hists(c.b.wksp, c.b.plan, "replay")
    finally:
        c.close()
    run_s = time.perf_counter() - t_phase
    la, nb = got["metrics"]["leader"], got["metrics"]["nonleader"]
    bk, r, rp, sh = la["bank0"], nb["replay"], nb["repair"], la["shred"]
    tw, sd, ar = nb["tower"], nb["send"], la["arepair"]
    for key, v, want in (
            ("bank0.txns + drops", bk["txns"] + d["dropped"], LEADER_FRAMES),
            ("bank0.exec_fail", bk["exec_fail"], 0),
            ("replay.poh_fail", r["poh_fail"], 0),
            ("replay.divergent_slot", r["divergent_slot"], 0),
            ("replay.parse_fail", r["parse_fail"], 0),
            ("replay.txns", r["txns"], bk["txns"]),
            ("replay.exec_ok", r["exec_ok"], bk["transfers"]),
            ("repair.sign_fail", rp["sign_fail"], 0),
            ("send.sign_fail", sd["sign_fail"], 0),
            ("sign.refused", nb["sign"]["refused"], 0)):
        assert v == want, f"24: {key} = {v}, expected {want}"
    assert r["slots_replayed"] >= slots and sh["dropped"] > 0, (r, sh)
    assert rp["reqs_sent"] >= 1 and ar["reqs_served"] >= 1 \
        and rp["resps_in"] >= 1, (rp, ar)
    assert r["poh_launches"] > 0 and r["lthash_launches"] > 0, r
    assert bk["wave_launches"] > 0, bk
    assert 1 <= sd["sent"] <= tw["votes_out"], (sd, tw)
    shards = [tn for tn in la if tn.startswith("verify")]
    for tn in shards:
        assert la[tn]["batches"] > 0 and la[tn]["verify_fail"] == 0, la[tn]
        no_fallback(f"24 {tn}", la[tn])
    # the leader's complete slices, recovered and replayed on the CPU
    t0 = time.perf_counter()
    rcfg = next(t for t in c.b_cfg["tile"] if t["name"] == "replay")
    slices, _ = recover_slices(c.leader_identity(), got["shreds_mirror"])
    # bank hashes only: the replay tile's own PoH check is asserted above
    cpu, _ = replay_slices(slices, _synth_genesis(rcfg["genesis_synth"]),
                           rcfg["hashes_per_tick"], "cpu", False,
                           verify_poh=False)
    cpu_check_s = time.perf_counter() - t0
    blocks = [parse_block(f) for f in got["replay_tower"]]
    replayed = {slot for slot, *_ in blocks}
    assert set(range(1, slots)) <= replayed, "24: a slot was not replayed"
    dropped_slots = tcluster.dropped_slots(slots)
    for slot, parent, bid, pid in blocks:
        assert cpu.bank_hash_of[slot] == bid, f"24: slot {slot} bank hash"
        assert cpu.bank_hash_of[parent if slot else -1] == pid, \
            f"24: slot {slot} parent"
    # every vote: the non-leader's signature, held by the strict verify on
    # the card too, over a TowerSync for a replayed slot's bank hash
    votes = c.vote_log
    checked = tcluster.check_votes(votes, c.nonleader_identity(),
                                   {s: cpu.bank_hash_of[s] for s in replayed})
    parsed = [tcluster.parse_vote(v) for v in votes]
    width = max(len(m) for _, _, m, _ in parsed)
    vsig = np.stack([np.frombuffer(sg, np.uint8) for _, sg, _, _ in parsed])
    vpub = np.stack([np.frombuffer(k, np.uint8) for k, _, _, _ in parsed])
    vmsg = np.zeros((len(parsed), width), np.uint8)
    for i, (_, _, m, _) in enumerate(parsed):
        vmsg[i, :len(m)] = np.frombuffer(m, np.uint8)
    vlen = np.array([len(m) for _, _, m, _ in parsed], np.int32)
    on_card = cuda_ed.verify_batch(vsig, vpub, vmsg, vlen, device=DEVICE)
    assert bool(on_card.all()), "24: a vote fails the strict verify"
    # Cluster.stop read the socket after the halt: every vote sent
    assert len(votes) == sd["sent"], (len(votes), sd)
    rec = {"slots": slots, "slots_replayed": r["slots_replayed"],
           "txns": bk["txns"], "replay_txns": r["txns"],
           "dropped_shreds": sh["dropped"],
           "dropped_slots_below_drain": len(dropped_slots),
           "turbine_sent": sh["sent"], "sock_rx": nb["sock"]["rx"],
           "repair": {"reqs_sent": rp["reqs_sent"],
                      "resps_in": rp["resps_in"],
                      "reqs_served": ar["reqs_served"],
                      "reqs_refused": ar["reqs_refused"],
                      "incomplete": rp["incomplete"]},
           "tower": {k: tw[k] for k in ("blocks", "votes_out", "roots",
                                        "root_slot", "threshold_skips",
                                        "lockout_skips", "switch_skips",
                                        "bad_frames")},
           "send": dict(sd), "votes_received": len(votes),
           "last_vote": checked[-1][0], "vote_lockouts_max": max(
               len(lo) for _, lo, _ in checked),
           "poh_launches": r["poh_launches"],
           "lthash_launches": r["lthash_launches"],
           "replay_work_p50_ms": quantile_ns(rh["work"], 0.50) / 1e6,
           "replay_work_p99_ms": quantile_ns(rh["work"], 0.99) / 1e6,
           "replay_work_polls": rh["work"]["count"],
           "replay_spans": rh["tpu"]["count"],
           "replay_span_p50_ms": quantile_ns(rh["tpu"], 0.50) / 1e6,
           "replay_span_p99_ms": quantile_ns(rh["tpu"], 0.99) / 1e6,
           "bank_wave_launches": bk["wave_launches"],
           "verify_batches": {tn: la[tn]["batches"] for tn in shards},
           "boot_s": boot_s, "waits_s": waits, "drain_s": d["wall_s"],
           "drain_steps_s": d["steps_s"],
           "cpu_check_s": cpu_check_s, "mirror_wires":
           len(got["shreds_mirror"]), "blocks_checked": len(blocks),
           "run_s": run_s, "phase_s": time.perf_counter() - t_phase,
           "card": nvidia_smi()}
    log(f"24: leader {bk['txns']} txns, {sh['dropped']} shreds of "
        f"{len(dropped_slots)} slots below slot {slots} dropped from "
        f"turbine; repair: {rp['reqs_sent']} requests, {ar['reqs_served']} "
        f"served ({ar['reqs_refused']} refused), {rp['resps_in']} responses; "
        f"the non-leader replayed {r['slots_replayed']} slots and "
        f"{r['txns']} txns on the card (poh_verify {r['poh_launches']}, "
        f"lthash {r['lthash_launches']} launches), poh_fail 0, divergent 0; "
        f"{len(blocks)} block frames == a CPU replay of the leader's "
        f"{len(got['shreds_mirror'])} mirrored wires ({cpu_check_s:.1f} s); "
        f"tower votes_out {tw['votes_out']}, roots {tw['roots']}; "
        f"{len(votes)} vote datagrams, each a TowerSync signed by the "
        f"non-leader (strict verify on the card and ed25519_ref) for its "
        f"last lockout slot's bank hash, the last for slot {checked[-1][0]}; "
        f"replay work p50/p99 {rec['replay_work_p50_ms']:.3f}/"
        f"{rec['replay_work_p99_ms']:.3f} ms over {rh['work']['count']} "
        f"polls, tpu spans p50/p99 {rec['replay_span_p50_ms']:.3f}/"
        f"{rec['replay_span_p99_ms']:.3f} ms over {rh['tpu']['count']}; "
        f"every tile of both nodes exited 0; "
        f"boot {boot_s:.1f} s, drain {d['wall_s']:.1f} s, phase "
        f"{rec['phase_s']:.1f} s {card}")
    return rec


def run_follower_demo(root, card, counts, reset_counts) -> dict:
    """Phase 25: a cluster from nothing (tools/cluster.py with a genesis).
    The port's `app.genesis` CLI writes the demo's genesis (`--validators
    1 --user-accounts 16`: a vote, a stake and an identity account, and
    the 16 synth payers); cfg/follower.toml boots on it (snapld -> snapin
    restore the checkpoint into the shm store as slot 0; sock -> shred
    recover -> replay behind its restore gate on the card, over two exec
    shards on the card; tower -> send -> sign), then app.dev's leader
    (cfg/leader.toml with the genesis in bank0) + cfg/cluster.toml at full
    width (LEADER_FRAMES over 768 transfers), no slot dropped, its turbine
    to the follower, whose votes go to a socket of this process. Waits on
    metrics only, then halts both with every tile's exit code 0. Then:
    snapin restored slot 0 and the replay's gate folded it on the card
    (lthash launched; the genesis's lanes on the card == the plain
    version's, max_abs_err 0); every txn the leader executed after slot 0
    replayed ok (the replay never runs its restore slot, as the
    reference's), no PoH failure, no divergence; both exec shards carried
    txns and launched the wave scan; every block frame's bank hash == the
    port's CPU replay of the leader's mirrored slices (recovered on the
    host, as 17a) from the same checkpoint; every vote a TowerSync signed
    by the follower (the strict verify on the card and ed25519_ref) for a
    replayed slot's bank hash; the snapshot the replay wrote restores
    into a fresh store at a slot that is a multiple of 64, equal to the
    CPU replay's store at that slot under that slot's block frame's bank
    hash; no verify fallback. -> record, with each kernel's launches on
    both nodes (counts reset before the phase; in process only the
    checks' launches)."""
    import io
    import shutil
    import tempfile
    from firedancer_tpu_torch.app.genesis import main as genesis_main
    from firedancer_tpu_torch.flamenco.bank_hash import (lane_msgs,
                                                         serialize_account)
    from firedancer_tpu_torch.funk.funk import Funk
    from firedancer_tpu_torch.ops import cuda_ed
    from firedancer_tpu_torch.ops.blake3 import lthash_batch
    from firedancer_tpu_torch.svm.accdb import Account
    from firedancer_tpu_torch.tiles.shred import (parse_entry_batch,
                                                  parse_slice)
    from firedancer_tpu_torch.tiles.tower import parse_block
    from firedancer_tpu_torch.tools import cluster as tcluster
    from firedancer_tpu_torch.utils.checkpt import snapshot_restore_into
    log(f"== 25. a cluster from nothing: app.genesis, cfg/follower.toml "
        f"restoring it, and app.dev's leader + cfg/cluster.toml "
        f"({LEADER_FRAMES} frames, no slot dropped); verify x2 and bank0 "
        f"on the card, the follower's replay and exec x2 on the card "
        f"{card}")
    t_phase = time.perf_counter()
    reset_counts()
    tmp = tempfile.mkdtemp(prefix="fdtt_smoke25_")
    try:
        ckpt = os.path.join(tmp, "genesis.ckpt")
        t0 = time.perf_counter()
        assert genesis_main([ckpt, "--validators", "1",
                             "--user-accounts", "16"]) == 0
        genesis_s = time.perf_counter() - t0
        c = tcluster.Cluster("smoke25", DEVICE, genesis_ckpt=ckpt)
        try:
            c.start(boot_timeout_s=300)
            boot_s = time.perf_counter() - t_phase - genesis_s
            a, b = c.a, c.b
            # poh runs on to the follower's first snapshot slot at least
            d = c.drain(LEADER_FRAMES, 600)
            slots = d["slots"]
            t0 = time.perf_counter()
            c.wait(lambda: b.metrics("tower")["votes_out"] >= 1
                   and len(c.votes()) >= 1, 300, "a vote datagram")
            c.wait(lambda: b.metrics("replay")["snapshots"] >= 1, 60,
                   f"a snapshot of the replay (slots {slots})")
            vote_wait_s = time.perf_counter() - t0
            # every tile of both nodes exits 0 (Cluster.stop asserts it)
            got = c.stop()
            with open(c.snapshot_path, "rb") as f:
                snap = f.read()
        finally:
            c.close()
        run_s = time.perf_counter() - t_phase
        path_launches = counts()     # in process: none on the path
        la, fo = got["metrics"]["leader"], got["metrics"]["follower"]
        bk, r, sn, sh = la["bank0"], fo["replay"], fo["snapin"], la["shred"]
        tw, sd = fo["tower"], fo["send"]
        execs = sorted(tn for tn in fo if tn.startswith("exec"))
        assert len(execs) == 2, sorted(fo)
        # the leader's complete slices, recovered and replayed on the CPU
        # from the same checkpoint, as the follower restored it
        t0 = time.perf_counter()
        slices, _ = recover_slices(c.leader_identity(), got["shreds_mirror"])
        snap_store = Funk()
        snap_slot, snap_hash, snap_cnt = snapshot_restore_into(
            snap_store, io.BytesIO(snap))
        rt = next(t for t in c.b_cfg["tile"] if t["name"] == "replay")
        hpt = rt.get("hashes_per_tick", c.b_cfg["replay"]["hashes_per_tick"])
        cpu, cpu_store = tcluster.follower_oracle(
            slices, ckpt, hpt, store_slot=snap_slot)
        cpu_check_s = time.perf_counter() - t0
        acc, slot0_txns = {}, 0
        for f in slices:
            s, _, fin, payload = parse_slice(f)
            acc[s] = acc.get(s, b"") + payload
            if fin and s == 0:
                slot0_txns = sum(len(ts) for _, _, ts in
                                 parse_entry_batch(acc.pop(s)))
        for key, v, want in (
                ("bank0.txns + drops", bk["txns"] + d["dropped"],
                 LEADER_FRAMES),
                ("bank0.exec_fail", bk["exec_fail"], 0),
                ("shred.dropped", sh["dropped"], 0),
                ("snapin.restored", sn["restored"], 1),
                ("snapin.slot", sn["slot"], 0),
                ("snapin.stream_err", sn["stream_err"], 0),
                ("snapin.accounts", sn["accounts"], 19),
                ("replay.restore_slot", r["restore_slot"], 0),
                ("replay.poh_fail", r["poh_fail"], 0),
                ("replay.divergent_slot", r["divergent_slot"], 0),
                ("replay.parse_fail", r["parse_fail"], 0),
                ("replay.exec_fail", r["exec_fail"], 0),
                ("replay.txns", r["txns"], bk["txns"] - slot0_txns),
                ("replay.exec_ok", r["exec_ok"], bk["txns"] - slot0_txns),
                ("exec shards' txns", sum(fo[e]["txns"] for e in execs),
                 r["txns"]),
                ("the CPU replay's txns", cpu.metrics["txns"], r["txns"]),
                ("send.sign_fail", sd["sign_fail"], 0),
                ("sign.refused", fo["sign"]["refused"], 0)):
            assert v == want, f"25: {key} = {v}, expected {want}"
        assert r["slots_replayed"] >= d["replayed"], (r, d)
        assert r["poh_launches"] > 0 and r["lthash_launches"] > 0 \
            and r["restore_fold_us"] > 0, r
        for e in execs:
            assert fo[e]["txns"] > 0 and fo[e]["wave_launches"] > 0, \
                (e, fo[e])
        assert bk["wave_launches"] > 0, bk
        assert 1 <= sd["sent"] <= tw["votes_out"], (sd, tw)
        shards = [tn for tn in la if tn.startswith("verify")]
        for tn in shards:
            assert la[tn]["batches"] > 0 and la[tn]["verify_fail"] == 0, \
                la[tn]
            no_fallback(f"25 {tn}", la[tn])
        blocks = [parse_block(f) for f in got["replay_tower"]]
        replayed = [s for s, *_ in blocks]
        assert replayed == list(range(1, len(blocks) + 1)), \
            f"25: block frames of slots {replayed[:8]}..."
        assert len(blocks) >= d["replayed"], (len(blocks), d)
        bank_hash_of = {}
        for slot, parent, bid, pid in blocks:
            assert cpu.bank_hash_of[slot] == bid, f"25: slot {slot} bank hash"
            assert cpu.bank_hash_of[parent] == pid, f"25: slot {slot} parent"
            bank_hash_of[slot] = bid
        assert cpu.bank_hash_of[0] == bytes(32)
        # the snapshot the replay wrote: a multiple of 64, the CPU
        # replay's store at that slot, that slot's block frame's hash
        assert snap_slot > 0 and snap_slot % 64 == 0, snap_slot
        assert snap_hash == bank_hash_of[snap_slot], snap_slot
        restored = snap_store.root_items()
        assert restored == cpu_store and snap_cnt == len(cpu_store), \
            f"25: the snapshot at slot {snap_slot} != the CPU replay's store"
        # the restore gate's fold: the genesis's lanes on the card == the
        # plain version's
        reset_counts()
        gen = Funk()
        with open(ckpt, "rb") as f:
            snapshot_restore_into(gen, f)
        raws = [serialize_account(k, v) for k, v in gen.root_items().items()
                if isinstance(v, Account) and v.lamports]
        lanes = lane_msgs(raws)
        fold_k = lthash_batch(*lanes, device=DEVICE)
        fold_p = lthash_batch(*lanes, device="cpu")
        fold_err = int((fold_k.cpu().long() - fold_p.long()).abs().max())
        assert fold_err == 0, f"25: the restore fold's lthash err {fold_err}"
        # every vote: the follower's signature, held by the strict verify
        # on the card too, over a TowerSync for a replayed slot's hash
        votes = c.vote_log
        checked = tcluster.check_votes(votes, c.follower_identity(),
                                       bank_hash_of)
        parsed = [tcluster.parse_vote(v) for v in votes]
        width = max(len(m) for _, _, m, _ in parsed)
        vsig = np.stack([np.frombuffer(sg, np.uint8) for _, sg, _, _ in parsed])
        vpub = np.stack([np.frombuffer(k, np.uint8) for k, _, _, _ in parsed])
        vmsg = np.zeros((len(parsed), width), np.uint8)
        for i, (_, _, m, _) in enumerate(parsed):
            vmsg[i, :len(m)] = np.frombuffer(m, np.uint8)
        vlen = np.array([len(m) for _, _, m, _ in parsed], np.int32)
        on_card = cuda_ed.verify_batch(vsig, vpub, vmsg, vlen, device=DEVICE)
        assert bool(on_card.all()), "25: a vote fails the strict verify"
        # Cluster.stop read the socket after the halt: every vote sent
        assert len(votes) == sd["sent"], (len(votes), sd)
        check_launches = counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    strict = sum(la[tn]["batches"] for tn in shards)
    exec_waves = sum(fo[e]["wave_launches"] for e in execs)
    launches = {
        "leader": {"sha512_ram": strict, "ed25519_verify": strict,
                   "wave_scan": bk["wave_launches"]},
        "follower": {"poh_verify": r["poh_launches"],
                     "lthash": r["lthash_launches"],
                     "wave_scan": exec_waves},
        "in_process_path": {k: v for k, v in path_launches.items() if v},
        "in_process_checks": {k: v for k, v in check_launches.items()
                              if v}}
    rec = {"slots": slots, "slots_replayed": r["slots_replayed"],
           "leader_txns": bk["txns"], "slot0_txns": slot0_txns,
           "replay_txns": r["txns"],
           "exec_txns": {e: fo[e]["txns"] for e in execs},
           "exec_waves": r["exec_waves"],
           "exec_redispatch": r["exec_redispatch"],
           "restore": {"accounts": sn["accounts"],
                       "snapin_restore_s": sn["restore_us"] / 1e6,
                       "read_s": r["restore_read_us"] / 1e6,
                       "fold_s": r["restore_fold_us"] / 1e6,
                       "gate_s": r["restore_gate_us"] / 1e6,
                       "fold_lanes": len(raws), "fold_max_abs_err":
                       fold_err},
           "snapshots": r["snapshots"], "snapshot_slot": snap_slot,
           "snapshot_accounts": snap_cnt,
           "turbine_sent": sh["sent"], "sock": {
               k: fo["sock"][k] for k in ("rx", "oversz", "backpressure",
                                           "shed")},
           "tower": {k: tw[k] for k in ("blocks", "votes_out", "roots",
                                        "root_slot", "threshold_skips",
                                        "lockout_skips", "switch_skips",
                                        "bad_frames")},
           "send": dict(sd), "votes_received": len(votes),
           "last_vote": checked[-1][0], "vote_lockouts_max": max(
               len(lo) for _, lo, _ in checked),
           "launches": launches,
           "verify_batches": {tn: la[tn]["batches"] for tn in shards},
           "genesis_s": genesis_s, "boot_s": boot_s,
           "drain_s": d["wall_s"], "drain_steps_s": d["steps_s"],
           "vote_wait_s": vote_wait_s,
           "cpu_check_s": cpu_check_s, "run_s": run_s,
           "mirror_wires": len(got["shreds_mirror"]),
           "blocks_checked": len(blocks),
           "phase_s": time.perf_counter() - t_phase, "card": nvidia_smi()}
    log(f"25: genesis {rec['restore']['accounts']} accounts; snapin restored "
        f"slot 0, the gate's fold {rec['restore']['fold_s']:.4f} s on the "
        f"card (read {rec['restore']['read_s']:.4f} s; the genesis's "
        f"{len(raws)} lanes == plain); leader {bk['txns']} txns "
        f"({slot0_txns} in slot 0, which the follower restores, not "
        f"replays), {slots} slots, none dropped; turbine {sh['sent']} "
        f"shreds, the follower's sock read {fo['sock']['rx']}; the follower "
        f"replayed {r['slots_replayed']} slots and {r['txns']} txns "
        f"(exec shards {rec['exec_txns']}, wave scans {exec_waves}; "
        f"poh_verify {r['poh_launches']}, lthash {r['lthash_launches']} "
        f"launches), poh_fail 0, divergent 0; {len(blocks)} block frames == "
        f"the CPU replay from the genesis ({cpu_check_s:.1f} s); snapshot "
        f"at slot {snap_slot} ({r['snapshots']} written) == the CPU "
        f"replay's store of {snap_cnt} accounts; tower votes_out "
        f"{tw['votes_out']}, threshold_skips {tw['threshold_skips']}, roots "
        f"{tw['roots']}; {len(votes)} vote datagrams, each a TowerSync "
        f"signed by the follower (strict verify on the card and "
        f"ed25519_ref), the last for slot {checked[-1][0]}; every tile of "
        f"both nodes exited 0; boot {boot_s:.1f} s, drain "
        f"{d['wall_s']:.1f} s, phase {rec['phase_s']:.1f} s {card}")
    return rec


def load_vectors(root):
    """Every Wycheproof EdDSA vector and both malleability corpora
    (96-byte (sig, pub) records over "Zcash")."""
    vec = os.path.join(root, "tests", "vectors")
    recs = []
    with open(os.path.join(vec, "ed25519_wycheproof.json")) as f:
        for v in json.load(f):
            recs.append((bytes.fromhex(v["sig"]), bytes.fromhex(v["pub"]),
                         bytes.fromhex(v["msg"]), bool(v["ok"])))
    for name, expect in (("malleability_should_pass.bin", True),
                         ("malleability_should_fail.bin", False)):
        with open(os.path.join(vec, name), "rb") as f:
            raw = f.read()
        for off in range(0, len(raw), 96):
            recs.append((raw[off:off + 64], raw[off + 64:off + 96],
                         b"Zcash", expect))
    n, width = len(recs), max(len(r[2]) for r in recs)
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    msg = np.zeros((n, width), np.uint8)
    ln = np.zeros(n, np.int32)
    want = np.zeros(n, bool)
    for i, (s, p, m, ok) in enumerate(recs):
        sig[i], pub[i] = np.frombuffer(s, np.uint8), np.frombuffer(p, np.uint8)
        msg[i, :len(m)] = np.frombuffer(m, np.uint8)
        ln[i], want[i] = len(m), ok
    return sig, pub, msg, ln, want


def main() -> int:
    global torch
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from firedancer_tpu_torch.ops import (_build, cuda_blake3, cuda_ed,
                                          cuda_msm, cuda_sha, cuda_sha256,
                                          cuda_wave)
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import msm, sha2
    from firedancer_tpu_torch.ops.params import fixed_base_tables
    from firedancer_tpu_torch.tiles.synth import make_signed_txns
    from firedancer_tpu_torch.utils.chaos import (
        attack_frames, torsion_sign, undecodable_point)

    def counts() -> dict:
        return {**cuda_sha.launches, "ed25519_verify": cuda_ed.launches,
                **cuda_msm.launches, **cuda_wave.launches,
                **cuda_sha256.launches, **cuda_blake3.launches}

    def reset_counts():
        cuda_ed.launches = 0
        cuda_sha.launches.update(sha512=0, sha512_ram=0)
        cuda_msm.launches.update(msm_stage1=0, msm_stage2=0)
        cuda_wave.launches.update(wave_scan=0)
        cuda_sha256.launches.update(sha256=0, poh_verify=0)
        cuda_blake3.launches.update(blake3=0, lthash=0)

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    card = f"[{smi}]"

    # 1. device report
    log(f"== 1. device: {kind}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. build every kernel source (one nvcc per source, started together)
    log("== 2. build")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"nvcc wall {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, (sec, out) in sorted(built.items()):
        log(f"  {name}: {sec:.2f} s")
        for line in out.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "stack frame")):
                log(f"    {line.strip()}")

    # 3. SHA-512: kernel == plain == hashlib, R||A||M lengths 64..1296
    log("== 3. sha512 kernel vs plain vs hashlib")
    width = MSG_LEN + 64
    rng = np.random.default_rng(1)
    lens = rng.integers(64, width + 1, B).astype(np.int32)
    lens[:10] = [64, 111, 112, 127, 128, 239, 240, 255, 256, width]
    hmsg = rng.integers(0, 256, (B, width), np.uint8)
    hmsg[np.arange(width)[None, :] >= lens[:, None]] = 0
    m_d = torch.from_numpy(hmsg).to(dev)
    l_d = torch.from_numpy(lens).to(dev)
    got = cuda_sha.sha512(m_d, l_d)
    plain = sha2.sha512(m_d, l_d)
    torch.cuda.synchronize()
    sha_err = int((got.int() - plain.int()).abs().max())
    want = np.stack([np.frombuffer(hashlib.sha512(
        hmsg[i, :lens[i]].tobytes()).digest(), np.uint8) for i in range(B)])
    assert sha_err == 0, f"sha512 kernel != plain (max err {sha_err})"
    assert np.array_equal(got.cpu().numpy(), want), "sha512 != hashlib"
    log(f"sha512: {B} lanes, kernel == plain == hashlib, max_abs_err 0")

    # 3b. SHA-512's in-place entry: k64 and the prechecks, kernel == plain,
    # on every precheck class (lane % 8: 0 and 7 valid, 1 S = l - 1, 2 S =
    # l, 3 S = l + 5, 4 A.y >= p, 5 small-order A, 6 small-order R), at
    # the main path's row width (staged 16-byte pieces) and at an
    # unaligned one (each thread's own reads)
    log("== 3b. sha512_ram kernel vs plain (R||A||M in place, prechecks)")
    t0 = time.perf_counter()
    sig, pub, msg, ln = signed_batch(N_UNIQUE, B, MSG_LEN, 2)
    log(f"signed {N_UNIQUE} unique messages in "
        f"{time.perf_counter() - t0:.1f} s")
    pcls = np.arange(B) % 8
    psig, ppub = sig.copy(), pub.copy()
    for k, v in ((1, ed.L - 1), (2, ed.L), (3, ed.L + 5)):
        psig[pcls == k, 32:] = np.frombuffer(v.to_bytes(32, "little"),
                                             np.uint8)
    ppub[pcls == 4] = np.frombuffer(((1 << 255) - 1).to_bytes(32, "little"),
                                    np.uint8)
    ppub[pcls == 5] = ed._small_order_encodings()[3]
    psig[pcls == 6, :32] = ed._small_order_encodings()[6]
    want_pre = np.isin(pcls, (0, 1, 7)).astype(np.int32)
    ram_err = 0
    for w in (MSG_LEN, MSG_LEN - 3):
        plens = rng.integers(0, w + 1, B).astype(np.int32)
        plens[:8] = [0, 47, 48, 111, 112, 175, 176, w]
        pmsg = rng.integers(0, 256, (B, w), np.uint8)
        ins = [torch.from_numpy(x).to(dev) for x in (psig, ppub, pmsg, plens)]
        k_k, pre_k = cuda_sha.sha512_ram(*ins)
        k_p, pre_p = sha2.sha512_ram(*ins)
        torch.cuda.synchronize()
        err = max(int((k_k.int() - k_p.int()).abs().max()),
                  int((pre_k - pre_p).abs().max()))
        assert err == 0, f"sha512_ram kernel != plain at width {w}"
        assert np.array_equal(pre_k.cpu().numpy(), want_pre)
        for i in (0, 7, 8, B - 1):
            assert bytes(k_k[i].cpu().numpy()) == hashlib.sha512(
                psig[i, :32].tobytes() + ppub[i].tobytes()
                + pmsg[i, :plens[i]].tobytes()).digest()
        ram_err = max(ram_err, err)
        log(f"sha512_ram: {B} lanes, row width {w}, k64 and pre: kernel == "
            f"plain (hashlib on 4 lanes), prechecks pass on "
            f"{int(want_pre.sum())}, max_abs_err {err}")

    # 4. fused verify core: kernel == plain on mixed lanes, at 8192 (blocks
    # of 256 threads), at the tile's 2048 and at a ragged 2045 (blocks of
    # 128)
    log("== 4. ed25519_verify kernel vs plain (mixed verdicts)")
    msig, mpub, mmsg = sig.copy(), pub.copy(), msg.copy()
    expect = corrupt(msig, mpub, mmsg)
    k64 = k64_of(msig, mpub, mmsg, ln)
    s_d, p_d, k_d = (torch.from_numpy(x).to(dev) for x in (msig, mpub, k64))
    ver_err = 0
    for b in (B, SMALL_B, SMALL_B - 3):
        core = cuda_ed.verify_core(s_d[:b], p_d[:b], k_d[:b])
        core_plain = ed.verify_core(s_d[:b], p_d[:b], k_d[:b],
                                    fixed_base_tables(dev))
        torch.cuda.synchronize()
        err = int((core - core_plain).abs().max())
        assert err == 0, f"verify kernel != plain at {b} lanes on " \
            f"{int((core != core_plain).sum())} lanes"
        c = core.cpu().numpy()
        assert c.any() and not c.all()
        log(f"ed25519_verify: {b} lanes, kernel == plain (core passes "
            f"{int(c.sum())}), max_abs_err {err}")
        ver_err = max(ver_err, err)
    full = cuda_ed.verify_batch(msig, mpub, mmsg, ln,
                                device=DEVICE).cpu().numpy()
    assert np.array_equal(full, expect), \
        f"verify_batch != expected on {int((full != expect).sum())} lanes"
    log(f"verify_batch: {B} lanes == expected ({int(full.sum())} valid)")

    # 5. every Wycheproof and malleability vector through the kernels
    log("== 5. vectors")
    vs, vp, vm, vl, vwant = load_vectors(root)
    vgot = cuda_ed.verify_batch(vs, vp, vm, vl, device=DEVICE).cpu().numpy()
    bad = np.nonzero(vgot != vwant)[0]
    assert bad.size == 0, f"vectors: {bad.size} mismatches, first {bad[:10]}"
    log(f"vectors: {len(vwant)} of {len(vwant)} verdicts as the files "
        f"expect ({int(vwant.sum())} pass, {int((~vwant).sum())} fail)")

    # each kernel's own time at the main path's shape, the plain
    # version's, and the bound (launches here are not the main path's)
    log("== 6a. kernel times at the main path's shape " + card)
    hv = np.zeros((B, width), np.uint8)
    hv[:, :32], hv[:, 32:64], hv[:, 64:] = sig[:, :32], pub, msg
    hv_d = torch.from_numpy(hv).to(dev)
    hl_d = torch.full((B,), width, dtype=torch.int32, device=dev)
    vs_d, vp_d, vm_d, vl_d = (torch.from_numpy(x).to(dev)
                              for x in (sig, pub, msg, ln))
    vk_d = cuda_sha.sha512_ram(vs_d, vp_d, vm_d, vl_d)[0]
    stats = {}
    sha_blocks = int(sha2.nblocks(hl_d.long()).sum())
    muls = field_muls_per_verify()
    sv, pv, kv = vs_d[:SMALL_B], vp_d[:SMALL_B], vk_d[:SMALL_B]
    sm, sl = vm_d[:SMALL_B], vl_d[:SMALL_B]
    fb_bytes = fixed_base_tables(dev).numel() * 4
    # the in-place entry reads R, S, A and the message, writes k64 and pre
    ram_bytes = B * (64 + 32 + MSG_LEN + 4 + 64 + 4)
    for name, fn, pfn, iters, ops, nbytes in (
            ("sha512", lambda: cuda_sha.sha512(hv_d, hl_d),
             lambda: sha2.sha512(hv_d, hl_d), ITERS,
             sha_blocks * SHA_OPS_PER_BLOCK, B * (width + 4 + 64)),
            ("sha512_ram", lambda: cuda_sha.sha512_ram(vs_d, vp_d, vm_d, vl_d),
             lambda: sha2.sha512_ram(vs_d, vp_d, vm_d, vl_d), ITERS,
             sha_blocks * SHA_OPS_PER_BLOCK, ram_bytes),
            (f"sha512_ram@{SMALL_B}",
             lambda: cuda_sha.sha512_ram(sv, pv, sm, sl),
             lambda: sha2.sha512_ram(sv, pv, sm, sl), ITERS,
             sha_blocks * SHA_OPS_PER_BLOCK * SMALL_B // B,
             ram_bytes * SMALL_B // B),
            ("ed25519_verify", lambda: cuda_ed.verify_core(vs_d, vp_d, vk_d),
             lambda: ed.verify_core(vs_d, vp_d, vk_d, fixed_base_tables(dev)),
             ITERS, B * muls * OPS_PER_FIELD_MUL,
             B * (64 + 32 + 64 + 4) + fb_bytes),
            (f"ed25519_verify@{SMALL_B}",
             lambda: cuda_ed.verify_core(sv, pv, kv),
             lambda: ed.verify_core(sv, pv, kv, fixed_base_tables(dev)),
             ITERS, SMALL_B * muls * OPS_PER_FIELD_MUL,
             SMALL_B * (64 + 32 + 64 + 4) + fb_bytes)):
        st = stats[name] = stats_of(cuda_ms(fn, iters), cuda_ms(pfn, 1), ops,
                                    nbytes)
        log(f"{name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.2f} "
            f"ms, bound {st['bound_ms']:.4f} ms ({ops:.4g} int32 ops -> "
            f"{st['ops_ms']:.4f} ms, {nbytes} B -> {st['bytes_ms']:.4f} ms), "
            f"{st['ms'] / st['bound_ms']:.1f}x the bound {card}")
    log(f"field multiplies per verify: {muls}; sha512 blocks per batch: "
        f"{sha_blocks}")
    # is sha512_ram bound by the card's rate or by one lane's chain of
    # blocks? the same rows at 4 x the lanes (4 x the work), and the same
    # lanes with empty messages (one block each instead of 11)
    big = [x.repeat(4, *([1] * (x.dim() - 1))) for x in (vs_d, vp_d, vm_d,
                                                          vl_d)]
    empty = torch.zeros_like(vl_d)
    for label, args in ((f"{4 * B} lanes", big),
                        (f"{B} lanes, empty messages",
                         (vs_d, vp_d, vm_d, empty))):
        ms = cuda_ms(lambda: cuda_sha.sha512_ram(*args), ITERS)
        log(f"sha512_ram at {label}: {ms:.4f} ms (at {B} lanes, "
            f"{MSG_LEN}-byte messages: {stats['sha512_ram']['ms']:.4f} ms) "
            f"{card}")
    assert torch.equal(cuda_ed.verify_core(vs_d, vp_d, vk_d),
                       torch.ones(B, dtype=torch.int32, device=dev))

    # 6. strict path: verify_batch at 8192 x 1232, all valid
    reset_counts()
    log(f"== 6. strict path: verify_batch {B} x {MSG_LEN} {card}")
    ins = [torch.from_numpy(x).to(dev) for x in (sig, pub, msg, ln)]
    ok = cuda_ed.verify_batch(*ins, device=DEVICE)
    assert bool(ok.all()), f"{int((~ok).sum())} valid lanes rejected"
    ms = cuda_ms(lambda: cuda_ed.verify_batch(*ins, device=DEVICE),
                 ITERS)
    strict_ms = ms
    launches6 = counts()
    kern = stats["sha512_ram"]["ms"] + stats["ed25519_verify"]["ms"]
    log(f"verify_batch: {ms:.3f} ms per {B}-lane batch, "
        f"{B / ms * 1e3:.0f} verifies/s over {ITERS} iterations; the two "
        f"kernels {kern:.4f} ms, the rest (glue and launches) "
        f"{ms - kern:.4f} ms = {100 * (ms - kern) / ms:.1f}% {card}")

    # 7. the verify tile over real shm rings
    log(f"== 7. tile: synth -> ring -> VerifyTile(batch={TILE_BATCH}) -> ring")
    t0 = time.perf_counter()
    txns = make_signed_txns(TILE_UNIQUE, seed=7)
    frames = list(txns)
    for c in range(TILE_CORRUPT):              # distinct bad signatures
        bad = bytearray(txns[c % TILE_UNIQUE])
        bad[1 + 32 + c // TILE_UNIQUE] ^= 1    # S, so the tag is its own
        frames.append(bytes(bad))
    prng = np.random.default_rng(8)
    frames += [txns[i] for i in prng.integers(
        0, TILE_UNIQUE, TILE_FRAMES - len(frames))]
    frames = [frames[i] for i in prng.permutation(len(frames))]
    log(f"{len(frames)} frames ({TILE_UNIQUE} unique valid, {TILE_CORRUPT} "
        f"corrupt) built in {time.perf_counter() - t0:.1f} s")
    out, m, _, (sec,) = run_tile([frames], TILE_FRAMES)
    log(f"tile metrics {json.dumps(m)}")
    log(f"tile: {len(frames)} frames in {sec:.3f} s, {len(frames) / sec:.0f} "
        f"frames/s, {m['batches']} device batches {card}")
    want_m = dict(rx=TILE_FRAMES, parse_fail=0, tx=TILE_UNIQUE,
                  verify_fail=TILE_CORRUPT,
                  dedup_drop=TILE_FRAMES - TILE_UNIQUE - TILE_CORRUPT)
    for key, val in want_m.items():
        assert m[key] == val, f"tile {key} = {m[key]}, expected {val}"
    assert sorted(out) == sorted(txns), "out ring != the unique valid txns"
    no_fallback("7", m)
    frames7, out7, m7 = frames, out, m
    strict_path = counts()
    log(f"strict path launches: verify_batch phase {launches6}, with the "
        f"tile {strict_path}")
    assert launches6["sha512"] > 0 and launches6["ed25519_verify"] > 0
    assert strict_path["sha512"] > launches6["sha512"] and \
        strict_path["ed25519_verify"] > launches6["ed25519_verify"]

    # 8a. MSM stage 1, kernel vs plain, at 8192 lanes with every lane
    # class: valid, non-decodable R (lane % 64 == 1) and A (== 5), S >= l
    # (== 2), small-order A (== 3) and R (== 4), A.y >= p (== 7) and
    # R.y >= p (== 9) out of lane_ok; z = 0 (== 6) and z = 2^128 - 1
    # (== 8) kept
    log(f"== 8a. msm_stage1 kernel vs plain ({B} x {MSG_LEN}, every lane "
        f"class)")
    cls = np.arange(B) % 64
    csig, cpub = sig.copy(), pub.copy()
    p1 = np.frombuffer(((1 << 255) - 18).to_bytes(32, "little"), np.uint8)
    csig[cls == 1, :32] = undecodable_point(11)
    csig[cls == 2, 32:] = np.frombuffer((ed.L + 5).to_bytes(32, "little"),
                                        np.uint8)
    cpub[cls == 3] = ed._small_order_encodings()[1]
    csig[cls == 4, :32] = ed._small_order_encodings()[3]
    cpub[cls == 5] = undecodable_point(12)
    cpub[cls == 7] = p1
    csig[cls == 9, :32] = p1
    zb = np.random.default_rng(9).integers(0, 256, (B, 16), np.uint8)
    zb[cls == 6] = 0
    zb[cls == 8] = 0xFF
    captured = {}

    def recorded(key, fn):
        def f(*a):
            captured[key] = a
            return fn(*a)
        return f
    c_ins = [torch.from_numpy(x).to(dev) for x in (csig, cpub, msg, ln)]
    z_d = torch.from_numpy(zb).to(dev)
    ok, pre = ed.rlc_verify(*c_ins, z_d, cuda_sha.sha512_ram,
                            recorded("s1", cuda_msm.msm_stage1),
                            recorded("s2", cuda_msm.msm_stage2))
    want_pre = ~np.isin(cls, (1, 2, 3, 4, 5, 7, 9))
    assert bool(ok) and np.array_equal(pre.cpu().numpy(), want_pre), \
        "rlc verdict on the lane-class batch"
    got1 = cuda_msm.msm_stage1(*captured["s1"])
    want1 = msm.msm_stage1(*captured["s1"])
    torch.cuda.synchronize()
    s1_err = max(int((g.long() - w.long()).abs().max())
                 for g, w in zip(got1, want1))
    assert s1_err == 0, f"msm_stage1 kernel != plain (max err {s1_err})"
    log(f"msm_stage1: {B} lanes, {got1[0].shape[0]} blocks x 64 window "
        f"sums, kernel == plain in every limb, lane_ok and sdig equal, "
        f"max_abs_err 0")

    # 8b. MSM stage 2, kernel vs plain: the verdict and the sum's limbs,
    # for the batch's digit sums (it verifies) and with one digit raised
    # by 1 (it does not), over the lane-class batch's stage 1 at B = 8192
    # lanes (128 blocks: chunks of 12), SMALL_B = 2048 (32: chunks of 6)
    # and RAGGED_B = 5000 (79: chunks of 9, the last ragged)
    log("== 8b. msm_stage2 kernel vs plain (verdict and canonical sum)")
    tab = fixed_base_tables(dev)
    s2_err = 0
    for b in (B, SMALL_B, RAGGED_B):
        if b == B:
            wsum, sdig = captured["s2"]
        else:
            wsum, _, sdig = cuda_msm.msm_stage1(
                *(x[:b] for x in captured["s1"]))
        sdig_bad = sdig.clone()
        sdig_bad[0, 0] += 1
        for d_in, verdict in ((sdig, 1), (sdig_bad, 0)):
            ok_k, pt_k = cuda_msm.msm_stage2(wsum, d_in)
            ok_p, pt_p = msm.msm_stage2(wsum, d_in, tab)
            torch.cuda.synchronize()
            err = max(abs(int(ok_k) - int(ok_p)),
                      int((pt_k - pt_p).abs().max()))
            assert err == 0, f"msm_stage2 kernel != plain at {b} lanes"
            assert int(ok_k) == verdict, f"msm_stage2 verdict {int(ok_k)}"
            if verdict:                # the identity: X = 0, Y = Z
                assert not pt_k[0].any() and torch.equal(pt_k[1], pt_k[2])
            s2_err = max(s2_err, err)
        log(f"msm_stage2: {b} lanes ({wsum.shape[0]} blocks, chunks of "
            f"{msm.chunk_len(wsum.shape[0])}), verdicts 1 and 0 as "
            f"expected, kernel == plain (verdict and every canonical "
            f"limb), max_abs_err 0")

    # 8c. RLC path: rlc_verify_batch at 8192 x 1232 through the kernels,
    # each verdict equal to the plain version's on the card
    log(f"== 8c. RLC path: rlc_verify_batch {B} x {MSG_LEN} {card}")
    reset_counts()
    zv = np.random.default_rng(10).integers(0, 256, (B, 16), np.uint8)
    fmsg = msg.copy()
    fmsg[3, 0] ^= 1                    # lane 3's message forged
    ssig, spub = sig.copy(), pub.copy()
    ssig[10, 32:] = np.frombuffer((ed.L + 5).to_bytes(32, "little"),
                                  np.uint8)
    spub[20] = ed._small_order_encodings()[1]
    ssig[30, :32] = undecodable_point(13)
    tsig, tpub = sig.copy(), pub.copy()
    t_pub, t_sig = torsion_sign(b"\x33" * 32, msg[0].tobytes())
    tpub[0], tsig[0] = np.frombuffer(t_pub, np.uint8), \
        np.frombuffer(t_sig, np.uint8)
    z0, z1 = zv.copy(), zv.copy()
    z0[0, 0] &= 0xF8                   # z_0 = 0 mod 8
    z1[0, 0] |= 1                      # z_0 odd
    all_pre = np.ones(B, bool)
    cases = (("all valid", (sig, pub, msg), zv, True, all_pre),
             ("lane 3 forged", (sig, pub, fmsg), zv, False, all_pre),
             ("S >= l, small-order A, non-decodable R", (ssig, spub, msg),
              zv, True, ~np.isin(np.arange(B), (10, 20, 30))),
             ("torsion lane, z_0 = 0 mod 8", (tsig, tpub, msg), z0, True,
              all_pre),
             ("torsion lane, z_0 odd", (tsig, tpub, msg), z1, False, None))
    for label, (cs, cp, cm), cz, want_ok, want_pre in cases:
        c_in = [torch.from_numpy(x).to(dev) for x in (cs, cp, cm, ln, cz)]
        ok, pre = cuda_msm.rlc_verify_batch(*c_in, device=DEVICE)
        ok_p, pre_p = ed.rlc_verify_batch(*c_in, device=DEVICE)
        assert bool(ok) == bool(ok_p) == want_ok, f"rlc {label}: {bool(ok)}"
        assert torch.equal(pre, pre_p), f"rlc {label}: lane_pre != plain"
        if want_pre is not None:
            assert np.array_equal(pre.cpu().numpy(), want_pre), label
        log(f"rlc {label}: batch_ok {bool(ok)}, lane_pre false on "
            f"{int((~pre).sum())} lanes, kernels == plain")
    rlc_path = counts()
    log(f"RLC path launches {rlc_path}")
    assert min(rlc_path[k] for k in ("sha512", "msm_stage1",
                                     "msm_stage2")) > 0

    # 8d. each MSM kernel's own time at the RLC path's shape (all valid)
    # and at the tile's chunk, the plain version's, the bound; and the
    # whole rlc_verify_batch
    log(f"== 8d. MSM kernel times at {B} and {SMALL_B} lanes {card}")
    v_in = [torch.from_numpy(x).to(dev) for x in (sig, pub, msg, ln, zv)]
    sha_ms = stats["sha512_ram"]["ms"]
    ident = ed._identity(torch.zeros((1, 10), dtype=torch.int64))
    add_muls = count_field_muls(ed._add_full, ident, ident)[1]
    for b in (B, SMALL_B):
        ed.rlc_verify(*(x[:b] for x in v_in), cuda_sha.sha512_ram,
                      recorded("v1", cuda_msm.msm_stage1),
                      recorded("v2", cuda_msm.msm_stage2))
        nblk = -(-b // msm.LANES)
        wbytes = nblk * 64 * 160
        _, muls1 = count_field_muls(msm.msm_stage1, *captured["v1"])
        _, muls2 = count_field_muls(msm.msm_stage2, *captured["v2"], tab)
        # the plain version also adds, and drops, the steps of its last
        # chunk past the last block; the kernel's bound counts only the
        # adds the sums need
        S = msm.chunk_len(nblk)
        C = -(-nblk // S)
        muls2 -= (C * S - nblk) * 64 * add_muls
        sc_ops = b * SCALAR_OPS_PER_LANE
        tag = "" if b == B else f"@{b}"
        for name, fn, pfn, ops, nbytes in (
                ("msm_stage1", lambda: cuda_msm.msm_stage1(*captured["v1"]),
                 lambda: msm.msm_stage1(*captured["v1"]),
                 muls1 * OPS_PER_FIELD_MUL + sc_ops,
                 b * (32 + 64 + 64 + 16 + 4) + wbytes + nblk * 13 * 8),
                ("msm_stage2", lambda: cuda_msm.msm_stage2(*captured["v2"]),
                 lambda: msm.msm_stage2(*captured["v2"], tab),
                 muls2 * OPS_PER_FIELD_MUL,
                 wbytes + nblk * 13 * 8 + 64 * 120 + 41 * 4)):
            st = stats[name + tag] = stats_of(cuda_ms(fn, ITERS),
                                              cuda_ms(pfn, 1), ops, nbytes)
            log(f"{name}{tag}: kernel {st['ms']:.4f} ms, plain "
                f"{st['plain_ms']:.2f} ms, bound {st['bound_ms']:.4f} ms "
                f"({ops:.4g} int32 ops -> {st['ops_ms']:.4f} ms, {nbytes} "
                f"B -> {st['bytes_ms']:.4f} ms), "
                f"{st['ms'] / st['bound_ms']:.1f}x the bound {card}")
        log(f"{b} lanes: field multiplies stage 1 {muls1} ({muls1 / b:.1f} "
            f"per lane), stage 2 {muls2}; stage 1's scalar work {sc_ops} "
            f"int32 ops, {100 * sc_ops / (muls1 * OPS_PER_FIELD_MUL):.2f}% "
            f"of its field multiplies'; stage 2's chain: {S - 1} + {C - 1} "
            f"adds over {nblk} blocks (chunks of {S}), then 252 doublings "
            f"and 63 adds on a group (693 rounds), then one add")
    ms = cuda_ms(lambda: cuda_msm.rlc_verify_batch(*v_in, device=DEVICE),
                 ITERS)
    kern = sha_ms + stats["msm_stage1"]["ms"] + stats["msm_stage2"]["ms"]
    log(f"rlc_verify_batch: {ms:.3f} ms per {B}-lane batch, "
        f"{B / ms * 1e3:.0f} lanes/s over {ITERS} iterations; the three "
        f"kernels {kern:.4f} ms, the rest (glue and launches) "
        f"{ms - kern:.4f} ms = {100 * (ms - kern) / ms:.1f}%; strict "
        f"verify_batch (phase 6) {strict_ms:.3f} ms, "
        f"{B / strict_ms * 1e3:.0f} verifies/s {card}")

    # 9. the flood front door: the verify tile in bulk_prefilter mode with
    # the coalescing window of cfg/flood-demo.toml
    log(f"== 9. tile: synth -> ring -> VerifyTile(batch={TILE_BATCH}, "
        f"mode=bulk_prefilter, coalesce_us=150000) -> ring")
    t0 = time.perf_counter()
    pool = attack_frames("flood_forged", 8, seed=3)

    def forged(k):
        # a forged pool frame made unique: bytes 8..11 of S carry k, so
        # every frame has its own dedup tag and its own device lane
        f = bytearray(pool[k % len(pool)])
        f[1 + 40:1 + 44] = k.to_bytes(4, "little")
        return bytes(f)
    n_flood = FLOOD_CHUNKS * TILE_BATCH
    torsion = attack_frames("flood_torsion", 8, seed=21)
    assert len(set(torsion)) == 8
    frames = [forged(k) for k in range(n_flood)] + list(txns) \
        + [forged(n_flood + k) for k in range(FLOOD_MIX_FORGED)] + torsion
    log(f"{len(frames)} frames ({n_flood} forged in {FLOOD_CHUNKS} full "
        f"chunks, then {TILE_UNIQUE} valid, {FLOOD_MIX_FORGED} forged, 8 "
        f"torsion) built in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    out, m, _, (sec,) = run_tile([frames], 16384, mode="bulk_prefilter",
                                 coalesce_us=150000)
    flood_path = counts()
    log(f"tile metrics {json.dumps(m)}")
    log(f"flood tile: {len(frames)} frames in {sec:.3f} s, "
        f"{len(frames) / sec:.0f} frames/s, {m['rlc_batches']} RLC "
        f"equations ({m['rlc_ns'] / 1e6:.1f} ms), {m['batches']} strict "
        f"batches {card}")
    want_m = dict(rx=len(frames), parse_fail=0, dedup_drop=0, tx=TILE_UNIQUE,
                  rlc_shed=n_flood,
                  verify_fail=n_flood + FLOOD_MIX_FORGED + 8)
    for key, val in want_m.items():
        assert m[key] == val, f"flood tile {key} = {m[key]}, expected {val}"
    assert sorted(out) == sorted(txns), "out ring != the unique valid txns"
    assert not set(out) & set(torsion), "a torsion forgery was forwarded"
    no_fallback("9", m)
    log(f"flood path launches {flood_path}")
    assert min(flood_path[k] for k in ("sha512", "ed25519_verify",
                                       "msm_stage1", "msm_stage2")) > 0

    # 10. the main path as the system runs it: the topology launcher
    # boots synth -> verify -> dedup -> sink as four tile processes over
    # shm from the port's TOML; the verify tile's kernel launches happen
    # in its own process, so its batch counts stand for them
    for tag, count, verify in (("10a", TOPO_FRAMES, {}),
                               ("10b", TOPO_PREFILTER_FRAMES,
                                {"verify_last": True,
                                 "mode": "bulk_prefilter"})):
        log(f"== {tag}. topology: cfg/sigverify.toml, {count} frames, "
            f"verify {verify or 'strict'}, four tile processes {card}")
        rec, v = run_topology(root, tag, count, **verify)
        if tag == "10a":
            rec10a = rec
        log(f"{tag} verify metrics {json.dumps(v)}")
        log(f"{tag} record {json.dumps(rec)}")
        log(f"{tag}: e2e {rec['e2e_tps']:.0f} frames/s ({count} frames in "
            f"{rec['e2e_wall_s']:.4f} s after every tile ran; boot "
            f"{rec['boot_s']:.1f} s), verify work p50/p99 "
            f"{rec['verify_work_p50_ms']:.4f}/{rec['verify_work_p99_ms']:.4f}"
            f" ms, tpu p50/p99 {rec['tpu_p50_ms']:.4f}/"
            f"{rec['tpu_p99_ms']:.4f} ms over {rec['tpu_count']} spans "
            f"(verify polls by ms bucket {rec['verify_work_polls_by_ms']}), "
            f"device seam {100 * rec['device_seam_share']:.2f}% of verify "
            f"work, {v['batches']} strict batches, rlc_batches "
            f"{v['rlc_batches']}, rlc_pass {v['rlc_pass']} {card}")
        if "mode" in verify:
            assert v["rlc_batches"] > 0, "no RLC equation in the tile"
            assert v["rlc_pass"] == v["rlc_batches"] and \
                v["rlc_shed"] == 0, "a valid chunk failed the RLC equation"

    # 10c. bench.py's _e2e_run as it runs by default: 10a's topology with
    # the fdprof sampler on every tile at 29 Hz
    log(f"== 10c. topology profiled: cfg/sigverify.toml, {TOPO_FRAMES} "
        f"frames, [prof] at {E2E_PROF_HZ:g} Hz on every tile {card}")
    rec10c = run_profiled_e2e(root, card, rec10a)

    # 11. the leader's execution leg in process: the wave-scan kernel
    # against its plain version at phase 11's five shapes
    # (firedancer_tpu_torch/tools/wave_bench.py: bank0's wave, the bank's
    # observed wave, the random u64-edge block through the ring, balances
    # in device memory, an all-inactive table), with its time on the
    # device and a call's from Python; then the pipelined WaveExecutor
    # against the serial oracle
    from firedancer_tpu_torch.funk import Funk
    from firedancer_tpu_torch.svm import executor as texec
    from firedancer_tpu_torch.tools import wave_bench
    log(f"== 11. wave scan kernel vs plain; pipelined WaveExecutor {card}")
    per_wave = wave_bench.BANK_WAVE[0] * wave_bench.BANK_WAVE[1]
    bench_txns, bench_gen = wave_bench.synth_transfers(
        per_wave * PIPE_WAVES, 17)
    wave_err = 0
    for name, txns, gen, tables in wave_bench.shapes(bench_txns[:per_wave],
                                                     bench_gen):
        packed, hi, lo, w, c, lanes = tables
        r = wave_bench.run_shape(cuda_wave, tables, ITERS, dev)
        assert r["err"] == 0 and r["equal_statuses"], \
            f"{name}: kernel != plain (max err {r['err']})"
        st = r["statuses"]
        hist = {k: int((st == k).sum()) for k in (0, 1, 2)}
        assert sum(hist.values()) == lanes == len(txns)
        if name == "wave_scan":
            oracle = dict(gen)
            assert sorted(texec.execute_block_serial(oracle, txns)) \
                == sorted(st[st >= 0].tolist())
        elif name in ("wave_scan@random", "wave_scan@global_balances"):
            assert min(hist.values()) > 0, f"{name}: statuses {hist}"
        wave_err = max(wave_err, r["err"])
        ops = lanes * WAVE_OPS_PER_LANE + len(hi) * WAVE_OPS_PER_ACCT
        nbytes = packed.nbytes + 4 * hi.nbytes + st.nbytes
        st_ = stats[name] = stats_of(r["ms"], r["plain_ms"], ops, nbytes)
        st_.update(call_ms=r["call_ms"], plan=r["plan"])
        pl = r["plan"]
        log(f"{name}: {len(txns)} transfers, {len(hi)} account slots, "
            f"{w} waves x {c} lanes (staged {packed.shape[0]} x "
            f"{packed.shape[1]}), statuses ok/insufficient/fee_fail "
            f"{hist[0]}/{hist[1]}/{hist[2]}; kernel == plain, max_abs_err "
            f"{r['err']}; plan: "
            f"{'ring of %d slots' % pl['slots'] if pl['ring'] else 'resident'}"
            f" for {pl['chunks']} chunks of {pl['chunk_lanes']} lanes, "
            f"balances in {'shared' if pl['sbal'] else 'device'} memory, "
            f"{pl['threads']} threads ({pl['scan_threads']} scanning), "
            f"{pl['smem']} B shared; kernel {st_['ms']:.4f} ms on the "
            f"device (CUDA graph of {ITERS} launches; "
            f"{1e3 * st_['ms'] / packed.shape[0]:.3f} us a staged wave "
            f"step), {r['call_ms']:.4f} ms a call from Python (CUDA events "
            f"over {ITERS} calls), plain {st_['plain_ms']:.2f} ms, bound "
            f"{st_['bound_ms']:.6f} ms ({ops} int32 ops -> "
            f"{st_['ops_ms']:.6f} ms, {nbytes} B -> {st_['bytes_ms']:.6f} "
            f"ms); critical chain {packed.shape[0]} dependent wave steps "
            f"{card}")
    reset_counts()
    funk = Funk()
    for k, v in bench_gen.items():
        funk.rec_write(None, k, v)
    oracle = dict(bench_gen)
    want_st = texec.execute_block_serial(oracle, bench_txns)
    wx = texec.WaveExecutor(DEVICE)
    pending, got_st = None, []
    t0 = time.perf_counter()
    for k in range(PIPE_WAVES):
        staged = wx.stage(bench_txns[k * per_wave:(k + 1) * per_wave])
        if pending is not None:
            got_st += wx.finalize(funk, pending)
            funk.txn_publish(pending.xid)
        pending = wx.dispatch(funk, None, k + 1, staged)
    got_st += wx.finalize(funk, pending)
    funk.txn_publish(pending.xid)
    pipe_s = time.perf_counter() - t0
    exec_path = counts()
    assert got_st == want_st, "pipelined WaveExecutor != serial oracle"
    assert funk.root_items() == oracle, "funk balances != serial oracle"
    assert exec_path["wave_scan"] == PIPE_WAVES, exec_path
    log(f"pipelined WaveExecutor: {PIPE_WAVES} bank waves of {per_wave} "
        f"transfers, statuses and every balance == execute_block_serial, "
        f"{pipe_s * 1e3:.2f} ms host wall ({len(bench_txns) / pipe_s:.0f} "
        f"transfers/s), launches {exec_path} {card}")

    # 12. the leader's execution leg as the system runs it:
    # cfg/leader.toml booted by the topology launcher; the bank counts the
    # wave scans it launches in its own process (wave_launches), the
    # verify shards their strict batches
    log(f"== 12. topology: cfg/leader.toml, {LEADER_FRAMES} frames, "
        f"verify x2 (pinned by bench.py's rule) and bank0 on the card "
        f"{card}")
    rec, wires12 = run_leader(root, "12")
    log(f"12 record {json.dumps(rec)}")
    log(f"12: e2e_leader_tps {rec['e2e_leader_tps']:.1f} "
        f"({rec['e2e_leader_count']} bank txns in {rec['e2e_leader_wall_s']:.3f} s from RUN to drained; "
        f"boot {rec['boot_s']:.1f} s, not gated, the verify shards' first "
        f"np.isin included), {rec['bank_microblocks']} microblocks "
        f"({rec['txns_per_microblock']:.2f} txns each), "
        f"{rec['bank_wave_launches']} wave scans, bank dispatch p50/p99 "
        f"{rec['bank_dispatch_p50_ms']:.3f}/{rec['bank_dispatch_p99_ms']:.3f}"
        f" ms, {100 * rec['bank_dispatch_share_of_work']:.1f}% of bank "
        f"work, verify batches {rec['verify_batches']}; work over the "
        f"drain window by tile " + ", ".join(
            f"{tn} {b['window_work_s']:.3f} s ({100 * b['window_share']:.0f}%)"
            for tn, b in sorted(rec["stage_budget"].items(),
                                key=lambda kv: -kv[1]["window_work_s"]))
        + f" {card}")


    hash_stats, hash_paths, hash_errs = run_hash_phases(dev, card, counts,
                                                         reset_counts)
    stats.update(hash_stats)

    # 17. the follower's check: in process on phase 12's wires (17a), and
    # its record (17c)
    rec17, follower_path, follower_errs, follower_timed = run_follower(
        root, dev, card, counts, reset_counts, wires12)
    log(f"17 record {json.dumps(rec17)}")

    # 18. the main path's fault drills and flight recorder
    rec18 = run_fault_drills(root, card, frames7, out7, m7, rec10a)
    log(f"18 record {json.dumps(rec18)}")

    # 19. the front door: gossvf on the card (19a), three gossip tiles
    # (19b) and cfg/flood.toml under a Sybil flood (19c)
    front_path, rec19 = run_front_door(root, card, counts, reset_counts)
    log(f"19 record {json.dumps(rec19)}")

    # 20. the exec tile family: in process (20a), bench.py's exec-scale
    # stage at 1 and 2 shards (20b) and the supervised kill (20c); the
    # shards count their own wave-scan launches
    exec_launches, rec20 = run_exec_family(root, card, counts, reset_counts)
    log(f"20 record {json.dumps(rec20)}")

    # 21. the breach-triggered device capture: the metric tile's SLO
    # engine rings the verify tile's doorbell, which opens a
    # torch.profiler window around its own launches
    log(f"== 21. cfg/sigverify.toml with [prof], [slo] and a metric tile: "
        f"the breach-triggered torch.profiler capture on the card {card}")
    rec21 = run_capture_drill(root, card)

    # 22. the cold-start follower: the real-format restore (22a),
    # bench.py's catch-up stage (22b), at 2^17 accounts (22c), the drills
    # (22d); the exec shards and the replay tile count their own launches
    cold_launches, rec22 = run_cold_start(root, card, counts, reset_counts)
    log(f"22 record {json.dumps(rec22, default=str)}")

    # 23. general execution: cfg/general.toml's vote-heavy leader with
    # bank0 exec="general" (23a), the in-process follower on the card and
    # the CPU with v0 through the lookup tables (23b), the replay's
    # launches and lthash at a vote-heavy slot delta (23c)
    general_launches, rec23 = run_general_exec(root, card, counts,
                                               reset_counts)
    log(f"23 record {json.dumps(rec23)}")

    # 24. the voting non-leader: the leader's turbine over UDP to
    # cfg/nonleader.toml, which repairs the dropped slots, replays them on
    # the card and signs TowerSync votes; the tiles count their launches
    rec24 = run_nonleader(root, card)
    log(f"24 record {json.dumps(rec24)}")

    # 25. a cluster from nothing: app.genesis, cfg/follower.toml restoring
    # it behind the card's leader from app.dev's layers; the follower
    # replays over two exec shards on the card, snapshots and votes; the
    # tiles count their launches
    rec25 = run_follower_demo(root, card, counts, reset_counts)
    log(f"25 record {json.dumps(rec25)}")

    kernels = []
    paths = (strict_path, rlc_path, flood_path, front_path)
    for name, src, rep, err in (
            ("sha512", "firedancer_tpu_torch/csrc/sha512.cu",
             "firedancer_tpu/ops/pallas_sha.py:35", max(sha_err, ram_err)),
            ("sha512_ram", "firedancer_tpu_torch/csrc/sha512.cu",
             "firedancer_tpu/ops/pallas_sha.py:35", ram_err),
            ("ed25519_verify", "firedancer_tpu_torch/csrc/ed25519_verify.cu",
             "firedancer_tpu/ops/pallas_ed.py:634", ver_err),
            ("msm_stage1", "firedancer_tpu_torch/csrc/ed25519_msm.cu",
             "firedancer_tpu/ops/pallas_msm.py:136", s1_err),
            ("msm_stage2", "firedancer_tpu_torch/csrc/ed25519_msm.cu",
             "firedancer_tpu/ops/pallas_msm.py:210", s2_err)):
        st = stats[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": sum(p[name] for p in paths),
                        "max_abs_err": err,
                        "ms": st["ms"], "plain_ms": st["plain_ms"],
                        "bound_ms": st["bound_ms"],
                        "bound_by": st["bound_by"], "library_ms": None})
    st = stats["wave_scan"]
    # the banks of phases 24 and 25 and phase 25's exec shards count
    # their wave scans in their own processes
    kernels.append({"name": "wave_scan", "route": "cuda",
                    "source": "firedancer_tpu_torch/csrc/wave_scan.cu",
                    "replaces": "firedancer_tpu/svm/executor.py:111",
                    "launches": exec_path["wave_scan"]
                    + rec["bank_wave_launches"] + exec_launches
                    + cold_launches["wave_scan"]
                    + rec24["bank_wave_launches"]
                    + rec25["launches"]["leader"]["wave_scan"]
                    + rec25["launches"]["follower"]["wave_scan"],
                    "max_abs_err": wave_err, "ms": st["ms"],
                    "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                    "bound_by": st["bound_by"], "library_ms": None})
    # the replay tiles (23's in process, 24's in their topology) count
    # their own launches
    f25 = rec25["launches"]["follower"]
    tile_launches = {"poh_verify": general_launches["poh_verify"]
                     + rec24["poh_launches"] + f25["poh_verify"],
                     "lthash": cold_launches["lthash"]
                     + general_launches["lthash"]
                     + rec24["lthash_launches"] + f25["lthash"]}
    for name, src, rep in (
            ("sha256", "sha256.cu", "firedancer_tpu/ops/sha2.py:211"),
            ("poh_verify", "sha256.cu", "firedancer_tpu/ops/poh.py:41"),
            ("blake3", "blake3.cu", "firedancer_tpu/ops/blake3.py:139"),
            ("lthash", "blake3.cu", "firedancer_tpu/ops/blake3.py:150")):
        st = stats[name]
        # the followers' replays: 17a's in-process path and the replay
        # tiles of 22 (lthash), 23, 24 and 25
        follower = follower_path[name] + tile_launches.get(name, 0)
        kernels.append({"name": name, "route": "cuda",
                        "source": f"firedancer_tpu_torch/csrc/{src}",
                        "replaces": rep,
                        "launches": sum(p[name] for p in hash_paths)
                        + follower,
                        "max_abs_err": max(hash_errs[name],
                                           follower_errs.get(name, 0)),
                        "ms": st["ms"],
                        "plain_ms": st["plain_ms"],
                        "bound_ms": st["bound_ms"],
                        "bound_by": st["bound_by"], "library_ms": None})
        if name in ("sha256", "poh_verify"):
            # bound_ms is the operations bound; one warp's SASS stream
            # issued at one instruction a cycle is the floor of this
            # design (issue_floor)
            kernels[-1].update(issue_floor_ms=st["issue_floor_ms"])
        if name == "poh_verify":
            # an entry's chain of dependent rounds at 3 cycles a round
            kernels[-1].update(chain_rounds=st["chain_rounds"],
                               chain_ms=st["chain_ms"])
        if name in follower_timed:
            # at the replay's own shapes (17a's launches: the median and
            # the largest), CUDA graph
            kernels[-1].update(replay_launches=follower, replay_ms=[
                {k: t[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "bound_by")}
                for t in follower_timed[name]])
        if name in ("blake3", "lthash"):
            # ms is the CUDA graph's at 0-2048 bytes, beside the longest
            # message's chain at a compression's dependent latency; the
            # same at the bank hash's 81 bytes beside its own bound
            kernels[-1].update({k: st[k] for k in (
                "call_ms", "chain_floor_ms", "bank_hash_ms",
                "bank_hash_call_ms", "bank_hash_bound_ms",
                "bank_hash_bound_by")})
        if name == "lthash":
            # phase 22's folds of a whole store: 22a's archive (where
            # zstandard imports) and 22c's restore gate, CUDA events
            kernels[-1].update(cold_launches=cold_launches["lthash"],
                               restore_ms=[
                {"shape": f"{f['lanes']} x {f['width']} B", **{
                    k: f[k] for k in ("launches", "ms", "fold_ms",
                                      "plain_ms", "plain_lanes", "bound_ms",
                                      "bound_by", "max_abs_err")}}
                for f in (rec22["22a"].get("fold"), rec22["22c"]["fold"])
                if f])
            kernels[-1]["max_abs_err"] = max(
                [kernels[-1]["max_abs_err"]]
                + [f["max_abs_err"] for f in kernels[-1]["restore_ms"]])
            # phase 23c: a vote-heavy slot's delta, CUDA graph
            kernels[-1]["vote_delta_ms"] = rec23["23c"]["lthash_vote_delta"]
        if name in general_launches:
            kernels[-1]["general_launches"] = general_launches[name]
        if name in ("poh_verify", "lthash"):
            # phase 24's non-leader replay tile
            kernels[-1]["nonleader_launches"] = rec24[
                "poh_launches" if name == "poh_verify" else
                "lthash_launches"]
    # the verify tiles of the topology phases launch in their own
    # processes: their batches a phase (each strict batch one sha512_ram
    # and one ed25519_verify launch, each RLC batch one of each stage),
    # and the launches phase 21's capture recorded by each __global__
    strict_b = {"10c": rec10c["verify_batches"],
                "12": sum(rec["verify_batches"].values()),
                "19c": rec19["flood"]["verify"]["batches"],
                "21": rec21["verify_batches"],
                "23a": sum(rec23["23a"]["verify_batches"].values()),
                "24": sum(rec24["verify_batches"].values()),
                "25": sum(rec25["verify_batches"].values())}
    rlc_b = {"19c": rec19["flood"]["verify"]["rlc_batches"]}
    glob = {"sha512": "sha512_kernel", "sha512_ram": "sha512_kernel",
            "ed25519_verify": "ed25519_verify_kernel",
            "msm_stage1": "msm_stage1_kernel",
            "msm_stage2": "msm_stage2_kernel",
            "wave_scan": "wave_scan_kernel", "sha256": "sha256_kernel",
            "poh_verify": "poh_verify_kernel", "blake3": "b3_kernel",
            "lthash": "b3_kernel"}
    for k in kernels:
        if k["name"] in ("sha512", "sha512_ram", "ed25519_verify"):
            k["tile_batches"] = strict_b
        elif k["name"] in ("msm_stage1", "msm_stage2"):
            k["tile_batches"] = rlc_b
        k["capture_launches_21"] = rec21["kernels"].get(
            glob[k["name"]], {}).get("launches", 0)
        # phase 25's launches on each node (the leader's verify batches,
        # one launch of each strict kernel a batch)
        mine = {node: rec25["launches"][node][k["name"]]
                for node in ("leader", "follower")
                if k["name"] in rec25["launches"][node]}
        if mine:
            k["follower_launches"] = mine
    log(smi)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - T_START:.1f} s {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
