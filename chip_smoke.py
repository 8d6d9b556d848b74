#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wavenet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper,
sm_90a) and nvcc.  It builds the port's kernels from the checkout's
sources, checks each against its plain PyTorch version on the card at a
preset's full widths, then drives the port's main paths through the normal
entry points (export_npz -> WaveNet.from_npz -> WaveNetServer -> HTTP on
localhost; the train CLI's main(); WaveNet.from_checkpoint) and shows that
they went through the kernels: the wide presets `full` and `full_vocoder`
(phases 2-9), the narrow presets `fastgen_bench` and `conditional` through
the narrow decode kernel (phases 10-12), speaker-conditioned models
through both decode kernels' speaker variants (phase 13), and a
speaker-conditioned `full` trained through the train_stack kernels'
speaker variants (phase 14), then the port's verify tool with its probe
kernels (phase 15), and the entry points a user calls at `full`: the
train CLI sampling and tracing as it trains, the generate and score CLIs
(phase 16), and the data pipeline (the native window gatherer, the
streaming dataset) and data-parallel training at `full` under torchrun
(phase 17), and generation and serving over the mesh under torchrun: the
decode kernels fanned out over the data axis, the collective loop over
the model axis (phase 18), and training at `full` over the mesh's seq
axis (overlap-discard) and model axis (the layer pipeline) on the stack
kernels (phase 19), and deployment artifacts (serving/aot.py) exported
through the generate CLI's --export-aot, loaded in fresh processes and
timed from a cold start (phase 20), and the widths the stack kernels
take through row-tiled layer blocks and padded operands (phase 21), and
the config's dtype fields: bf16 leaves through the kernels, a float16
model on the plain route (phase 22).
Any failed check
raises and the exit code is non-zero; without a CUDA device it exits 2 and
prints no result.  The last three lines of stdout are the kernel table
(JSON), the card's name and power limit, and the device summary (JSON).

Phases (one line of numbers each):
  0. device (nvidia-smi name, power limit) and kernel build time (one nvcc
     per source, all started together);
  1. RNG: the device counter-hash bits equal the plain version's exactly;
  2. wide decode kernel vs plain at full widths, B=4, 512 steps, T=0 and
     T=1: 0 teacher-forced flips, free-running tokens, rings and carry
     equal, chunked == one-shot bit for bit, kernel and plain time per
     step; the cluster plan chosen (ops/cuda/decode_wide.plan_clusters),
     the clusters of its shape the card holds at once, and the kernel's
     time at 8 and 16 CTAs per cluster with one row per cluster and all
     four rows in one, by either exchange (all-reduce, scatter; each equal
     to the default); at B = 8, 9, 12, 16 (64 steps) the default plan and
     one row per cluster, each equal to plain, and their times;
  3. served slice: 4 concurrent 0.25 s requests (one streamed) plus one
     primed request over HTTP; valid 16-bit PCM of the asked length; a
     replayed seed gives bit-identical audio; the served audio's first
     samples equal the plain version's; only the wide kernel's count grew;
  4. train_stack kernels vs plain at `full` widths and depth, T=8192
     (5 layer groups), at B=2 and at the training shape B=8: embedded
     tokens in, a fixed random cotangent ct on the skip sum, loss
     mean(skip * ct); skip max|d|/max|skip| <= 1e-2, loss |d| <= 2e-3 of
     mean(|skip * ct|) (the loss itself is a cancelling sum near zero),
     every gradient max|d|/max|g| <= 2e-2 (the reference suite's bands),
     two kernel runs bit-identical; kernel and plain ms of the whole
     stack's forward and backward at both shapes (the table reports B=8),
     and the forward's and the backward's device ms by kernel name at
     B=8 (utils/profiling.kernel_split, torch.profiler); then the
     backward's bias-gradient column sums alone, a train step's worth at
     `full`'s and `fastgen_bench`'s shapes: colsum_kernel's device ms
     beside the byte floor;
  5. trained and served: python -m wavenet_tpu_torch.train's main() on
     `full` (synthetic data, B=8, window 8192) for 6 steps with a
     checkpoint at step 3; the counters are read right after that run
     (the train_stack kernels, checked against the count the layer groups
     give; no other kernel); a resume from step 3 whose losses at steps
     4-6 and final params equal the uninterrupted run's bit for bit;
     WaveNet.from_checkpoint then decodes 0.05 s through the decode
     kernel, whose counter grows too;
  6. the wide decode kernel's mel variant vs plain at `full_vocoder`
     widths (M = 80), B=4, 512 steps, T=0 and T=1, y upsampled from random
     mel frames: the checks of phase 2, with y sliced per chunk;
  7. served vocoder: over HTTP, three concurrent mel requests of two
     lengths (one streamed), which must share a batch, and one primed mel
     request; valid PCM of the asked length; a batched request replayed
     alone gives the same audio bit for bit; the first samples equal the
     plain version's on the same upsampled features; only the mel
     variant's counter grew; then one request without mel, which the
     server decodes with no conditioning term (as the reference's does):
     only the unconditional variant's counter grows, and its audio equals
     the kernel's and the plain version's unconditional decode on the
     same weights (also in phase 12, through the narrow kernel);
  8. the train_stack kernels' mel variants vs plain at `full_vocoder`
     widths and depth, T=8192 (6 layer groups), B=2 and B=8, y upsampled
     from random frames: the bands of phase 4, dv_cond and dy included;
  9. train.main on `full_vocoder` (synthetic clips and their log-mel
     frames, B=8, window 8192) for 6 steps with a checkpoint at step 3,
     the counters read right after that run; a resume from step 3 bit
     for bit (losses, params, upsampler included);
     WaveNet.from_checkpoint(...).vocode() of 0.05 s of a synthetic clip
     through the decode kernel's mel variant;
 10. the narrow decode kernel vs plain at `fastgen_bench` widths (R = 64,
     S = 128, 20 layers), B=64, 512 steps, T=0 and T=1: 0 teacher-forced
     flips, free-running tokens, rings and carry equal, chunked ==
     one-shot; kernel and plain ms per step; the tile policy: the kernel
     at 1, 2, 4, 8 and 16 rows per block (each equal to the default); the
     same checks at B=65 (a ragged last tile), and at B=65 on a config
     whose 4 layers all have d = 1 (each ring slot is read the step after
     its write, where the kernel's staging meets the rings);
 11. served `fastgen_bench` (24 kHz): 16 concurrent 0.25 s requests (one
     streamed), which must share one batch, plus one primed request over
     HTTP; the checks of phase 3; only the narrow kernel's count grew;
 12. `conditional` (R = 64, mel): the narrow kernel's mel variant vs plain
     at B=4, 512 steps (the checks of phase 10); the served vocoder checks
     of phase 7 through the narrow kernel; train.main on `conditional`
     (B=8, window 8192) 6 steps + bit-exact resume through the train_stack
     kernels' mel variants, and vocode() of the checkpoint through the
     narrow kernel's mel variant;
 13. speakers (global_classes = 109, VCTK's count, global_channels 16):
     the narrow kernel's speaker variant vs plain at `fastgen_bench` widths,
     B=8, 256 steps, and the wide kernel's at `full` widths, B=4, 256 steps
     (the checks of phase 10); each model served over HTTP: four 0.1 s
     requests of four speakers (two share a seed) in one batch, each equal
     to its singleton replay, all distinct; only that kernel's speaker
     count grew;
 14. speaker training (`full` with 109 speakers): the train_stack kernels'
     speaker variants vs plain over the whole stack at T=8192 (5 layer
     groups) at B=2 and B=8 with speaker ids that repeat within the batch,
     the bands of phase 4 with dg (the offsets' cotangent) held too,
     kernel and plain ms at B=8, and the kernels' ms without and with
     the offsets in turns on the same inputs; the mel + speaker variants at
     `full_vocoder` with 109 speakers, B=2 (6 groups); then train.main on
     `full` with --override global_classes=109 (synthetic clips, B=8,
     window 8192) for 6 steps with a checkpoint at step 3, the speaker
     counters equal to their formula and no other count grown, a resume
     bit for bit (losses, params, g_embed and v_global included), and
     WaveNet.from_checkpoint(...).generate(speaker=[3, 50]) through the
     wide decode kernel's speaker variant;
 15. the verify tool, `python -m wavenet_tpu_torch.verify` in a subprocess
     (each check family in its own process, the counts set to 0 at each
     family's start and summed at its end): its lines are printed, exit 1
     fails the run, exit 2 (train_stack drift only) is printed and
     counted; every decode comparison must be BIT-EXACT and every probe
     kernel must have launched on that path; then the four probe kernels
     (csrc/probes.cu) against their plain versions here, each timed with
     its plain version and its bound; P2 and torch.tanh in turns, 25
     rounds: their medians and ranges;
 16. the entry points at `full`: train.main (synthetic data, B=8, window
     8192, EMA 0.999) for 16 steps with a checkpoint every 4 steps,
     --sample-every 8 --sample-seconds 0.25 and --profile-dir: its losses,
     final params and EMA equal to the same run without sampling and
     tracing bit for bit, the stack kernels' counts equal to their
     formula, the wide decode kernel launched once a sample and no other
     decode kernel, two samples of 4,000 samples, the stack kernels in
     the trace of steps 10-15, the three kept checkpoints in place when
     main() returns; the ms per step with no fetch and no save, with the
     metrics fetched every step, and with a save every step, blocking and
     asynchronous (utils/profiling.host_costs); then the generate CLI
     (0.5 s, batch 4, seed 7) through the wide kernel only, its four wavs
     equal to the facade's generate_wav bit for bit, --stream 0.1 equal
     to them, --no-ema different; and the score CLI over the four wavs at
     --chunk 4096, each within 1e-4 bits per sample of one pass;
 17. the data pipeline and data parallelism: a synthetic 8-clip 16 kHz
     corpus written to disk; at B=8, T=8192 the native gatherer's batches
     equal the NumPy loop's, and the streaming dataset's (plain,
     prefetched, and each of two ranks' rows=) equal AudioDataset's global
     batch and its slices, bit for bit; host ms per batch of each (the
     prefetched one with its queue full); then `python -m
     torch.distributed.run --standalone --nproc_per_node 2 -m
     wavenet_tpu_torch.train --preset full --synthetic --override
     data_parallel=2 --dist-backend gloo --device cuda:0` (both ranks on
     the one card; B=8 global, window 8192, EMA) for 6 steps with a
     checkpoint at step 3: the step-1 loss within DP_STEP1_RTOL and steps
     2-6 within DP_LOSS_RTOL of phase 5's single process; the replicas'
     params checked equal by the trainer at each of its 3 saves; a resume
     from step 3 under DP=2 equal to the uninterrupted run bit for bit
     (losses 4-6, params, EMA); only rank 0 wrote in the run's directory;
     each rank's stack launches equal to the single-process formula and
     no decode kernel launched (a probe loaded into each rank records
     its writes, launches, peak memory and all-reduce times); the first
     step's gradients reduced over two ranks against one process's, each
     leaf's max|d|/max|g| within 1e-4 (2^-7 for a leaf whose cotangent
     the recipe rounds to bf16 after the sum over rows: the head's);
     `data_parallel=1` under torchrun over nccl for 2 steps equal to the
     same steps without torch.distributed, bit for bit; DP=2's ms per
     step and each rank's all-reduce ms per step, as two ranks sharing
     one card (not a scaling figure).
 18. generation and serving over the mesh, two gloo ranks sharing cuda:0
     under torchrun (correctness and launches, not scaling): (a) the
     generate CLI at `full`, B = 8, 0.5 s, --data-parallel 2: its wavs
     equal the single-process CLI's bit for bit, each rank took the
     decode_wide route and launched it once (no other kernel); each
     rank's ms per step; (b) the generate CLI at `full`, B = 4, 0.025 s,
     --model-parallel 2: its wavs equal the single-process kernel
     decode's, no kernel launched (the collective loop is plain PyTorch
     with one f64 all-reduce a layer), each rank's ms per step and
     collective ms per step (the device synchronised around each call);
     then distdecode.generate_sharded(shard_rings_model=True) in two
     spawned ranks: the kernel decode's first 160 tokens, its times;
     (c) the serve CLI under torchrun, --data-parallel 2 (rank 0 HTTP, rank
     1 following): `full` with four requests of mixed lengths on the
     batchable lane beside a primed one on the conditioned lane, then
     `full_vocoder` with three mel requests (one primed), every response
     equal to its single-process replay, only decode_wide's (mel) count
     grown on each rank, the served realtime factor over these requests;
     interrupting rank 0 ends both ranks with exit 0; (d) the kernel
     fan-out at `fastgen_bench`, B = 64 (32 a rank) through the narrow
     kernel: one launch a rank, tokens equal to one process's, ms per
     step.
 19. training over the seq and model axes, two gloo ranks sharing cuda:0
     under torchrun (correctness, launches and gloo's cost, not scaling):
     train.main at `full`, B = 8, T = 8192, 3 steps, (a) with
     --override seq_parallel=2 (overlap-discard: each rank runs the stack
     kernels on its 4,096 rows after 4,096 rows of halo) and (b) with
     --override model_parallel=2 --override pipeline_microbatch=2 (the
     layer pipeline: 20 layers a stage, 4 microbatches); for each, the
     step-1 loss within 2e-3 of phase 5's single process, the first
     step's gradients (reduced over the ranks, gathered whole) within
     2e-2 of each leaf's largest element against one process's, each
     rank's stack launches equal to the route's formula and no other
     kernel, ms per step, collective ms per step (the device synchronised
     around each exchange) and peak memory per rank (a probe in each
     rank records them); the run's final checkpoint (gathered whole
     before rank 0 writes) loads in this process through
     WaveNet.from_checkpoint and decodes 800 samples there.
 20. deployment artifacts (serving/aot.py): (a) `full`, 1 s, B = 4,
     through the generate CLI's --export-aot from a checkpoint of the
     seeded random weights, (b) `fastgen_bench` B = 64 (the narrow
     kernel), (c) `full_vocoder` B = 4 with a static 63-frame mel, (d)
     `full` + 109 speakers B = 4, each exported (no kernel launched) and
     loaded with load_decoder(device="cuda") in one fresh process that
     never imports models/api.py: tokens equal to the facade's generate
     at the same seed bit for bit, one launch of the variant's counter per
     call, ms per step beside the facade's (each the second of two
     calls); (e) a 64-sample B = 1 export decoded on the CPU (the program
     moved off the card) equal to the card's; (f) cold start, seconds
     from a fresh process to the first tokens through load_decoder and
     through WaveNet.from_checkpoint + generate (build cache warm), and
     through load_decoder of (e)'s artifact with --compile-cache at an
     empty directory (the decode_wide build included; this process runs
     beside the rest of the phase), each split into start, imports and
     CUDA context, load, first call.
 21. widths the stack kernels refused before their layer blocks were
     row-tiled and their operands padded: `full`'s first layer group at
     B=8 through 64-, 32- and 16-row blocks, equal bit for bit, each
     tile's ms; phase 4's checks and times (B=2 and 8, T=8192) at `full`
     with R = 256 (40 groups; 32-row backward blocks), `full` with
     S = 1,024 (14 groups; 32 rows), `tiny` with 80 mels (nm > 2R) and
     `full` with R = 30, S = 18 and 109 speakers (run at 32 and 20), with
     the row tiles each launched; then train.main on `full` with R = 256
     (B=8, window 8192) 3 steps with a checkpoint at step 2, the counts
     and row tiles checked, a resume from step 2 bit for bit, a decode of
     the checkpoint, and the wide decode kernel vs plain on its weights,
     B=4, 256 steps (the checks of phase 2);
 22. the config's dtype fields: (a) `full` with param_dtype bfloat16, the
     stack kernels vs plain on the bf16 leaves at B=2, T=8192 (phase 4's
     checks) and through autograd (weight gradients bf16, within the
     gradient band of plain, two runs bit-identical), train.main 6 steps
     with a bit-exact resume from step 3 and every checkpoint leaf bf16,
     its ms per step and peak memory beside phase 5's, and its checkpoint
     decoded by the wide kernel == plain (B=4, 256 steps), and the save
     costs of phase 16 on bf16 leaves; (b) `fastgen_bench` with bf16
     leaves, the narrow kernel == plain at B=64, 256 steps, and
     WaveNet.generate's launches of it; (c) `full` with compute_dtype
     float16 on the plain route:
     train.main 3 steps (cut to B=2, window 8192) with a bit-exact resume
     from step 2, then 64 decode steps at B=4 from its checkpoint, fast ==
     naive, no kernel launched in either; train and decode ms per step.
The phases that drive a main path (3, 5, 7, 9, 11, 12, 13, 14, 15, 16, 20,
21, 22)
set every kernel's count to 0 right before and read them right after;
phases 17, 18 and 19's rank processes start theirs at 0 and report them at
exit (or set them to 0 before the path they time).
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

B, STEPS = 4, 512                # phase 2 shape
# phase 2: (CTAs, rows) per cluster, scatter exchange (else all-reduce)
PLANS = tuple((C, rows, scatter) for C in (16, 8) for rows in (1, 4)
              for scatter in (False, True))
PLAN_BATCHES, PLAN_STEPS = (8, 9, 12, 16), 64   # phase 2: rows by batch
SERVE_SECONDS, PRIME_SECONDS = 0.25, 0.05
REF_SAMPLES = 128                # served audio checked against plain
VOC_SECONDS = (0.25, 0.2)        # phase 7 request lengths (one bucket)
TS_B, TS_T, TS_TRAIN_B = 2, 8192, 8   # phase 4 shapes
SKIP_TOL, LOSS_TOL, GRAD_TOL = 1e-2, 2e-3, 2e-2
TRAIN_STEPS, RESUME_AT, DECODE_SECONDS = 6, 3, 0.05
NARROW_B, TILES = 64, (1, 2, 4, 8, 16)   # phase 10 batch, rows per block
HAZARD_B, HAZARD_STEPS = 65, 256          # phase 10: ragged tile, d = 1
SPEAKERS, SPK_STEPS, SPK_SECONDS = 109, 256, 0.1   # phase 13
GATE_ROUNDS = 25                 # phase 15: P2 and torch.tanh in turns
# phase 16: train.main steps, checkpoint and sample intervals, sample length
ENTRY_STEPS, ENTRY_CKPT_EVERY, SAMPLE_EVERY, SAMPLE_SECONDS = 16, 4, 8, 0.25
SAVE_COST_STEPS = 4              # phase 16: steps a save mode is timed over
GEN_SECONDS, GEN_BATCH, GEN_SEED, GEN_STREAM = 0.5, 4, 7, 0.1
SCORE_CHUNK, SCORE_TOL = 4096, 1e-4
# phase 17: the corpus, the states checked and the batches timed; two
# ranks on one card; the bands of DP=2 against one process (the step-1 loss,
# the losses of steps 2-6, each first-step gradient leaf, and a leaf whose
# cotangent the recipe rounds to bf16 after the sum over rows; measured on
# an H100 at `full`: 0, 3.5e-5, 4.6e-7 and 3.5e-3); nccl steps
DATA_CLIPS, DATA_CLIP_SECONDS, DATA_STATES, DATA_TIMED = 8, 4.0, 4, 20
DP_RANKS, DP_TIMEOUT_S, NCCL_STEPS = 2, 300, 2
DP_STEP1_RTOL, DP_LOSS_RTOL = 1e-5, 1e-3
DP_GRAD_TOL, DP_BF16_GRAD_TOL = 1e-4, 2 ** -7
# phase 18: two ranks on one card; (a) DP=2 generate, (b) MP=2 generate,
# (c) the served requests' lengths, (d) DP=2 at fastgen_bench
MESH_RANKS, MESH_TIMEOUT_S = 2, 300
MESH_DP_BATCH, MESH_DP_SECONDS = 8, 0.5
MESH_MP_BATCH, MESH_MP_SECONDS = 4, 0.025
MESH_SRM_SAMPLES = 160           # (b) through the library: a prefix
MESH_SERVE_SECONDS = (0.25, 0.1, 0.2, 0.15)
# phase 19: train.main steps over the seq and model axes (two ranks on one
# card); the pipeline's rows per microbatch; the bands against one process
# (the stack's: the loss within 2e-3 of its value, a sum of positive terms
# whose mean |term| it is; each gradient leaf within 2e-2 of its largest
# element)
SEQMODEL_STEPS, SEQMODEL_MICROBATCH, SEQMODEL_DECODE = 3, 2, 800
SEQMODEL_LOSS_TOL, SEQMODEL_GRAD_TOL = 2e-3, 2e-2
MESH_FAST_BATCH, MESH_FAST_SECONDS = 64, 0.25
# phase 20: artifact length, seed, the CPU load's length, a worker's limit
AOT_SECONDS, AOT_SEED, AOT_CPU_SAMPLES, AOT_TIMEOUT_S = 1.0, 17, 64, 300
# phase 21: train steps of `full` at R = 256, the step resumed from, and
# the decode steps of its checkpoint held against plain
WIDTH_STEPS, WIDTH_RESUME_AT, WIDTH_DECODE_STEPS = 3, 2, 256
# phase 22: the dtype fields; the narrow kernel's steps on bf16 leaves,
# the float16 model's train steps (resumed from DTYPE_RESUME_AT), batch and
# decode steps at DTYPE_DECODE_B rows
DTYPE_NARROW_STEPS, DTYPE_STEPS, DTYPE_RESUME_AT = 256, 3, 2
DTYPE_TRAIN_B, DTYPE_DECODE_STEPS, DTYPE_DECODE_B = 2, 64, 4
ROOT = os.path.dirname(os.path.abspath(__file__))
# published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12

COUNTERS = {}                    # every kernel wrapper's launch count


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, repeats: int = 1) -> float:
    """Milliseconds of device time for fn() (median of `repeats`)."""
    import torch
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def device_ms(fn, n: int = 20) -> float:
    """Milliseconds of device time per fn() for work far shorter than the
    host's launch path (the probes): the stream is held busy (~50 ms)
    while n calls are queued behind the first event, so the events time
    the kernels back to back and not the host enqueueing them."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    fn()                                         # warm up (allocations)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def alone_ms(fn, n: int = 20) -> float:
    """Median milliseconds of device time of one fn() with no other call's
    launches beside it, as the verify tool makes its probe calls (each
    followed by a host copy): each call sits between its own two events
    behind a short sleep, so neither the host's enqueueing nor an overlap
    with the call before it is in the reading."""
    import torch
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    fn()                                         # warm up (allocations)
    torch.cuda.synchronize()
    for e0, e1 in events:
        torch.cuda._sleep(1_000_000)
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sorted(e0.elapsed_time(e1) for e0, e1 in events)[n // 2]


def register_counters(*modules) -> None:
    """COUNTERS["<module>.<name>"]: every LaunchCounter of the modules."""
    from wavenet_tpu_torch.ops.cuda.build import LaunchCounter
    for mod in modules:
        short = mod.__name__.rsplit(".", 1)[-1]
        for k, v in vars(mod).items():
            if isinstance(v, LaunchCounter):
                COUNTERS[f"{short}.{k}"] = v


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def check_only(grown, what: str) -> dict:
    """After a main path's run: every named count grew and no other did.
    Returns the counts."""
    got = {k: c.value for k, c in COUNTERS.items()}
    check(all(got[k] > 0 for k in grown),
          f"{what}: {grown} did not launch ({got})")
    check(not any(v for k, v in got.items() if k not in grown),
          f"{what}: other kernels launched ({got})")
    return got


def counter_name(mod, cfg) -> str:
    """The count a decode launch of cfg bumps in mod (decode or
    decode_wide): its speaker, mel or unconditional variant's."""
    short = mod.__name__.rsplit(".", 1)[-1]
    var = ("gc_launches" if cfg.global_classes is not None else
           "mel_launches" if cfg.mel is not None else "launches")
    return f"{short}.{var}"


def phase_rng(pwide, rng, dev) -> None:
    import torch
    seeds = rng.derive_row_seeds(2024, 8).to(dev)
    for t in (0, 1, 4093):
        got = pwide.counter_bits(seeds, t, 256).cpu()
        want = pwide.counter_bits(seeds.cpu(), t, 256)
        check(torch.equal(got, want), f"device RNG bits differ at step {t}")
    print("phase 1 rng: [8, 256] hash bits equal at steps 0, 1, 4093",
          flush=True)


def phase_kernel(mod, cfg, w, dev, card: str, phase: int, batch: int = B,
                 steps: int = STEPS, y=None, speaker=None, tiles=(),
                 plans=()) -> dict:
    """A decode kernel (mod: ops/cuda/decode or decode_wide) vs its plain
    version at cfg's widths, with the upsampled mel features y
    [batch, steps, M] of a mel model and the speaker ids of a speaker
    model: the kernel must equal the plain version bit for bit (0 flips,
    rings and carry equal).  tiles: rows per block to time (the narrow
    kernel); plans: (CTAs, rows, scatter) per cluster to time (the wide
    kernel).
    Returns the table's numbers."""
    import torch
    worst_err, ms, plain_ms, tile_ms, plan_ms = 0.0, None, None, {}, {}
    ys = (lambda t0, n: None) if y is None else \
        (lambda t0, n: y[:, t0:t0 + n])
    for temp in (0.0, 1.0):
        rings, carry, seeds, g, _, _ = mod.setup_decode(
            cfg, batch, steps, seeds=[11 * (i + 1) for i in range(batch)],
            device=dev, w=w, speaker=speaker)
        out = {}

        def plain():
            out["p"] = mod.decode_chunk_reference(
                w, cfg, rings, carry, 0, seeds, steps, temp, y=y, g=g)
        t_plain = cuda_ms(plain) / steps
        rt, rr, rc = out["p"]

        def run(**kw):
            return mod.decode_chunk(w, cfg, rings, carry, 0, seeds, steps,
                                    temp, y=y, g=g, **kw)
        kt, kr, kc = run()
        diverge = (kt != rt).any(0).nonzero()
        first_div = int(diverge[0]) if len(diverge) else None
        forced = torch.cat([carry[:, :1], rt], 1).contiguous()
        ft, fr, fc = run(forced=forced)
        flips = int((ft != rt).sum())
        err = float((fr.float() - rr.float()).abs().max())
        worst_err = max(worst_err, err)
        check(flips == 0, f"T={temp}: {flips} teacher-forced flips")
        check(torch.equal(fr, rr) and torch.equal(fc, rc),
              f"T={temp}: teacher-forced rings or carry differ")
        check(first_div is None and torch.equal(kr, rr)
              and torch.equal(kc, rc), f"T={temp}: kernel != plain")

        # chunked (3 uneven launches) == one-shot, bit for bit
        r, c, toks, t0 = rings, carry, [], 0
        for n in (steps // 5, steps * 3 // 5,
                  steps - steps // 5 - steps * 3 // 5):
            tk, r, c = mod.decode_chunk(w, cfg, r, c, t0, seeds, n, temp,
                                        y=ys(t0, n), g=g)
            toks.append(tk)
            t0 += n
        check(torch.equal(torch.cat(toks, 1), kt) and torch.equal(r, kr)
              and torch.equal(c, kc), f"T={temp}: chunked != one-shot")

        t_kernel = cuda_ms(run, repeats=3) / steps
        if temp > 0:
            ms, plain_ms = t_kernel, t_plain
            for bt in tiles:          # the tile policy, at the same inputs
                check(all(torch.equal(a, b) for a, b in zip(
                    run(rows_per_block=bt), (kt, kr, kc))),
                    f"{bt} rows per block changed a row")
                tile_ms[bt] = cuda_ms(lambda: run(rows_per_block=bt),
                                      repeats=3) / steps
            for C, rows, scatter in plans:   # the same inputs
                kw = {"cluster": C, "rows_per_cluster": rows,
                      "scatter": scatter}
                check(all(torch.equal(a, b) for a, b in zip(
                    run(**kw), (kt, kr, kc))),
                    f"{C} CTAs x {rows} rows per cluster, scatter="
                    f"{scatter} changed a row")
                plan_ms[(C, rows, scatter)] = cuda_ms(
                    lambda: run(**kw), repeats=3) / steps
        print(f"phase {phase} kernel {mod.__name__.rsplit('.', 1)[-1]} "
              f"T={temp}: B={batch} steps={steps} teacher_forced_flips="
              f"{flips} first_free_divergence={first_div} "
              f"rings_max_abs_err={err} chunked_equal=True "
              f"kernel_ms_per_step={t_kernel} plain_ms_per_step={t_plain} "
              f"card={card!r}", flush=True)
    if tiles:
        print(f"phase {phase} tile policy: B={batch} kernel_ms_per_step by "
              f"rows per block {tile_ms} card={card!r}", flush=True)
    if plans:
        plan = mod.plan_clusters(batch, cfg,
                                 lambda p: mod.max_clusters(cfg, p))
        print(f"phase {phase} cluster plan: B={batch} chosen={plan} "
              f"clusters_held_at_once={mod.max_clusters(cfg, plan)} "
              f"kernel_ms_per_step by (CTAs, rows, scatter) per cluster "
              f"{plan_ms} card={card!r}", flush=True)
        phase_batch_plans(mod, cfg, w, dev, card, phase)
    return {"max_abs_err": worst_err, "ms": ms, "plain_ms": plain_ms,
            **decode_bound(cfg, w, batch, steps, g)}


def phase_batch_plans(mod, cfg, w, dev, card: str, phase: int) -> None:
    """The wide kernel's rows per cluster as the batch grows: at each of
    PLAN_BATCHES, the default plan and one row per cluster, each equal to
    plain (sampled, PLAN_STEPS steps), and their ms per step."""
    import torch
    held = lambda p: mod.max_clusters(cfg, p)
    out = {}
    for batch in PLAN_BATCHES:
        rings, carry, seeds, _, _, _ = mod.setup_decode(
            cfg, batch, PLAN_STEPS, seeds=[5 * i + 2 for i in range(batch)],
            device=dev, w=w)
        want = mod.decode_chunk_reference(w, cfg, rings, carry, 0, seeds,
                                          PLAN_STEPS, 1.0)
        plan = mod.plan_clusters(batch, cfg, held)
        row: dict = {"chosen": tuple(plan)}
        for rows in sorted({plan.rows, 1}):
            def run():
                return mod.decode_chunk(w, cfg, rings, carry, 0, seeds,
                                        PLAN_STEPS, 1.0, cluster=plan.cluster,
                                        rows_per_cluster=rows)
            check(all(torch.equal(a, b) for a, b in zip(run(), want)),
                  f"B={batch}, {rows} rows per cluster != plain")
            row[rows] = cuda_ms(run, repeats=3) / PLAN_STEPS
        out[batch] = row
    print(f"phase {phase} rows by batch: {PLAN_STEPS} steps, equal to plain, "
          f"kernel_ms_per_step by rows per cluster {out} card={card!r}",
          flush=True)


def decode_bound(cfg, w, batch: int, steps: int, g) -> dict:
    """Least time per decode step of a launch of `batch` rows and `steps`
    steps: its MACs (per row-step: L layers of 4R^2 + R(R+S), with mel 2RM
    more, plus the S^2 + SQ head) at the bf16 peak, or its bytes (the
    weights the kernel reads once, rings in and out, y in as bf16, the
    speaker offsets g in as f32, tokens out) at the memory rate, whichever
    is larger."""
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    flops = (2 * (L * (4 * R * R + R * (R + S) + 2 * R * M) + S * S + S * Q)
             * batch * steps)
    rings = sum(cfg.dilations) * batch * R * 2
    weights = sum(v.numel() * v.element_size() for k, v in w.items()
                  if k not in ("g_embed", "v_global"))
    nbytes = (weights + 2 * rings + batch * steps * (4 + 2 * M)
              + (0 if g is None else g.numel() * 4))
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3 / steps,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, dict(r.headers), r.read()


def _wav_samples(data: bytes, rate: int):
    import numpy as np
    with wave.open(io.BytesIO(data)) as w:
        check(w.getnchannels() == 1 and w.getsampwidth() == 2
              and w.getframerate() == rate, "not 16-bit mono PCM WAV")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _served_model(cfg, dev):
    """cfg with seeded random weights, through export_npz and from_npz."""
    import torch
    from wavenet_tpu_torch.models.api import WaveNet
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        WaveNet(cfg).init(torch.Generator().manual_seed(0),
                          device=dev).export_npz(path)
        return WaveNet.from_npz(path, device=dev)


def _concurrently(url: str, bodies) -> list:
    """POST every body at once, each on its own thread; the replies."""
    replies = [None] * len(bodies)

    def call(i):
        replies[i] = _post(url + "/synthesize", bodies[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        check(not t.is_alive(), "a request did not finish")
    return replies


def _pcm(bodies, lengths, replies, rate: int) -> list:
    """The replies' samples, checked: HTTP 200, 16-bit PCM (a streamed
    reply with its headers) of the asked length."""
    import numpy as np
    pcm = []
    for body, n, (status, headers, data) in zip(bodies, lengths, replies):
        check(status == 200, f"HTTP {status}")
        if body.get("stream"):
            check(headers.get("Content-Type") == "audio/L16"
                  and int(headers["X-Num-Samples"]) == n,
                  "bad stream headers")
            got = np.frombuffer(data, "<i2")
        else:
            got = _wav_samples(data, rate)
        check(got.shape == (n,), f"got {got.shape[0]} samples, asked {n}")
        pcm.append(got)
    return pcm


def _plain_pcm(mod, model, cfg, seed: int, dev, y=None, speaker=None):
    """The first REF_SAMPLES samples of a request as 16-bit PCM, decoded
    by the plain version."""
    import numpy as np
    from wavenet_tpu_torch.audio import mulaw
    w = model.decode_weights()
    rings, carry, s, g, _, _ = mod.setup_decode(
        cfg, 1, REF_SAMPLES, seeds=[seed], device=dev, w=w,
        speaker=None if speaker is None else [speaker])
    ref, _, _ = mod.decode_chunk_reference(
        w, cfg, rings, carry, 0, s, REF_SAMPLES, 1.0,
        y=None if y is None else y[:, :REF_SAMPLES], g=g)
    return (np.clip(mulaw.decode(ref[0]).cpu().numpy(), -1, 1)
            * 32767.0).astype("<i2")


def phase_serve(mod, cfg, dev, card: str, phase: int = 3,
                seconds: float = SERVE_SECONDS, seeds=(101, 202, 303, 404),
                speakers=None, primed: bool = True,
                one_batch: bool = False) -> int:
    """Serve cfg through the normal entry points; returns the launch count
    of mod's decode variant (unconditional, or speaker with `speakers`, one
    id per request) over the served requests.  Request 3 streams; with
    `primed` one primed request follows; one_batch: the requests of
    `seeds` must share one batch, and each is replayed alone (else the
    second)."""
    import numpy as np
    from wavenet_tpu_torch.serving import WaveNetServer
    from wavenet_tpu_torch.serving.http import make_server

    rate = cfg.sample_rate
    n = int(seconds * rate)
    model = _served_model(cfg, dev)
    engine = WaveNetServer(model, max_batch=len(seeds),
                           max_wait_ms=2000.0 if one_batch else 200.0,
                           chunk_seconds=0.125,
                           length_quantum_seconds=seconds)
    server = make_server(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bodies = [{"seconds": seconds, "seed": s, "stream": i == 3}
                  for i, s in enumerate(seeds)]
        for body, spk in zip(bodies, speakers or ()):
            body["speaker"] = spk
        if primed:
            prime = (0.5 * np.sin(np.arange(int(PRIME_SECONDS * rate))
                                  * 0.05)).astype(np.float32)
            bodies.append({"seconds": seconds, "seed": 505,
                           "prime": prime.tolist()})
        name = counter_name(mod, cfg)

        reset_counts()                           # the main path starts here
        wall = time.monotonic()
        replies = _concurrently(url, bodies)
        wall = time.monotonic() - wall
        launches = check_only([name], f"phase {phase}")[name]
        st = dict(engine.stats)
        if one_batch:
            check(st["batches"] == 1 + primed,
                  f"the requests did not share one batch: {st}")

        pcm = _pcm(bodies, [n] * len(bodies), replies, rate)
        check(len({p.tobytes() for p in pcm}) == len(pcm),
              "distinct requests gave identical audio")

        # replay co-batched requests alone: bit-identical audio
        for i in (range(len(seeds)) if one_batch else [1]):
            _, _, again = _post(url + "/synthesize",
                                dict(bodies[i], stream=False))
            check(np.array_equal(_wav_samples(again, rate), pcm[i]),
                  f"request {i} replayed alone gave different audio")

        # served audio vs the plain PyTorch decode of the same request
        check(np.array_equal(pcm[0][:REF_SAMPLES], _plain_pcm(
            mod, model, cfg, seeds[0], dev,
            speaker=None if speakers is None else speakers[0])),
            "served audio differs from the plain decode")

        # aggregate over the concurrent requests (replays excluded)
        rtf = st["samples_out"] / rate / st["decode_seconds"]
        print(f"phase {phase} served: requests={st['requests']} "
              f"batches={st['batches']} padded_rows={st['padded_rows']} "
              f"samples_out={st['samples_out']} "
              f"decode_seconds={st['decode_seconds']} realtime_factor={rtf} "
              f"wall_s_{len(bodies)}_requests={wall} {name}={launches} "
              f"replay_bit_identical=True card={card!r}", flush=True)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        engine.close()


def phase_serve_vocoder(mod, cfg, dev, card: str, phase: int = 7) -> int:
    """Serve the mel model `cfg` over HTTP; returns the mel decode
    variant's launch count (of mod) over the served requests."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.models import conditioning
    from wavenet_tpu_torch.serving import WaveNetServer
    from wavenet_tpu_torch.serving.http import make_server
    from wavenet_tpu_torch.serving.server import unconditioned

    rate, hop, M = cfg.sample_rate, cfg.mel.hop_length, cfg.mel.num_mels
    model = _served_model(cfg, dev)
    engine = WaveNetServer(model, max_batch=4, max_wait_ms=300.0,
                           chunk_seconds=0.125,
                           length_quantum_seconds=max(VOC_SECONDS))
    server = make_server(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        rs = np.random.RandomState(9)
        lens = [int(VOC_SECONDS[0] * rate), int(VOC_SECONDS[1] * rate),
                int(VOC_SECONDS[0] * rate), int(PRIME_SECONDS * rate)]
        prime = (0.5 * np.sin(np.arange(int(PRIME_SECONDS * rate)) * 0.05)
                 ).astype(np.float32)
        span = [0, 0, 0, prime.size - 1]
        mels = [(rs.randn(-(-(s + n) // hop), M) * 2.0 - 4.0)
                .astype(np.float32) for s, n in zip(span, lens)]
        bodies = [{"num_samples": n, "seed": 11 + i, "mel": m.tolist(),
                   "stream": i == 2} for i, (n, m) in enumerate(zip(lens,
                                                                    mels))]
        bodies[3]["prime"] = prime.tolist()
        name = counter_name(mod, cfg)

        reset_counts()                           # the main path starts here
        wall = time.monotonic()
        replies = _concurrently(url, bodies)
        wall = time.monotonic() - wall
        launches = check_only([name], f"phase {phase}")[name]
        st = dict(engine.stats)
        check(st["batches"] < st["requests"],
              f"the mel requests did not batch: {st}")

        pcm = _pcm(bodies, lens, replies, rate)
        check(len({p.tobytes() for p in pcm}) == len(pcm),
              "distinct requests gave identical audio")

        # a batched request replayed alone: bit-identical audio
        _, _, again = _post(url + "/synthesize", dict(bodies[1], stream=False))
        check(np.array_equal(_wav_samples(again, rate), pcm[1]),
              "a batched mel request differs from its singleton replay")

        # served audio vs the plain decode on the same upsampled features
        with torch.no_grad():
            y = conditioning.upsample_mel(
                model.params["upsampler"], cfg.mel,
                torch.from_numpy(mels[0][None]).to(dev), lens[0])
        check(np.array_equal(pcm[0][:REF_SAMPLES], _plain_pcm(
            mod, model, cfg, bodies[0]["seed"], dev, y=y)),
            "served vocoder audio differs from the plain decode")

        # a request without mel, as the reference's server takes it: the
        # kernel's unconditional variant on the same weights with no y
        uncond = unconditioned(model)
        plain_name = counter_name(mod, uncond.cfg)
        reset_counts()
        _, _, data = _post(url + "/synthesize",
                           {"num_samples": REF_SAMPLES, "seed": 21})
        melless = check_only([plain_name], f"phase {phase} mel-less "
                                           f"request")[plain_name]
        got = _wav_samples(data, rate)
        want = (np.clip(next(uncond.stream(num_samples=REF_SAMPLES,
                                           chunk_samples=REF_SAMPLES,
                                           seeds=[21]))[0], -1, 1)
                * 32767.0).astype("<i2")
        check(np.array_equal(got, want) and np.array_equal(got, _plain_pcm(
            mod, uncond, uncond.cfg, 21, dev)),
            "a mel-less request differs from the unconditional decode")

        print(f"phase {phase} served vocoder: requests={st['requests']} "
              f"batches={st['batches']} padded_rows={st['padded_rows']} "
              f"samples_out={st['samples_out']} "
              f"decode_seconds={st['decode_seconds']} realtime_factor="
              f"{st['samples_out'] / rate / st['decode_seconds']} "
              f"wall_s_4_requests={wall} {name}={launches} "
              f"replay_bit_identical=True | a request without mel: "
              f"{plain_name}={melless}, equal to the unconditional kernel "
              f"and plain decode on the same weights card={card!r}",
              flush=True)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        engine.close()


def _stack(ts, params, cfg, groups, x, ct, fwd, bwd, y=None, g=None):
    """(skip, loss = mean(skip * ct), grads, saved) through fwd and bwd."""
    skip, saved = ts.stack_forward(params, cfg, groups, x, fwd, y, g)
    return (skip, (skip * ct).mean(),
            ts.stack_backward(saved, ct / ct.numel(), bwd, y), saved)


def loss_rel(loss_k: float, loss_p: float, skip_p, ct) -> float:
    """|loss_k - loss_p| against mean(|skip * ct|): the loss mean(skip * ct)
    of a zero-mean ct is a cancelling sum near zero, so a band relative to
    itself would hold two correct sums in different orders to far more
    than their rounding; mean(|skip * ct|) is the size of what is summed."""
    return abs(loss_k - loss_p) / float((skip_p * ct).abs().mean())


def stack_bound(cfg, groups, B: int, T: int) -> dict:
    """Least time of the whole stack's forward and backward at [B, T],
    every product on tensor cores at the bf16 peak.  The forward's
    products and the backward's recompute of z (bf16 operands, with mel
    y @ V_cond too) are one bf16 pass each (the kernels sum them exactly
    on the f64 tensor cores instead, whose peak puts that design's floor
    ~15x higher; PERF.md §6); the backward's products with an f32
    cotangent (dh, dz @ Wz^T, dWz, dWrs, with mel dV_cond and dy) split
    the f32 operand into three bf16 terms, so each is three bf16 passes.
    Against the bytes each must move (input and output activations, y,
    the speaker offsets g in and dg out as f32, the bf16 layer-input
    stash, weights).  A speaker adds no products."""
    L, R, S = cfg.num_layers, cfg.residual_channels, cfg.skip_channels
    nm = 0 if cfg.mel is None else cfg.mel.num_mels
    M = B * T
    gbytes = 0 if cfg.global_classes is None else B * L * 2 * R * 4
    wbytes = L * (4 * R * R + R * (R + S) + 2 * R * nm) * 2
    stash = (L + len(groups)) * M * R * 2
    fwd_ops = 2 * M * L * (4 * R * R + R * (R + S) + 2 * R * nm) / PEAK_BF16
    fwd_bytes = (4 * M * R + 4 * M * S + 2 * M * nm + stash + wbytes
                 + gbytes) / PEAK_BYTES
    bwd_ops = 2 * M * L * (4 * R * R + 2 * R * nm + 3 * (
        2 * R * (R + S) + 8 * R * R + 4 * R * nm)) / PEAK_BF16
    bwd_bytes = (stash + 4 * M * S + 4 * M * R + 6 * M * nm + 3 * wbytes
                 + 2 * gbytes) / PEAK_BYTES
    out = {}
    for name, t_ops, t_bytes in (("fwd", fwd_ops, fwd_bytes),
                                 ("bwd", bwd_ops, bwd_bytes)):
        out[name] = {"bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "library_ms": None}
    return out


def _mel_features(params, cfg, B: int, T: int, rs, dev):
    """Upsampled features [B, T, M] f32 of random log-mel-like frames,
    through the model's upsampler."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.models import conditioning
    F = -(-T // cfg.mel.hop_length)
    frames = torch.from_numpy((rs.randn(B, F, cfg.mel.num_mels) * 2.0 - 4.0)
                              .astype(np.float32)).to(dev)
    with torch.no_grad():
        return conditioning.upsample_mel(params["upsampler"], cfg.mel,
                                         frames, T).contiguous()


def speaker_ids(B: int) -> list:
    """B speaker ids in [0, SPEAKERS), each used by two neighbouring rows."""
    return [(37 * (i // 2) + 5) % SPEAKERS for i in range(B)]


def phase_train_stack(ts, wn, cfg, params, dev, card: str, phase: int = 4,
                      num_groups: int = 5,
                      batches=(TS_B, TS_TRAIN_B)) -> dict:
    """Kernels vs plain over the whole stack of `cfg` (`full`, or the mel
    model `full_vocoder` with y; with speakers, the offsets g of
    speaker_ids) at each batch of `batches`; returns the table's numbers
    for the forward and backward kernels at the last batch."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.utils import profiling
    TT = ts.pick_tile(cfg, TS_T)
    groups = ts.group_plan(cfg, TT)
    check(len(groups) == num_groups,
          f"expected {num_groups} layer groups, got {groups}")
    rs = np.random.RandomState(4)

    def inputs(B):
        toks = torch.from_numpy(rs.randint(
            0, cfg.quantization_channels, (B, TS_T)).astype(np.int32)).to(dev)
        x = wn.embed_tokens(params, cfg, toks, wn._shifted_tokens(toks))
        ct = torch.from_numpy(rs.randn(B, TS_T, cfg.skip_channels).astype(
            np.float32)).to(dev)
        y = g = None
        if cfg.mel is not None:
            y = _mel_features(params, cfg, B, TS_T, rs, dev).to(
                torch.bfloat16)
        if cfg.global_classes is not None:
            g = wn.global_cond_offsets(params, cfg, torch.tensor(
                speaker_ids(B), device=dev))
        return x.contiguous(), ct, y, g

    def compare(B):
        """Kernel vs plain at [B, TS_T] (and two kernel runs), checked
        against the bands; returns the inputs, both runs and the errors."""
        x, ct, y, g = inputs(B)
        k = _stack(ts, params, cfg, groups, x, ct, ts.group_fwd, ts.group_bwd,
                   y, g)
        k2 = _stack(ts, params, cfg, groups, x, ct, ts.group_fwd,
                    ts.group_bwd, y, g)
        p = _stack(ts, params, cfg, groups, x, ct, ts.group_fwd_reference,
                   ts.group_bwd_reference, y, g)
        torch.cuda.synchronize()
        skip_err = float((k[0] - p[0]).abs().max())
        skip_rel = skip_err / float(p[0].abs().max())
        lrel = loss_rel(float(k[1]), float(p[1]), p[0], ct)
        grad_rel, grad_err = {}, 0.0
        for (name, gk), (_, gp) in zip(k[2], p[2]):
            e = float((gk - gp).abs().max())
            grad_err = max(grad_err, e)
            grad_rel[name] = e / max(float(gp.abs().max()), 1e-30)
        same = (torch.equal(k[0], k2[0]) and torch.equal(k[1], k2[1])
                and all(torch.equal(a, b) for (_, a), (_, b)
                        in zip(k[2], k2[2])))
        del k2
        print(f"phase {phase} train_stack: B={B} T={TS_T} groups={groups} "
              f"speakers={None if g is None else speaker_ids(B)} "
              f"skip_rel={skip_rel} skip_max_abs_err={skip_err} "
              f"loss_kernel={float(k[1])} loss_plain={float(p[1])} "
              f"loss_rel_to_mean_abs={lrel} worst_grad="
              f"{max(grad_rel.values())} "
              f"({max(grad_rel, key=grad_rel.get)}) grad_max_abs_err="
              f"{grad_err} kernel_runs_bit_identical={same}", flush=True)
        check(skip_rel <= SKIP_TOL, f"B={B}: skip differs: {skip_rel}")
        check(lrel <= LOSS_TOL, f"B={B}: loss differs: {lrel}")
        for name, r in grad_rel.items():
            check(r <= GRAD_TOL, f"B={B}: gradient {name} differs: {r}")
        check(same, f"B={B}: two kernel runs differ")
        return x, ct, y, g, k, p, skip_err, grad_err

    with torch.no_grad():
        times = {}
        for B in batches:
            x, ct, y, g, k, p, skip_err, grad_err = compare(B)
            dsk = ct / ct.numel()
            fwd_k = cuda_ms(lambda: ts.stack_forward(
                params, cfg, groups, x, ts.group_fwd, y, g), 3)
            fwd_p = cuda_ms(lambda: ts.stack_forward(
                params, cfg, groups, x, ts.group_fwd_reference, y, g), 3)
            bwd_k = cuda_ms(lambda: ts.stack_backward(
                k[3], dsk, ts.group_bwd, y), 3)
            bwd_p = cuda_ms(lambda: ts.stack_backward(
                p[3], dsk, ts.group_bwd_reference, y), 3)
            times[B] = (fwd_k, fwd_p, bwd_k, bwd_p, skip_err, grad_err)
            print(f"phase {phase} train_stack times B={B} T={TS_T}: "
                  f"fwd_kernel_ms={fwd_k} fwd_plain_ms={fwd_p} "
                  f"bwd_kernel_ms={bwd_k} bwd_plain_ms={bwd_p} "
                  f"card={card!r}", flush=True)
            if B == batches[-1]:
                for what, fn in (
                        ("fwd", lambda: ts.stack_forward(
                            params, cfg, groups, x, ts.group_fwd, y, g)),
                        ("bwd", lambda: ts.stack_backward(
                            k[3], dsk, ts.group_bwd, y))):
                    print(f"phase {phase} train_stack {what} split B={B} "
                          f"T={TS_T}: device ms by kernel "
                          f"{json.dumps(profiling.kernel_split(fn))} "
                          f"card={card!r}", flush=True)
            del k, p
    bound = stack_bound(cfg, groups, batches[-1], TS_T)
    fk, fp, bk, bp, skip_err, grad_err = times[batches[-1]]
    return {"fwd": {"max_abs_err": skip_err, "ms": fk, "plain_ms": fp,
                    **bound["fwd"]},
            "bwd": {"max_abs_err": grad_err, "ms": bk, "plain_ms": bp,
                    **bound["bwd"]}}


def phase_colsums(ts, dev, card: str, phase: int = 4) -> dict:
    """The backward's bias-gradient column sums alone
    (train_stack.column_sums), a train step's worth at `full`'s and
    `fastgen_bench`'s shapes (the preset's batch of TS_T rows; per layer
    db over [M, 2R] and db_res over [M, R] in one launch, per layer group
    db_skip over [M, S]): colsum_kernel's device ms a step beside the byte
    floor (each input byte read once at PEAK_BYTES)."""
    import torch
    from wavenet_tpu_torch.config import fastgen_bench, full
    from wavenet_tpu_torch.utils import profiling
    out = {}
    for name, cfg in (("full", full()), ("fastgen_bench", fastgen_bench())):
        L, R, S = cfg.num_layers, cfg.residual_channels, cfg.skip_channels
        ng = len(ts.group_plan(cfg, ts.pick_tile(cfg, TS_T)))
        M = cfg.batch_size * TS_T
        gen = torch.Generator(device=dev).manual_seed(5)
        dz, din, dskip = (torch.randn(M, n, device=dev, generator=gen)
                          for n in (2 * R, R, S))

        def step():
            for _ in range(L):
                ts.column_sums(dz, din)
            for _ in range(ng):
                ts.column_sums(dskip)

        before = ts.colsum_launches.value
        ms = profiling.kernel_split(step).get("colsum_kernel", 0.0)
        launches = ts.colsum_launches.value - before
        check(launches == 2 * (L + ng),
              f"{name}: {launches} column-sum launches in two steps")
        floor_ms = 4 * M * (3 * R * L + S * ng) / PEAK_BYTES * 1e3
        out[name] = {"ms": ms, "floor_ms": floor_ms}
        print(f"phase {phase} column sums {name}: B={cfg.batch_size} "
              f"T={TS_T} launches_per_step={L + ng} colsum_kernel_ms="
              f"{ms} byte_floor_ms={floor_ms} floor_share={floor_ms / ms} "
              f"card={card!r}", flush=True)
        del dz, din, dskip
    return out


def speaker_cost(ts, wn, cfg, params, dev, card: str) -> None:
    """The speaker variants' cost on the card: the whole stack of the
    speaker model `cfg` at [TS_TRAIN_B, TS_T], kernel forward and backward
    ms without and with the offsets g, in turns (without, with, with,
    without) on the same inputs, so that both see the same clocks."""
    import numpy as np
    import torch
    groups = ts.group_plan(cfg, ts.pick_tile(cfg, TS_T))
    rs = np.random.RandomState(14)
    toks = torch.from_numpy(rs.randint(
        0, cfg.quantization_channels, (TS_TRAIN_B, TS_T)).astype(
            np.int32)).to(dev)
    x = wn.embed_tokens(params, cfg, toks, wn._shifted_tokens(toks))
    dsk = torch.from_numpy(rs.randn(TS_TRAIN_B, TS_T, cfg.skip_channels)
                           .astype(np.float32) / (TS_TRAIN_B * TS_T)).to(dev)
    g = wn.global_cond_offsets(params, cfg, torch.tensor(
        speaker_ids(TS_TRAIN_B), device=dev))
    ms = {"without": [], "with": []}
    with torch.no_grad():
        for turn in ("without", "with", "with", "without"):
            gt = g if turn == "with" else None
            fwd = cuda_ms(lambda: ts.stack_forward(
                params, cfg, groups, x, ts.group_fwd, None, gt), 3)
            saved = ts.stack_forward(params, cfg, groups, x, ts.group_fwd,
                                     None, gt)[1]
            bwd = cuda_ms(lambda: ts.stack_backward(
                saved, dsk, ts.group_bwd), 3)
            ms[turn].append((fwd, bwd))
            del saved
    print(f"phase 14 speaker cost B={TS_TRAIN_B} T={TS_T} in turns "
          f"(without, with, with, without): fwd_kernel_ms without="
          f"{[f for f, _ in ms['without']]} with={[f for f, _ in ms['with']]}"
          f" bwd_kernel_ms without={[b for _, b in ms['without']]} with="
          f"{[b for _, b in ms['with']]} card={card!r}", flush=True)


def _losses(path: str) -> dict:
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def phase_train(ts, dmod, dev, card: str, preset: str = "full",
                phase: int = 5, speakers: bool = False, overrides=(),
                steps: int = TRAIN_STEPS, resume_at: int = RESUME_AT,
                rows=(64, 64), keep_model: bool = False) -> dict:
    """Train `preset` (with SPEAKERS classes when `speakers`, and
    `overrides` of its config) through the CLI's main() for `steps` steps,
    resume from step `resume_at`, and decode the checkpoint through dmod's
    kernel (a mel model vocodes a clip, a speaker model decodes two
    speakers); the stack's layer blocks must have launched at `rows` rows
    (forward, backward).  Returns the launch counts of the three kernels
    (of their mel or speaker variants for such a model), the tiles'
    calls, and with keep_model the checkpoint's model."""
    import math
    import numpy as np
    import torch
    from wavenet_tpu_torch import train
    from wavenet_tpu_torch.models.api import WaveNet
    overrides = [f"train_window={TS_T}", *overrides]
    if speakers:
        overrides.append(f"global_classes={SPEAKERS}")
    common = ["--preset", preset, "--synthetic", "--device", "cuda",
              "--batch-size", str(TS_TRAIN_B), "--log-every", "1"]
    for o in overrides:
        common += ["--override", o]
    cfg = train.build_config(train.parse_args(common))
    mel = cfg.mel is not None
    var = "gc_" if speakers else "mel_" if mel else ""
    fwd_name = f"train_stack.fwd_{var}launches"
    bwd_name = f"train_stack.bwd_{var}launches"
    fwd_c, bwd_c = COUNTERS[fwd_name], COUNTERS[bwd_name]
    dec_name = counter_name(dmod, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()                           # the training path starts here
        ts.tile_calls.clear()
        ma = train.main(common + [
            "--steps", str(steps), "--ckpt", a, "--ckpt-every",
            str(resume_at), "--metrics-file", os.path.join(tmp, "a.jsonl")])
        torch.cuda.synchronize()
        fwd_n, bwd_n = fwd_c.value, bwd_c.value
        tiles = dict(ts.tile_calls)
        check(set(tiles) == {f"fwd{rows[0]}", f"bwd{rows[1]}"},
              f"layer blocks launched at {tiles}, expected {rows} rows")
        # per step and layer group: Lg + 1 forward kernels and
        # (7 + 2 mel + speaker) Lg + 1 backward kernels (train_stack.cu)
        ng = len(ts.group_plan(cfg, ts.pick_tile(cfg, TS_T)))
        L = cfg.num_layers
        want = (steps * (L + ng),
                steps * ((7 + 2 * mel + speakers) * L + ng))
        check((fwd_n, bwd_n) == want, "training launched (fwd, bwd) = "
              f"{(fwd_n, bwd_n)} train_stack kernels, expected {want}")
        check_only([fwd_name, bwd_name], f"phase {phase} training")
        os.makedirs(b)
        for f in ("params.json", f"ckpt_{resume_at:08d}.pt"):
            shutil.copy(os.path.join(a, f), b)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        train.main(common + [
            "--steps", str(steps - resume_at), "--ckpt", b, "--resume",
            "--metrics-file", os.path.join(tmp, "b.jsonl")])
        la = _losses(os.path.join(tmp, "a.jsonl"))
        lb = _losses(os.path.join(tmp, "b.jsonl"))
        check(sorted(la) == list(range(1, steps + 1))
              and all(math.isfinite(v) for v in la.values()),
              f"losses of the uninterrupted run: {la}")
        check(sorted(lb) == list(range(resume_at + 1, steps + 1))
              and all(lb[s] == la[s] for s in lb),
              f"resumed losses {lb} differ from {la}")
        last = f"ckpt_{steps:08d}.pt"
        ca = torch.load(os.path.join(a, last), weights_only=True)
        pa = ca["params"]
        pb = torch.load(os.path.join(b, last), weights_only=True)["params"]
        pdt = getattr(torch, cfg.param_dtype)
        check(all(v.dtype == pdt for tree in (
            pa, ca["ema"] or {}, ca["opt_state"]["mu"], ca["opt_state"]["nu"])
            for v in tree.values()),
            f"a checkpoint leaf is not {cfg.param_dtype}")
        check(sorted(pa) == sorted(pb)
              and (not mel or "upsampler/w0" in pa)
              and (not speakers or {"g_embed", "v_global"} <= set(pa))
              and all(torch.equal(pa[k], pb[k]) for k in pa),
              "resumed params differ from the uninterrupted run's")
        check(fwd_c.value > fwd_n and bwd_c.value > bwd_n,
              "the resumed run did not launch the train_stack kernels")

        reset_counts()                           # the serving path starts here
        model = WaveNet.from_checkpoint(a, device=dev)
        n = int(DECODE_SECONDS * model.cfg.sample_rate)
        if mel:
            t = np.arange(n) / cfg.sample_rate        # a synthetic clip
            clip = (0.3 * np.sin(2 * np.pi * 220.0 * t)
                    + 0.1 * np.sin(2 * np.pi * 1300.0 * t)).astype(np.float32)
            toks = model.vocode(clip, seed=1)
            hop = cfg.mel.hop_length
            n = (1 + (n - 1) // hop) * hop
        elif speakers:
            toks = model.generate(seconds=DECODE_SECONDS, seed=1, batch=2,
                                  speaker=[3, 50])
        else:
            toks = model.generate(seconds=DECODE_SECONDS, seed=1)
        torch.cuda.synchronize()
        dec_n = check_only([dec_name], f"phase {phase} decode")[dec_name]
        check(tuple(toks.shape) == (2 if speakers else 1, n)
              and int(toks.min()) >= 0
              and int(toks.max()) < model.cfg.quantization_channels,
              "bad decode of the trained model")
    print(f"phase {phase} trained and served: preset={preset} "
          f"overrides={overrides} steps={steps} "
          f"losses={[la[s] for s in sorted(la)]} resumed_from={resume_at} "
          f"resume_bit_exact=True ms_per_step={1e3 / ma['steps_per_sec']} "
          f"audio_seconds_per_sec={ma['audio_seconds_per_sec']} "
          f"peak_device_memory_gb={peak_gb} "
          f"train_stack_fwd_launches={fwd_n} train_stack_bwd_launches="
          f"{bwd_n} layer_block_calls_by_rows={tiles} decode_launches="
          f"{dec_n} decoded_samples={n} card={card!r}", flush=True)
    out = {"train_stack_fwd": fwd_n, "train_stack_bwd": bwd_n,
           "decode": dec_n, "losses": [la[s] for s in sorted(la)],
           "ms_per_step": 1e3 / ma["steps_per_sec"], "tiles": tiles,
           "peak_device_memory_gb": peak_gb}
    if keep_model:
        out["model"] = model
    return out


def phase_speakers(pnarrow, pwide, wn, dev, card: str):
    """Phase 13: speaker-conditioned `fastgen_bench` (narrow) and `full`
    (wide) models with SPEAKERS classes: each kernel's speaker variant vs
    plain, then each model served.  Returns ((numbers, launches) of the
    narrow kernel, the same of the wide one)."""
    import torch
    from wavenet_tpu_torch.config import fastgen_bench, full
    out = []
    for mod, base, batch in ((pnarrow, fastgen_bench(), 8),
                             (pwide, full(), 4)):
        cfg = base.replace(global_classes=SPEAKERS)
        params = wn.init_params(cfg, torch.Generator().manual_seed(0), dev)
        w = mod.flatten_params(params, cfg)
        ids = [(37 * i + 5) % SPEAKERS for i in range(batch)]
        numbers = phase_kernel(mod, cfg, w, dev, card, phase=13, batch=batch,
                               steps=SPK_STEPS, speaker=ids)
        del params, w
        launches = phase_serve(mod, cfg, dev, card, phase=13,
                               seconds=SPK_SECONDS, seeds=(5, 5, 6, 7),
                               speakers=(3, 50, 77, SPEAKERS - 1),
                               primed=False, one_batch=True)
        out.append((numbers, launches))
    return out


def probe_numbers(probes, dev) -> dict:
    """Phase 15's probe kernels against their plain versions (on the CPU
    for the comparison; on the card, the same functions, for plain_ms):
    P1 and P4 and P3's bf16 cases exact, P3's f32 case within 1e-6 of its
    largest element, P2 within probes.GATE_ULPS ulps of torch's CPU
    values.  max_abs_err is the largest difference measured.  Per probe,
    the device ms (device_ms) of one call of each of its cases summed,
    likewise plain_ms and the bound, and library_ms where one PyTorch call
    computes the same function (torch.tanh for P2's first output).  P1's
    modes, P2, P4's cases, torch.tanh, the launch floor and P4's same-bytes
    yardstick are timed in GATE_ROUNDS rounds in turns: P2's ms and
    library_ms and P1's and P4's summed ms are medians of those rounds,
    each printed with its range.  P1's modes, P4's cases and the floor are
    also timed one call alone (alone_ms), as the verify tool calls them.
    P1's "ring_launches" is also called twice with nothing between the
    calls, P2 is held on a misaligned, ragged input, P3 at T = 17 and 300,
    P4 at TT = 300, R = 63 and on an x off 16-byte alignment, and P3's ms
    and bounds are printed per case."""
    import numpy as np
    import torch
    inp, cpu = probes.probe_inputs(dev), probes.probe_inputs("cpu")
    f32b = 4

    def bound(nbytes: float, ops: float, peak: float) -> dict:
        t_b, t_o = nbytes / PEAK_BYTES, ops / peak
        return {"bound_ms": max(t_b, t_o) * 1e3,
                "bound_by": "bytes" if t_b >= t_o else "operations"}

    def abs_err(got, want) -> float:
        return float((got.cpu() - want).abs().max())

    # P1: each mode writes [rows, tiles, 8, 128] f32 and reads nothing;
    # "ring_launches" runs twice with no synchronisation between the calls
    # (the second call's ring is the memory the first one just freed: its
    # first launch may touch it only after the first call's last launch)
    p1_err, p1_pms, p1_bytes = 0.0, 0.0, 0
    for mode, (_, rows, tiles, expect) in probes.SCRATCH_MODES.items():
        calls = [probes.probe_scratch(mode, dev)]
        if mode == "ring_launches":
            calls.append(probes.probe_scratch(mode, dev))
        want = probes.probe_scratch_reference(mode)
        for i, got in enumerate(calls):
            got = got.cpu()
            check(torch.equal(got, want) and torch.equal(
                got[:, :, 0, 0], torch.tensor(expect, dtype=torch.float32)),
                f"P1 {mode} (call {i + 1} of {len(calls)}): kernel != "
                f"plain or the probe's expectation")
            p1_err = max(p1_err, abs_err(got, want))
        p1_pms += device_ms(lambda: probes.probe_scratch_reference(mode, dev))
        p1_bytes += want.numel() * f32b
    print("phase 15 probe_scratch: every mode exact, ring_launches also "
          "twice back to back", flush=True)
    # P2: 8,192 inputs, three outputs; ~20 f32 operations per element
    x = inp["gate_x"]
    got = probes.probe_gate(x)
    want = probes.probe_gate_reference(cpu["gate_x"])
    for name, a, b in zip(("tanh", "sigmoid", "gate"), got, want):
        u = probes.ulps(a, b)
        check(u <= probes.GATE_ULPS, f"P2 {name}: {u} ulps from torch's CPU "
              f"values (> {probes.GATE_ULPS})")
    p2_err = max(abs_err(a, b) for a, b in zip(got, want))
    # ragged inputs: a view one element into its buffer, n = 8,190 (off
    # 8-byte alignment: every element one at a time), and n = 8,191 from
    # the buffer's start (pairs, then the odd element alone)
    for off, n in ((1, 8190), (0, 8191)):
        buf = torch.from_numpy(np.linspace(-30.0, 30.0, n + off,
                                           dtype=np.float32))
        got = probes.probe_gate(buf.to(dev)[off:])
        us = [probes.ulps(a, b) for a, b in
              zip(got, probes.probe_gate_reference(buf[off:]))]
        check(max(us) <= probes.GATE_ULPS and got[0].shape == (n,),
              f"P2 at offset {off}, n = {n}: {us} ulps from torch's CPU "
              f"values (> {probes.GATE_ULPS})")
        print(f"phase 15 probe_gate ragged: n={n} offset={off} ulps={us}",
              flush=True)
    # P3: a [256,128]x[128,64] and b [256,64]x[64,128] bf16 products, c
    # an f32 [256,128]x[128,64] one, on the f64 tensor cores; the bound by
    # the bf16 peak (a and b; the least time the card could take) and by
    # the f64 tensor cores' (the instruction the kernel runs)
    err = 0.0
    for T in (256, 17, 300):
        lin, lcpu = ((inp, cpu) if T == 256 else
                     (probes.lane_inputs(T, dev),
                      probes.lane_inputs(T, "cpu")))
        for case in probes.LANE_CASES:
            ops = probes.LANE_OPS[case]
            got = probes.probe_lane_ops(case, *(lin[k] for k in ops))
            want = probes.probe_lane_ops_reference(case,
                                                   *(lcpu[k] for k in ops))
            for a, b in zip(got, want):
                e = abs_err(a, b)
                check(e <= 1e-6 * float(b.abs().max()) if case == "c"
                      else e == 0.0, f"P3 {case}, T = {T}: kernel != plain "
                      f"({e})")
                err = max(err, e)
    print("phase 15 probe_lane_ops: cases a, b exact and c within 1e-6 of "
          "its largest element at T = 256, 17, 300", flush=True)
    ms, pms, t_b, t_o, t_64 = 0.0, 0.0, 0.0, 0.0, 0.0
    for case in probes.LANE_CASES:
        args = [inp[k] for k in probes.LANE_OPS[case]]
        c_ms = device_ms(lambda: probes.probe_lane_ops(case, *args))
        c_pms = device_ms(lambda: probes.probe_lane_ops_reference(case,
                                                                  *args))
        nb = (sum(t.numel() * t.element_size() for t in args)
              + (2 if case == "b" else 1) * 256 * 64 * f32b)
        flop = 2 * 256 * 128 * 64
        c_b, c_o = nb / PEAK_BYTES, flop / (PEAK_F32 if case == "c"
                                            else PEAK_BF16)
        print(f"phase 15 probe_lane_ops case {case}: ms={c_ms} "
              f"plain_ms={c_pms} bytes_ms={c_b * 1e3} "
              f"ops_ms={c_o * 1e3} ops_f64_ms={flop / PEAK_F32 * 1e3}",
              flush=True)
        ms, pms = ms + c_ms, pms + c_pms
        t_b, t_o, t_64 = t_b + c_b, t_o + c_o, t_64 + flop / PEAK_F32
    print(f"phase 15 probe_lane_ops summed: ms={ms} bound_ms="
          f"{max(t_b, t_o) * 1e3} bound_f64_ms={max(t_b, t_64) * 1e3} "
          f"(bytes {t_b * 1e3}, operations {t_o * 1e3}, at the f64 peak "
          f"{t_64 * 1e3})", flush=True)
    lane = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
            "library_ms": None, "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}
    # P4: a case reads D ring rows and TT - D rows of x and writes [TT, R]
    # f32 (the rest of the ring and of x is not read); held at the probe's
    # shape, at TT = 300, R = 63 (a width of no whole 16-byte quads) and on
    # an x one element into its buffer (off 16-byte alignment)
    p4_err, p4_pms = 0.0, 0.0
    for T, W, off in ((probes.TT, probes.R, 0), (300, 63, 0),
                      (probes.TT, probes.R, 1)):
        sin, scpu = ((inp, cpu) if (T, W, off) == (probes.TT, probes.R, 0)
                     else (probes.shift_inputs(T, W, dev, offset=off),
                           probes.shift_inputs(T, W, "cpu", offset=off)))
        check(sin["shift_x"].data_ptr() % 16 == 4 * off,
              f"P4's x at offset {off} is not where the check wants it")
        for case in probes.SHIFT_CASES:
            ring = "snaps" if case == "B" else "ring"
            got = probes.probe_shift_concat(case, sin[ring],
                                            sin["shift_x"]).cpu()
            want = probes.probe_shift_concat_reference(case, scpu[ring],
                                                       scpu["shift_x"])
            check(torch.equal(got, want), f"P4 {case} at TT = {T}, R = "
                  f"{W}, x offset {off}: kernel != plain")
            p4_err = max(p4_err, abs_err(got, want))
    xs = inp["shift_x"]
    for case in probes.SHIFT_CASES:
        ring = inp["snaps" if case == "B" else "ring"]
        p4_pms += device_ms(lambda: probes.probe_shift_concat_reference(
            case, ring, xs))
    print("phase 15 probe_shift_concat: every case exact at TT = 512, R = "
          "64, at TT = 300, R = 63, and on x one element into its buffer",
          flush=True)
    # in turns, the order reversed each round: the launch floor (one add on
    # a one-element tensor), P2, torch.tanh, P1's modes and P4's cases,
    # each back to back (device_ms: under PDL one launch's set-up overlaps
    # the last one's run) and alone (alone_ms: no overlap between calls,
    # only within mode 4's chain), and P4's same-bytes yardstick (x * 2
    # into a preallocated output: P4's bytes without the shift); the floor,
    # torch.tanh and the yardstick are never called by the port
    one, yard = torch.zeros(1, device=dev), torch.empty_like(xs)
    turns = {"floor": lambda: device_ms(lambda: one.add_(1.0)),
             "floor alone": lambda: alone_ms(lambda: one.add_(1.0)),
             "P2": lambda: device_ms(lambda: probes.probe_gate(x)),
             "torch.tanh": lambda: device_ms(lambda: torch.tanh(x)),
             "P4 yardstick": lambda: device_ms(
                 lambda: torch.mul(xs, 2.0, out=yard))}
    calls = {}                   # name: launches a call
    for mode, (kmode, _, tiles, _) in probes.SCRATCH_MODES.items():
        calls[f"P1 {mode}"] = (lambda m=mode: probes.probe_scratch(m, dev),
                               tiles if kmode == 4 else 1)
    for case in probes.SHIFT_CASES:
        ring = "snaps" if case == "B" else "ring"
        calls[f"P4 {case}"] = (
            lambda c=case, r=inp[ring]: probes.probe_shift_concat(c, r, xs),
            1)
    for name, (fn, _) in calls.items():
        turns[name] = lambda f=fn: device_ms(f)
        turns[name + " alone"] = lambda f=fn: alone_ms(f)
    times = {name: [] for name in turns}
    order = list(turns.items())
    for i in range(GATE_ROUNDS):
        for name, timed in order[::1 if i % 2 == 0 else -1]:
            times[name].append(timed())
    mid = GATE_ROUNDS // 2
    med = {}
    for name, ts in times.items():
        ts.sort()
        med[name] = ts[mid]

    def spread(name: str) -> str:
        ts = times[name]
        return f"median_ms={ts[mid]} range={ts[0]}-{ts[-1]}"
    print(f"phase 15 probe_gate in turns with torch.tanh, {GATE_ROUNDS} "
          f"rounds: P2 {spread('P2')} torch.tanh {spread('torch.tanh')}",
          flush=True)
    print(f"phase 15 launch floor (one-element add, the same rounds): back "
          f"to back {spread('floor')}; alone {spread('floor alone')}",
          flush=True)
    for name, (_, n) in calls.items():
        t, ta = med[name], med[name + " alone"]
        print(f"phase 15 {name} in turns with the floor: back to back "
              f"{spread(name)} launches={n} per_launch_ms={t / n} floors="
              f"{t / med['floor']}; alone {spread(name + ' alone')} "
              f"floors={ta / med['floor alone']}", flush=True)
    print(f"phase 15 P4 yardstick (torch.mul(x, 2.0, out=o) on shift_x, "
          f"the same bytes): {spread('P4 yardstick')}", flush=True)
    p1_ms = sum(med["P1 " + m] for m in probes.SCRATCH_MODES)
    p4_ms = sum(med["P4 " + c] for c in probes.SHIFT_CASES)
    print(f"phase 15 summed medians: probe_scratch ms={p1_ms} "
          f"probe_shift_concat ms={p4_ms}; alone: probe_scratch ms="
          f"{sum(med['P1 ' + m + ' alone'] for m in probes.SCRATCH_MODES)} "
          f"probe_shift_concat ms="
          f"{sum(med['P4 ' + c + ' alone'] for c in probes.SHIFT_CASES)}",
          flush=True)
    nbytes = len(probes.SHIFT_CASES) * f32b * probes.R * (
        probes.D + (probes.TT - probes.D) + probes.TT)
    return {
        "probe_scratch": {"max_abs_err": p1_err, "ms": p1_ms,
                          "plain_ms": p1_pms, "library_ms": None,
                          **bound(p1_bytes, 0, PEAK_F32)},
        "probe_gate": {
            "max_abs_err": p2_err, "ms": med["P2"],
            "plain_ms": device_ms(lambda: probes.probe_gate_reference(x)),
            "library_ms": med["torch.tanh"],
            **bound(4 * x.numel() * f32b, 20 * x.numel(), PEAK_F32)},
        "probe_lane_ops": lane,
        "probe_shift_concat": {"max_abs_err": p4_err, "ms": p4_ms,
                               "plain_ms": p4_pms, "library_ms": None,
                               **bound(nbytes, 0, PEAK_F32)}}


def phase_verify(probes, dev, card: str) -> tuple:
    """Phase 15: the verify tool in a subprocess (the main path of this
    slice), then the probe kernels here.  Returns (the probe rows'
    numbers, the tool's launch counts)."""
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    t = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "wavenet_tpu_torch.verify"],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    counts, lines = None, proc.stdout.splitlines()
    for line in lines:
        if line.startswith("VERIFY_COUNTS "):
            counts = json.loads(line[len("VERIFY_COUNTS "):])
        else:
            print(f"phase 15 verify | {line}", flush=True)
    if proc.returncode not in (0, 2):
        print(proc.stderr[-3000:], file=sys.stderr, flush=True)
    check(proc.returncode in (0, 2),
          f"verify exited {proc.returncode} (1: a FAIL)")
    check(counts is not None, "verify printed no launch counts")
    decode_lines = [ln for ln in lines
                    if ln.startswith(("decode ", "wide-decode "))]
    check(decode_lines and all(ln.split(": ", 1)[1].startswith("BIT-EXACT")
                               for ln in decode_lines),
          "a decode comparison of the verify tool is not BIT-EXACT")
    for name in ("probes.scratch_launches", "probes.gate_launches",
                 "probes.lane_launches", "probes.shift_launches",
                 "decode.launches", "decode_wide.launches",
                 "train_stack.fwd_launches", "train_stack.bwd_launches"):
        check(counts.get(name, 0) > 0,
              f"verify: {name} did not launch ({counts})")
    drifts = [ln for ln in lines if ": DRIFT" in ln]
    check(all(ln.startswith("train ") for ln in drifts),
          f"verify: a DRIFT outside the train_stack checks ({drifts})")
    print(f"phase 15 verify: exit={proc.returncode} "
          f"drift_lines={len(drifts)} decode_checks={len(decode_lines)} "
          f"all_decode_bit_exact=True seconds={time.monotonic() - t} "
          f"launches={counts} card={card!r}", flush=True)
    reset_counts()
    numbers = probe_numbers(probes, dev)
    short = {"probe_scratch": "scratch", "probe_gate": "gate",
             "probe_lane_ops": "lane", "probe_shift_concat": "shift"}
    for name, n in numbers.items():
        print(f"phase 15 {name}: ms={n['ms']} plain_ms={n['plain_ms']} "
              f"bound_ms={n['bound_ms']} ({n['bound_by']}) library_ms="
              f"{n['library_ms']} max_abs_err={n['max_abs_err']} "
              f"verify_launches="
              f"{counts[f'probes.{short[name]}_launches']} card={card!r}",
              flush=True)
    torch.cuda.synchronize()
    return numbers, counts


def _wav_bytes(paths) -> list:
    out = []
    for path in paths:
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def phase_entry_points(ts, dev, card: str, preset: str = "full") -> dict:
    """Phase 16: the train CLI with --sample-every and --profile-dir at
    `full`, the cost of a save every step (blocking and asynchronous), the
    generate CLI (one shot, --stream, --no-ema) against the facade, and
    the score CLI against one pass over each clip.  Returns the launches
    of the stack kernels and the wide decode kernel on these paths, the
    train config and the save costs (utils/profiling.host_costs)."""
    import numpy as np
    import torch
    from wavenet_tpu_torch import score, train
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.generate import __main__ as generate
    from wavenet_tpu_torch.generate.sampler import batch_paths
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.training.trainer import Trainer
    from wavenet_tpu_torch.utils import profiling
    phase_t = time.monotonic()
    device = str(dev)
    common = ["--preset", preset, "--synthetic", "--device", device,
              "--batch-size", str(TS_TRAIN_B), "--log-every", "1",
              "--override", f"train_window={TS_T}",
              "--override", "ema_decay=0.999", "--steps", str(ENTRY_STEPS),
              "--ckpt-every", str(ENTRY_CKPT_EVERY)]
    cfg = train.build_config(train.parse_args(common))
    with tempfile.TemporaryDirectory() as tmp:
        a, b, prof = (os.path.join(tmp, n) for n in ("a", "b", "prof"))
        train.main(common + ["--ckpt", a, "--metrics-file", a + ".jsonl"])
        reset_counts()                           # the training path starts here
        t = time.monotonic()
        train.main(common + [
            "--ckpt", b, "--metrics-file", b + ".jsonl", "--sample-every",
            str(SAMPLE_EVERY), "--sample-seconds", str(SAMPLE_SECONDS),
            "--profile-dir", prof])
        torch.cuda.synchronize()
        train_s = time.monotonic() - t
        kept = sorted(n for n in os.listdir(b) if n.startswith("ckpt_"))
        fwd, bwd, dec = ("train_stack.fwd_launches",
                         "train_stack.bwd_launches", "decode_wide.launches")
        counts = check_only([fwd, bwd, dec], "phase 16 training")
        ng = len(ts.group_plan(cfg, ts.pick_tile(cfg, TS_T)))
        L, samples = cfg.num_layers, ENTRY_STEPS // SAMPLE_EVERY
        check((counts[fwd], counts[bwd], counts[dec])
              == (ENTRY_STEPS * (L + ng), ENTRY_STEPS * (7 * L + ng),
                  samples),
              f"phase 16 training launched {counts}")
        la, lb = _losses(a + ".jsonl"), _losses(b + ".jsonl")
        check(sorted(la) == list(range(1, ENTRY_STEPS + 1)) and la == lb,
              f"losses with sampling and tracing {lb} differ from {la}")
        last = f"ckpt_{ENTRY_STEPS:08d}.pt"
        pa = torch.load(os.path.join(a, last), weights_only=True)
        pb = torch.load(os.path.join(b, last), weights_only=True)
        check(all(torch.equal(pa[tree][k], pb[tree][k])
                  for tree in ("params", "ema") for k in pa[tree]),
              "params or EMA with sampling and tracing differ")
        want_kept = [f"ckpt_{s:08d}.pt" for s in range(
            ENTRY_STEPS - 2 * ENTRY_CKPT_EVERY, ENTRY_STEPS + 1,
            ENTRY_CKPT_EVERY)]
        check(kept == want_kept, f"kept checkpoints {kept}, not {want_kept}")
        n_sample = int(SAMPLE_SECONDS * cfg.sample_rate)
        for step in range(SAMPLE_EVERY, ENTRY_STEPS + 1, SAMPLE_EVERY):
            with open(os.path.join(b, f"sample_step{step}.wav"), "rb") as f:
                got = _wav_samples(f.read(), cfg.sample_rate)
            check(got.shape == (n_sample,),
                  f"sample_step{step}.wav has {got.shape[0]} samples")
        with open(os.path.join(prof, "trace_steps10-15.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        traced = [k for k in ("fwd_layer_kernel", "bwd_layer_kernel",
                              "wgrad_kernel", "colsum_kernel")
                  if any(k in n for n in names)]
        check(len(traced) == 4, f"the trace holds only {traced}")
        steps_traced = sorted(n for n in names if n.startswith("train_step_"))

        ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=4.0)
        with tempfile.TemporaryDirectory() as ck:
            costs = profiling.host_costs(
                Trainer(cfg, ds, checkpoint_dir=ck, device=dev),
                SAVE_COST_STEPS)

        g = os.path.join(tmp, "gen")
        gen = ["--ckpt", b, "--seconds", str(GEN_SECONDS), "--batch",
               str(GEN_BATCH), "--seed", str(GEN_SEED), "--device", device]
        reset_counts()                           # the generate CLI starts here
        t = time.monotonic()
        toks = generate.main(gen + ["--out", os.path.join(g, "g.wav")])
        torch.cuda.synchronize()
        gen_s = time.monotonic() - t
        gen_n = check_only([dec], "phase 16 generate")[dec]
        n = int(GEN_SECONDS * cfg.sample_rate)
        check(toks.shape == (GEN_BATCH, n), f"generate gave {toks.shape}")
        cli = _wav_bytes(batch_paths(os.path.join(g, "g.wav"), GEN_BATCH))
        model = WaveNet.from_checkpoint(b, device=dev)
        model.generate_wav(os.path.join(g, "f.wav"), GEN_SECONDS,
                           batch=GEN_BATCH, seed=GEN_SEED)
        check(_wav_bytes(batch_paths(os.path.join(g, "f.wav"), GEN_BATCH))
              == cli, "the generate CLI's wavs differ from the facade's")
        check(np.array_equal(toks, model.generate(
            seconds=GEN_SECONDS, batch=GEN_BATCH, seed=GEN_SEED).cpu()
            .numpy()), "the generate CLI's tokens differ from the facade's")
        reset_counts()
        generate.main(gen + ["--out", os.path.join(g, "s.wav"), "--stream",
                             str(GEN_STREAM)])
        stream_n = check_only([dec], "phase 16 generate --stream")[dec]
        check(_wav_bytes(batch_paths(os.path.join(g, "s.wav"), GEN_BATCH))
              == cli, "--stream wavs differ from the one-shot ones")
        reset_counts()
        generate.main(gen + ["--out", os.path.join(g, "raw.wav"),
                             "--no-ema"])
        raw_n = check_only([dec], "phase 16 generate --no-ema")[dec]
        raw = _wav_bytes(batch_paths(os.path.join(g, "raw.wav"), GEN_BATCH))
        check(all(r != c for r, c in zip(raw, cli)),
              "--no-ema gave the EMA model's audio")

        t = time.monotonic()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            agg = score.main(batch_paths(os.path.join(g, "g.wav"), GEN_BATCH)
                             + ["--ckpt", b, "--chunk", str(SCORE_CHUNK),
                                "--json", "--device", device])
        score_s = time.monotonic() - t
        files = json.loads(out.getvalue().strip().splitlines()[-1])["files"]
        check(len(files) == GEN_BATCH, f"scored {len(files)} files")
        from wavenet_tpu_torch.audio import mulaw
        from wavenet_tpu_torch.audio.io import read_wav
        errs = []
        for r in files:
            w, _ = read_wav(r["file"], cfg.sample_rate)
            one = float(model.score(tokens=mulaw.encode_np(w)[None])[0])
            errs.append(abs(r["bits_per_sample"] - one))
        check(max(errs) <= SCORE_TOL,
              f"chunked scores off one pass by {max(errs)} > {SCORE_TOL}")
    print(f"phase 16 entry points: train.main {preset} B={TS_TRAIN_B} "
          f"T={TS_T} "
          f"steps={ENTRY_STEPS} ckpt_every={ENTRY_CKPT_EVERY} sample_every="
          f"{SAMPLE_EVERY} sample_seconds={SAMPLE_SECONDS} with "
          f"--profile-dir: losses_equal_without=True params_equal=True "
          f"kept={kept} seconds={train_s} launches={counts} "
          f"traced_kernels={traced} traced_steps={steps_traced} | "
          f"ms per step at B={TS_TRAIN_B} ({SAVE_COST_STEPS} steps a mode): "
          f"{costs} | generate {GEN_SECONDS}s x{GEN_BATCH} seed={GEN_SEED}: "
          f"seconds={gen_s} wide_launches={gen_n} equal_to_facade=True "
          f"stream={GEN_STREAM}s launches={stream_n} equal=True no_ema "
          f"launches={raw_n} differs=True | score chunk={SCORE_CHUNK} "
          f"files={len(files)} bits_per_sample={agg} max_err_vs_one_pass="
          f"{max(errs)} seconds={score_s} | phase_seconds="
          f"{time.monotonic() - phase_t} card={card!r}", flush=True)
    return {"train_stack_fwd": counts[fwd], "train_stack_bwd": counts[bwd],
            "decode_wide_sampling": counts[dec], "decode_wide_generate":
            gen_n, "cfg": cfg, "host_costs": costs}


# ---------------------------------------------------------------------------
# phase 17: the data pipeline and data-parallel training
# ---------------------------------------------------------------------------

# Written as the sitecustomize module of a torchrun launch's PYTHONPATH, so
# every rank process loads it at start (the launcher, without RANK, skips
# it).  It changes nothing the rank computes.
RANK_PROBE = r'''
"""chip_smoke.py's probe of a rank process: records every file created,
written, renamed or removed under $WAVENET_PROBE_WATCH (an audit hook),
each torch.distributed.all_reduce's and all_gather's bytes and seconds
(the device synchronised before and after it) and the broadcasts, and at
exit writes them with the rank's kernel launch counts and peak device
memory to $WAVENET_PROBE_OUT/rank<RANK>.json."""
import atexit
import json
import os
import sys
import time

if "RANK" in os.environ and "WAVENET_PROBE_OUT" in os.environ:
    _watch = os.path.abspath(os.environ["WAVENET_PROBE_WATCH"])
    _rec = {"writes": [], "all_reduce": [], "all_gather": [],
            "broadcasts": 0}
    _flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def _under(p):
        return (isinstance(p, (str, bytes)) and
                os.path.abspath(os.fsdecode(p)).startswith(_watch))

    def _hook(event, args):
        if event == "open":
            path, mode, flags = args
            if ((mode is not None and any(c in mode for c in "wax+"))
                    or (mode is None and flags & _flags)) and _under(path):
                _rec["writes"].append(os.fsdecode(path))
        elif event in ("os.mkdir", "os.rename", "os.remove") and \
                _under(args[0]):
            _rec["writes"].append(f"{event} {os.fsdecode(args[0])}")

    sys.addaudithook(_hook)
    import torch
    import torch.distributed as dist
    _all_reduce, _broadcast = dist.all_reduce, dist.broadcast
    _all_gather = dist.all_gather

    def _timer(fn, key, pos):
        def timed(*a, **k):
            tensor = a[pos] if len(a) > pos else k["tensor"]
            if tensor.is_cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            if tensor.is_cuda:
                torch.cuda.synchronize()
            _rec[key].append([tensor.numel() * tensor.element_size(),
                              time.perf_counter() - t])
            return out
        return timed

    def _counted(*a, **k):
        _rec["broadcasts"] += 1
        return _broadcast(*a, **k)

    dist.all_reduce = _timer(_all_reduce, "all_reduce", 0)
    dist.all_gather = _timer(_all_gather, "all_gather", 1)
    dist.broadcast = _counted

    if os.environ.get("WAVENET_PROBE_GRADS"):
        # phase 19: each step's wall and collective seconds (the device
        # synchronised), and the first step's reduced gradients, gathered
        # whole over `model` and saved by rank 0 (the gather's own time
        # is not counted)
        from wavenet_tpu_torch.parallel import collectives as _col
        from wavenet_tpu_torch.training import trainer as _trainer
        _reduce, _step = _trainer.Trainer._reduce, _trainer.Trainer.step
        _rec["steps"] = []

        def _first_reduce(self, grads):
            out = _reduce(self, grads)
            if "grads_saved" not in _rec:
                held = _col.seconds
                full = self._gather(out)
                _col.seconds = held
                _rec["grads_saved"] = True
                if os.environ["RANK"] == "0":
                    torch.save({k: v.detach().cpu() for k, v in full.items()},
                               os.environ["WAVENET_PROBE_GRADS"])
            return out

        def _timed_step(self, *a, **k):
            torch.cuda.synchronize()
            held, t = _col.seconds, time.perf_counter()
            out = _step(self, *a, **k)
            torch.cuda.synchronize()
            _rec["steps"].append([time.perf_counter() - t,
                                  _col.seconds - held])
            return out

        _trainer.Trainer._reduce = _first_reduce
        _trainer.Trainer.step = _timed_step

    def _dump():
        counts = {}
        for name, mod in list(sys.modules.items()):
            if name.startswith("wavenet_tpu_torch.ops.cuda.") and mod:
                for k, v in vars(mod).items():
                    if type(v).__name__ == "LaunchCounter":
                        counts[f"{name.rsplit('.', 1)[-1]}.{k}"] = v.value
        _rec["counts"] = counts
        _rec["peak_bytes"] = (torch.cuda.max_memory_allocated()
                              if torch.cuda.is_initialized() else 0)
        path = os.path.join(os.environ["WAVENET_PROBE_OUT"],
                            f"rank{os.environ['RANK']}.json")
        with open(path, "w") as f:
            json.dump(_rec, f)

    atexit.register(_dump)
'''


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(cmd, env, timeout: float) -> str:
    """Run cmd as the leader of a new process group; on a failure or the
    timeout kill the whole group (the launcher and its ranks) and raise."""
    import signal
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{cmd} ran past {timeout} s:\n{out[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    check(proc.returncode == 0,
          f"{cmd} exited {proc.returncode}:\n{out[-4000:]}")
    return out


def _probe_env(probe: str, watch: str) -> dict:
    """The environment of a torchrun launch whose ranks load the probe."""
    with open(os.path.join(probe, "sitecustomize.py"), "w") as f:
        f.write(RANK_PROBE)
    return dict(os.environ, WAVENET_PROBE_OUT=probe,
                WAVENET_PROBE_WATCH=watch,
                PYTHONPATH=os.pathsep.join(
                    [probe, ROOT] + [p for p in os.environ.get(
                        "PYTHONPATH", "").split(os.pathsep) if p]))


def _probe_records(probe: str, nproc: int) -> list:
    ranks = []
    for r in range(nproc):
        with open(os.path.join(probe, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _torchrun(nproc: int, args, watch: str,
              module: str = "wavenet_tpu_torch.train",
              output: list = None, env: dict = None) -> list:
    """python -m torch.distributed.run ... -m module args, with the rank
    probe (and `env` added to the ranks' environment); returns each rank's
    record (and appends the launch's output to `output` when given)."""
    with tempfile.TemporaryDirectory() as probe:
        out = _run_group([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc_per_node", str(nproc),
                          "-m", module, *args],
                         dict(_probe_env(probe, watch), **(env or {})),
                         DP_TIMEOUT_S)
        if output is not None:
            output.append(out)
        return _probe_records(probe, nproc)


def _last_record(path: str) -> dict:
    with open(path) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def phase_data(card: str) -> dict:
    """Phase 17, data: a synthetic 8-clip 16 kHz corpus written to disk;
    the native gatherer's batches == the NumPy loop's, the streaming
    dataset's (plain, prefetched, and each rank's rows) == AudioDataset's
    global batch and its slices, bit for bit; host ms per batch."""
    import numpy as np
    from wavenet_tpu_torch.audio.dataset import AudioDataset, IteratorState
    from wavenet_tpu_torch.audio.io import write_wav
    from wavenet_tpu_torch.audio.streaming import StreamingAudioDataset
    from wavenet_tpu_torch.config import full
    cfg = full().replace(batch_size=TS_TRAIN_B, train_window=TS_T)
    per = cfg.batch_size // DP_RANKS
    with tempfile.TemporaryDirectory() as root:
        rs = np.random.RandomState(17)
        t = np.arange(int(DATA_CLIP_SECONDS * cfg.sample_rate)) \
            / cfg.sample_rate
        for i in range(DATA_CLIPS):
            f, a, ph = (rs.uniform(80, 2000, 3), rs.uniform(0.1, 0.3, 3),
                        rs.uniform(0, 2 * np.pi, 3))
            x = sum(a[j] * np.sin(2 * np.pi * f[j] * t + ph[j])
                    for j in range(3))
            write_wav(os.path.join(root, f"clip{i}.wav"),
                      x.astype(np.float32), cfg.sample_rate)
        native = AudioDataset.from_dir(root, cfg)
        plain = AudioDataset.from_dir(root, cfg, native=False)
        stream = StreamingAudioDataset.from_dir(root, cfg)
        rank_ds = [StreamingAudioDataset.from_dir(root, cfg)
                   for _ in range(DP_RANKS)]
        prefetched = StreamingAudioDataset.from_dir(root, cfg, prefetch=2)
        states = [IteratorState(cfg.seed, s) for s in range(DATA_STATES)]
        prefetched.start_prefetch(states[0])
        try:
            for st in states:
                want, _ = native.sample_batch(st)
                got = [plain.sample_batch(st)[0], stream.sample_batch(st)[0],
                       prefetched.sample_batch(st)[0]]
                check(all(np.array_equal(g["tokens"], want["tokens"])
                          for g in got),
                      f"phase 17: batches of {st} differ between the "
                      f"gatherers")
                for r, ds in enumerate(rank_ds):
                    rows = slice(r * per, (r + 1) * per)
                    part, _ = ds.sample_batch(st, rows=rows)
                    check(np.array_equal(part["tokens"],
                                         want["tokens"][rows]),
                          f"phase 17: rank {r}'s rows of {st} differ")
        finally:
            prefetched.stop_prefetch()

        def ms_per_batch(ds) -> float:
            it = IteratorState(cfg.seed, 1000)
            for _ in range(3):                   # warm: every clip cached
                _, it = ds.sample_batch(it)
            t0 = time.perf_counter()
            for _ in range(DATA_TIMED):
                _, it = ds.sample_batch(it)
            return (time.perf_counter() - t0) * 1e3 / DATA_TIMED

        numbers = {"numpy_loop_ms": ms_per_batch(plain),
                   "native_ms": ms_per_batch(native),
                   "stream_ms": ms_per_batch(stream)}
        # the prefetched stream with its queue full: what a training loop
        # whose step outlasts the assembly waits per batch
        deep = StreamingAudioDataset.from_dir(root, cfg,
                                              prefetch=DATA_TIMED)
        start = IteratorState(cfg.seed, 2000)
        deep.start_prefetch(start)
        try:
            deadline = time.monotonic() + 60
            while not deep._pf_queue.full():
                check(time.monotonic() < deadline,
                      "phase 17: the prefetch queue never filled")
                time.sleep(0.01)
            it, t0 = start, time.perf_counter()
            for _ in range(DATA_TIMED):
                _, it = deep.sample_batch(it)
            numbers["prefetched_wait_ms"] = \
                (time.perf_counter() - t0) * 1e3 / DATA_TIMED
        finally:
            deep.stop_prefetch()
    print(f"phase 17 data: {DATA_CLIPS} clips x {DATA_CLIP_SECONDS} s at "
          f"{cfg.sample_rate} Hz, B={cfg.batch_size} T={TS_T}: native == "
          f"numpy loop == stream == prefetched stream over {DATA_STATES} "
          f"states, rows of {DP_RANKS} ranks == slices of the global batch "
          f"(bit for bit) | host ms per batch ({DATA_TIMED} batches): "
          f"{numbers} card={card!r}", flush=True)
    return numbers


def _dp_grads_rank(rank: int, port: int, out: str) -> None:
    """One rank of phase 17's first-step gradients: loss_fn_dp on its rows
    of the first training batch of `full` (train.main's data and params),
    the gradients reduced over two gloo ranks on cuda:0; rank 0 saves
    them."""
    import torch
    from wavenet_tpu_torch.models import wavenet as wn
    from wavenet_tpu_torch.parallel import dataparallel, distributed
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    distributed.initialize("gloo", device=dev, rank=rank,
                           world_size=DP_RANKS,
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        cfg, toks = _first_batch()
        cfg = cfg.replace(data_parallel=DP_RANKS)
        rows = distributed.local_batch_slice(cfg.batch_size)
        params = {k: v.requires_grad_(True) for k, v in wn.init_params(
            cfg, torch.Generator().manual_seed(cfg.seed), dev).items()}
        loss, aux = dataparallel.loss_fn_dp(params, cfg, toks[rows].to(dev),
                                            use_fused=True)
        keys = sorted(params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [params[k] for k in keys])))
        grads = dataparallel.reduce_gradients(grads)
        if rank == 0:
            torch.save({"grads": {k: v.cpu() for k, v in grads.items()},
                        "loss": float(aux["loss"])}, out)
    finally:
        distributed.shutdown()


def _first_batch():
    """(cfg, tokens) of train.main's first step at `full`, B = 8, T = 8192
    on synthetic data."""
    import torch
    from wavenet_tpu_torch.audio.dataset import AudioDataset, IteratorState
    from wavenet_tpu_torch.config import full
    cfg = full().replace(batch_size=TS_TRAIN_B, train_window=TS_T)
    ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=4.0)
    batch, _ = ds.sample_batch(IteratorState(seed=cfg.seed, step=0))
    return cfg, torch.from_numpy(batch["tokens"])


def phase_dp(ts, dev, card: str, single: dict) -> dict:
    """Phase 17, data parallelism on one card: train.main under torchrun,
    two gloo ranks on cuda:0 (`full`, B = 8 global, T = 8192, 6 steps, a
    checkpoint at step 3) against phase 5's single process, a resume of it
    bit for bit, only rank 0 writing, each rank's launches; the first
    step's reduced gradients against one process's; nccl at
    data_parallel=1 against a run without torch.distributed."""
    import math
    import torch
    import torch.multiprocessing as mp
    from wavenet_tpu_torch import train
    from wavenet_tpu_torch.models import wavenet as wn
    phase_t = time.monotonic()
    common = ["--preset", "full", "--synthetic", "--batch-size",
              str(TS_TRAIN_B), "--override", f"train_window={TS_T}",
              "--log-every", "1"]
    dp_args = common + ["--override", "ema_decay=0.999", "--override",
                        f"data_parallel={DP_RANKS}", "--dist-backend", "gloo",
                        "--device", "cuda:0"]
    cfg = train.build_config(train.parse_args(common))
    ng = len(ts.group_plan(cfg, ts.pick_tile(cfg, TS_T)))
    L = cfg.num_layers

    def rank_counts(rec, steps, what):
        got = {k: v for k, v in rec["counts"].items() if v}
        want = {"train_stack.fwd_launches": steps * (L + ng),
                "train_stack.bwd_launches": steps * (7 * L + ng)}
        check(got == want, f"{what}: launches {got}, expected {want}")

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t = time.monotonic()
        ranks = _torchrun(DP_RANKS, dp_args + [
            "--steps", str(TRAIN_STEPS), "--ckpt", os.path.join(a, "ckpt"),
            "--ckpt-every", str(RESUME_AT), "--metrics-file",
            os.path.join(a, "m.jsonl")], a)
        dp_s = time.monotonic() - t
        for r, rec in enumerate(ranks):
            rank_counts(rec, TRAIN_STEPS, f"phase 17 dp rank {r}")
            # the initial params, and a replica check at each of 3 saves
            check(rec["broadcasts"] == 4,
                  f"phase 17 dp rank {r}: {rec['broadcasts']} broadcasts")
        check(ranks[1]["writes"] == [] and ranks[0]["writes"],
              f"phase 17: rank 1 wrote {ranks[1]['writes']}")
        la = _losses(os.path.join(a, "m.jsonl"))
        ls = single["losses"]
        check(sorted(la) == list(range(1, TRAIN_STEPS + 1))
              and all(math.isfinite(v) for v in la.values()),
              f"phase 17 dp losses {la}")
        rel = [abs(la[s] - ls[s - 1]) / abs(ls[s - 1])
               for s in range(1, TRAIN_STEPS + 1)]
        check(rel[0] <= DP_STEP1_RTOL and max(rel) <= DP_LOSS_RTOL,
              f"phase 17 dp losses {la} off the single run's {ls}: {rel}")
        dp_ms = 1e3 / _last_record(os.path.join(a, "m.jsonl"))[
            "steps_per_sec"]

        os.makedirs(os.path.join(b, "ckpt"))
        for f in ("params.json", f"ckpt_{RESUME_AT:08d}.pt"):
            shutil.copy(os.path.join(a, "ckpt", f), os.path.join(b, "ckpt"))
        resumed = _torchrun(DP_RANKS, dp_args + [
            "--steps", str(TRAIN_STEPS - RESUME_AT), "--ckpt",
            os.path.join(b, "ckpt"), "--resume", "--metrics-file",
            os.path.join(b, "m.jsonl")], b)
        for r, rec in enumerate(resumed):
            rank_counts(rec, TRAIN_STEPS - RESUME_AT,
                        f"phase 17 dp resume rank {r}")
        check(resumed[1]["writes"] == [],
              f"phase 17: rank 1 wrote {resumed[1]['writes']}")
        lb = _losses(os.path.join(b, "m.jsonl"))
        check(sorted(lb) == list(range(RESUME_AT + 1, TRAIN_STEPS + 1))
              and all(lb[s] == la[s] for s in lb),
              f"phase 17: resumed losses {lb} differ from {la}")
        last = f"ckpt_{TRAIN_STEPS:08d}.pt"
        pa = torch.load(os.path.join(a, "ckpt", last), weights_only=True)
        pb = torch.load(os.path.join(b, "ckpt", last), weights_only=True)
        check(all(torch.equal(pa[tree][k], pb[tree][k])
                  for tree in ("params", "ema") for k in pa[tree]),
              "phase 17: the resumed params or EMA differ")
        check(sorted(os.listdir(os.path.join(a, "ckpt"))) == [
            f"ckpt_{RESUME_AT:08d}.pt", last, "params.json"],
            f"phase 17: {os.listdir(os.path.join(a, 'ckpt'))}")

        # the first step's reduced gradients against one process's
        out = os.path.join(tmp, "grads.pt")
        ctx = mp.start_processes(_dp_grads_rank, args=(_free_port(), out),
                                 nprocs=DP_RANKS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + DP_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      "phase 17: the gradient ranks ran past their limit")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        got = torch.load(out, weights_only=True)
        scfg, toks = _first_batch()
        params = {k: v.requires_grad_(True) for k, v in wn.init_params(
            scfg, torch.Generator().manual_seed(scfg.seed), dev).items()}
        loss, _ = wn.loss_fn(params, scfg, toks.to(dev), use_fused=True)
        keys = sorted(params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [params[k] for k in keys])))
        single_loss = float(loss.detach())
        rels, bf16_leaves = {}, []
        for k, g in grads.items():
            g = g.detach().cpu()
            rels[k] = float((got["grads"][k] - g).abs().max()
                            / g.abs().max())
            # a cotangent the recipe rounds to bf16 after the sum over rows
            # (the head's weights): each rank rounds its half-sum
            if torch.equal(g, g.bfloat16().float()):
                bf16_leaves.append(k)
        bad = {k: v for k, v in rels.items()
               if v > (DP_BF16_GRAD_TOL if k in bf16_leaves else DP_GRAD_TOL)}
        check(not bad, f"phase 17: first-step gradients off: {bad}")
        del params, grads, loss

        # nccl at data_parallel=1 under torchrun == no torch.distributed
        c, d = os.path.join(tmp, "c"), os.path.join(tmp, "d")
        nccl_args = common + ["--steps", str(NCCL_STEPS)]
        reset_counts()                           # the plain path starts here
        train.main(nccl_args + ["--device", "cuda", "--ckpt", d,
                                "--metrics-file", d + ".jsonl"])
        plain_counts = check_only(["train_stack.fwd_launches",
                                   "train_stack.bwd_launches"],
                                  "phase 17 plain run")
        nccl = _torchrun(1, nccl_args + [
            "--dist-backend", "nccl", "--ckpt", os.path.join(c, "ckpt"),
            "--metrics-file", os.path.join(c, "m.jsonl")], c)
        rank_counts(nccl[0], NCCL_STEPS, "phase 17 nccl")
        lc, ld = _losses(os.path.join(c, "m.jsonl")), _losses(d + ".jsonl")
        last = f"ckpt_{NCCL_STEPS:08d}.pt"
        pc = torch.load(os.path.join(c, "ckpt", last), weights_only=True)
        pd = torch.load(os.path.join(d, last), weights_only=True)
        check(lc == ld and all(torch.equal(pc["params"][k], pd["params"][k])
                               for k in pd["params"]),
              f"phase 17: nccl at data_parallel=1 ({lc}) differs from the "
              f"run without torch.distributed ({ld})")
    allreduce = []
    for rec in ranks:
        big = [s for n, s in rec["all_reduce"] if n >= (1 << 20)]
        allreduce.append({
            "all_reduce_ms_per_step":
                1e3 * sum(s for _, s in rec["all_reduce"]) / TRAIN_STEPS,
            "gradient_all_reduce_ms": 1e3 * sum(big) / max(len(big), 1),
            "gradient_bytes": max(n for n, _ in rec["all_reduce"]),
            "peak_device_memory_gb": rec["peak_bytes"] / 1e9,
            "launches": {k: v for k, v in rec["counts"].items() if v}})
    print(f"phase 17 data parallel, two ranks sharing one card over gloo "
          f"(not a scaling figure): train.main full B={TS_TRAIN_B} global "
          f"T={TS_T} steps={TRAIN_STEPS} ckpt_every={RESUME_AT} losses="
          f"{[la[s] for s in sorted(la)]} single_process_losses={ls} "
          f"rel_diff={rel} resume_bit_exact=True rank1_wrote_nothing=True "
          f"replicas_checked_equal_at_saves=3 ms_per_step={dp_ms} "
          f"single_process_ms_per_step={single['ms_per_step']} "
          f"launch_seconds={dp_s} ranks={allreduce} | first-step gradients "
          f"DP={DP_RANKS} vs one process, max|d|/max|g| per leaf (bf16-"
          f"rounded leaves {bf16_leaves} held to {DP_BF16_GRAD_TOL}, the "
          f"rest to {DP_GRAD_TOL}): {rels} loss={got['loss']} single="
          f"{single_loss} | nccl data_parallel=1 {NCCL_STEPS} steps under "
          f"torchrun == without torch.distributed (losses {lc}, params bit "
          f"for bit) launches={nccl[0]['counts']} plain={plain_counts} | "
          f"phase_seconds={time.monotonic() - phase_t} card={card!r}",
          flush=True)
    return {"dp_ms_per_step": dp_ms, "ranks": allreduce, "rel": rels}


# ---------------------------------------------------------------------------
# phase 18: generation and serving over the mesh
# ---------------------------------------------------------------------------

def _rank_ms(out: str) -> dict:
    """{rank: ms per step} from the generate CLI's rank lines."""
    import re
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"rank (\d+): .* = ([0-9.]+) ms per step", out)}


def _collective_ms(rec: dict, steps: int) -> float:
    return 1e3 * sum(s for key in ("all_reduce", "all_gather")
                     for _, s in rec[key]) / steps


def _mesh_ckpt(cfg, path: str, dev) -> None:
    """A checkpoint of cfg with seeded random weights (WaveNet.save)."""
    import torch
    from wavenet_tpu_torch.models.api import WaveNet
    WaveNet(cfg).init(torch.Generator().manual_seed(0), device=dev).save(path)


def _pcm_of(tokens) -> "np.ndarray":
    import numpy as np
    from wavenet_tpu_torch.audio import mulaw
    return (np.clip(mulaw.decode(tokens).cpu().numpy(), -1, 1)
            * 32767.0).astype("<i2")


class _MeshServer:
    """`python -m wavenet_tpu_torch.serve --ckpt` under torchrun, two gloo
    ranks on cuda:0 (DP=2), with the rank probe.  Started on entry (two
    servers start side by side, their start-ups overlapping); serve()
    POSTs every body at once after the server is up and returns (replies,
    served audio seconds per decode second over those requests); stop()
    interrupts rank 0 (which releases the follower), checks both ranks
    exit 0 and returns their probe records.  Leaving the block kills
    whatever is still running."""

    def __init__(self, ckpt: str, watch: str):
        self.ckpt, self.watch = ckpt, watch

    def __enter__(self):
        self._probe = tempfile.TemporaryDirectory()
        self.port = _free_port()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(MESH_RANKS), "-m",
               "wavenet_tpu_torch.serve", "--ckpt", self.ckpt,
               "--data-parallel", str(MESH_RANKS), "--dist-backend", "gloo",
               "--device", "cuda:0", "--port", str(self.port),
               "--max-batch", "8", "--max-wait-ms", "300",
               "--chunk-seconds", "0.1", "--length-quantum-seconds", "0.25",
               "--warmup-seconds", "0.01"]
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, env=_probe_env(self._probe.name, self.watch),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        self.lines, self._ready = [], threading.Event()
        self._t0 = time.monotonic()

        def read():
            for line in self.proc.stdout:
                self.lines.append(line)
                if line.startswith("serving "):
                    self.ready_s = time.monotonic() - self._t0
                    self._ready.set()

        self._reader = threading.Thread(target=read, daemon=True)
        self._reader.start()
        return self

    def _log(self) -> str:
        return "".join(self.lines)[-4000:]

    def serve(self, bodies) -> tuple:
        check(self._ready.wait(MESH_TIMEOUT_S),
              "phase 18: the mesh server did not come up:\n" + self._log())
        url = f"http://127.0.0.1:{self.port}"

        def info():
            with urllib.request.urlopen(url + "/info", timeout=60) as r:
                return json.loads(r.read())["stats"]
        before = info()
        replies = _concurrently(url, bodies)
        after = info()
        served = ((after["samples_out"] - before["samples_out"]) / 16000
                  / (after["decode_seconds"] - before["decode_seconds"]))
        return replies, served

    def stop(self) -> list:
        import signal
        head = next(x for x in self.lines if x.startswith("serving "))
        os.kill(int(head.rsplit("pid ", 1)[1].split(",")[0]), signal.SIGINT)
        rc = self.proc.wait(timeout=MESH_TIMEOUT_S)
        self._reader.join(30)
        check(rc == 0, f"phase 18: the mesh server exited {rc}:\n"
              + self._log())
        return _probe_records(self._probe.name, MESH_RANKS)

    def __exit__(self, *exc):
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self._probe.cleanup()


def _vocoder_bodies(vcfg, rs, prime) -> tuple:
    """Phase 18 (c)'s three mel requests of full_vocoder (0.2, 0.15 s and
    a primed 0.1 s) with random frames covering each timeline: (bodies,
    frames)."""
    import numpy as np
    hop, M = vcfg.mel.hop_length, vcfg.mel.num_mels
    bodies, mels = [], []
    for i, sec in enumerate((0.2, 0.15, 0.1)):
        span = len(prime) - 1 if i == 2 else 0
        frames = -(-(int(sec * 16000) + span) // hop)
        mel = rs.randn(frames, M).astype(np.float32)
        mels.append(mel)
        body = {"seconds": sec, "seed": 700 + i, "mel": mel.tolist()}
        if i == 2:
            body["prime"] = prime.tolist()
        bodies.append(body)
    return bodies, mels


def _mesh_lib_rank(rank: int, port: int, ckpt: str, out: str) -> None:
    """One rank of phase 18's library runs, two gloo ranks on cuda:0:
    (b) the collective loop at `full`, MP=2, with shard_rings_model, the
    first MESH_SRM_SAMPLES samples after an untimed 8-sample warm-up (a
    decode's prefix is a shorter decode's tokens; its collectives timed,
    the device synchronised around each); (d) the
    kernel fan-out at `fastgen_bench`, DP=2, B = 64.  Each rank saves its
    tokens, times and launch counts to out + rank."""
    import torch
    import torch.distributed as dist
    from wavenet_tpu_torch.config import fastgen_bench
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.ops.cuda import decode as pnarrow
    from wavenet_tpu_torch.ops.cuda import decode_wide as pwide
    from wavenet_tpu_torch.parallel import distdecode, distributed
    from wavenet_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    distributed.initialize("gloo", device=dev, rank=rank,
                           world_size=MESH_RANKS,
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        register_counters(pnarrow, pwide)
        rec = {"collective_s": 0.0}
        real = {k: getattr(dist, k) for k in ("all_reduce", "all_gather")}

        def timed(fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                rec["collective_s"] += time.perf_counter() - t
                return r
            return call

        model = WaveNet.from_checkpoint(ckpt, device=dev)
        cfg = model.cfg
        mesh = make_mesh(cfg.replace(data_parallel=1,
                                     model_parallel=MESH_RANKS), "cuda")
        n = MESH_SRM_SAMPLES
        w = model.decode_weights()
        distdecode.generate_sharded(w, cfg, mesh, GEN_SEED, 8, MESH_MP_BATCH,
                                    shard_rings_model=True, device=dev)
        for k, fn in real.items():
            setattr(dist, k, timed(fn))
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = distdecode.generate_sharded(
            w, cfg, mesh, GEN_SEED, n, MESH_MP_BATCH,
            shard_rings_model=True, device=dev).cpu()
        rec["mp_ms"] = 1e3 * (time.perf_counter() - t) / n
        rec["mp_collective_ms"] = 1e3 * rec["collective_s"] / n
        for k, fn in real.items():
            setattr(dist, k, fn)
        rec["mp_counts"] = {k: c.value for k, c in COUNTERS.items()
                            if c.value}
        rec["mp_tokens"] = toks

        fcfg = fastgen_bench()
        fmodel = WaveNet(fcfg).init(torch.Generator().manual_seed(0),
                                    device=dev)
        dmesh = make_mesh(fcfg.replace(data_parallel=MESH_RANKS), "cuda")
        nf = int(MESH_FAST_SECONDS * fcfg.sample_rate)
        w = fmodel.decode_weights()
        sampler.generate_distributed(w, fcfg, dmesh, GEN_SEED, 64,
                                     MESH_FAST_BATCH, device=dev)  # warm
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ftoks = sampler.generate_distributed(w, fcfg, dmesh, GEN_SEED, nf,
                                             MESH_FAST_BATCH, device=dev)
        ftoks = ftoks.cpu()
        rec["dp_fast_ms"] = 1e3 * (time.perf_counter() - t) / nf
        rec["dp_fast_counts"] = {k: c.value for k, c in COUNTERS.items()
                                 if c.value}
        rec["dp_fast_tokens"] = ftoks
        torch.save(rec, f"{out}{rank}")
    finally:
        distributed.shutdown()


def phase_mesh(dev, card: str) -> dict:
    """Phase 18: generation and serving over the mesh, two gloo ranks
    sharing cuda:0 (correctness and launches, not scaling): (a) the
    generate CLI at DP=2, `full`, B = 8, 0.5 s: wavs equal the single
    process's, decode_wide launched on each rank; (b) the generate CLI at
    MP=2, `full`, B = 4, 0.025 s: wavs equal the single-process kernel
    decode's, no kernel launched, each rank's ms per step and collective
    ms per step, and the library's collective loop with shard_rings_model
    equal to the kernel decode's first MESH_SRM_SAMPLES samples;
    (c) the serve CLI at DP=2: `full` (four requests of mixed lengths on
    the batchable lane beside a primed one on the conditioned lane) and
    `full_vocoder` (three mel requests, one primed), each equal to its
    single-process replay, the served realtime factor; (d) the kernel
    fan-out at `fastgen_bench`, DP=2, B = 64 through the narrow kernel,
    equal to one process's decode.  Returns each rank's launches."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from wavenet_tpu_torch.audio import mulaw
    from wavenet_tpu_torch.config import fastgen_bench, full, full_vocoder
    from wavenet_tpu_torch.generate import __main__ as generate
    from wavenet_tpu_torch.generate.sampler import batch_paths, generate_auto
    from wavenet_tpu_torch.models.api import WaveNet
    phase_t = time.monotonic()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck, vck = os.path.join(tmp, "full"), os.path.join(tmp, "voc")
        _mesh_ckpt(full(), ck, dev)
        _mesh_ckpt(full_vocoder(), vck, dev)
        mesh_args = ["--ckpt", ck, "--seed", str(GEN_SEED), "--dist-backend",
                     "gloo", "--device", "cuda:0"]

        # (a) DP=2 against one process
        one = ["--ckpt", ck, "--seed", str(GEN_SEED), "--device", "cuda"]
        a_args = ["--seconds", str(MESH_DP_SECONDS), "--batch",
                  str(MESH_DP_BATCH)]
        single = os.path.join(tmp, "single.wav")
        generate.main(one + a_args + ["--out", single])
        out, dpw = [], os.path.join(tmp, "dp.wav")
        ranks_a = _torchrun(MESH_RANKS, mesh_args + a_args + [
            "--out", dpw, "--data-parallel", str(MESH_RANKS)], tmp,
            module="wavenet_tpu_torch.generate", output=out)
        check(_wav_bytes(batch_paths(dpw, MESH_DP_BATCH))
              == _wav_bytes(batch_paths(single, MESH_DP_BATCH)),
              "phase 18 (a): DP=2 wavs differ from one process's")
        check(out[0].count("route decode_wide") == MESH_RANKS,
              f"phase 18 (a): a rank took another route:\n{out[0][-2000:]}")
        for r, rec in enumerate(ranks_a):
            got = {k: v for k, v in rec["counts"].items() if v}
            check(got == {"decode_wide.launches": 1},
                  f"phase 18 (a) rank {r}: launches {got}")
        res["a"] = {"ms_per_step": _rank_ms(out[0]),
                    "launches": [r["counts"]["decode_wide.launches"]
                                 for r in ranks_a]}

        # (b) MP=2 against the single-process kernel decode
        b_args = ["--seconds", str(MESH_MP_SECONDS), "--batch",
                  str(MESH_MP_BATCH)]
        single_b = os.path.join(tmp, "single_b.wav")
        kernel_toks = generate.main(one + b_args + ["--out", single_b])
        out, mpw = [], os.path.join(tmp, "mp.wav")
        ranks_b = _torchrun(MESH_RANKS, mesh_args + b_args + [
            "--out", mpw, "--model-parallel", str(MESH_RANKS)], tmp,
            module="wavenet_tpu_torch.generate", output=out)
        check(_wav_bytes(batch_paths(mpw, MESH_MP_BATCH))
              == _wav_bytes(batch_paths(single_b, MESH_MP_BATCH)),
              "phase 18 (b): MP=2 wavs differ from the kernel decode's")
        for r, rec in enumerate(ranks_b):
            check(not any(rec["counts"].values()),
                  f"phase 18 (b) rank {r}: a kernel launched "
                  f"{rec['counts']}")
        n_b = int(MESH_MP_SECONDS * 16000)
        res["b"] = {"ms_per_step": _rank_ms(out[0]),
                    "collective_ms_per_step": [
                        _collective_ms(rec, n_b) for rec in ranks_b],
                    "all_reduce_calls_per_step": [
                        len(rec["all_reduce"]) / n_b for rec in ranks_b]}

        # (b) through the library with shard_rings_model, and (d)
        lib = os.path.join(tmp, "lib")
        ctx = mp.start_processes(_mesh_lib_rank,
                                 args=(_free_port(), ck, lib),
                                 nprocs=MESH_RANKS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + MESH_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      "phase 18: the library ranks ran past their limit")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        lib_recs = [torch.load(f"{lib}{r}", weights_only=False)
                    for r in range(MESH_RANKS)]
        for r, rec in enumerate(lib_recs):
            check(np.array_equal(rec["mp_tokens"].numpy(),
                                 kernel_toks[:, :MESH_SRM_SAMPLES]),
                  f"phase 18 (b) rank {r}: shard_rings_model tokens differ "
                  f"from the kernel decode's")
            check(not rec["mp_counts"], f"phase 18 (b) rank {r}: "
                  f"{rec['mp_counts']}")
            check(rec["dp_fast_counts"] == {"decode.launches": 1},
                  f"phase 18 (d) rank {r}: launches {rec['dp_fast_counts']}")
        fcfg = fastgen_bench()
        fmodel = WaveNet(fcfg).init(torch.Generator().manual_seed(0),
                                    device=dev)
        want = generate_auto(fmodel.decode_weights(), fcfg,
                             int(MESH_FAST_SECONDS * fcfg.sample_rate),
                             batch=MESH_FAST_BATCH, seeds=GEN_SEED,
                             device=dev).cpu()
        for r, rec in enumerate(lib_recs):
            check(torch.equal(rec["dp_fast_tokens"], want),
                  f"phase 18 (d) rank {r}: DP=2 tokens differ from one "
                  f"process's")
        del fmodel
        res["b"]["library_srm"] = {
            "ms_per_step": [rec["mp_ms"] for rec in lib_recs],
            "collective_ms_per_step": [rec["mp_collective_ms"]
                                       for rec in lib_recs]}
        res["d"] = {"ms_per_step": [rec["dp_fast_ms"] for rec in lib_recs],
                    "launches": [rec["dp_fast_counts"]["decode.launches"]
                                 for rec in lib_recs]}

        # (c) the serve CLI, DP=2: full, then full_vocoder (both servers
        # start together)
        rs = np.random.RandomState(18)
        prime = (rs.rand(int(PRIME_SECONDS * 16000)) * 0.2 - 0.1).astype(
            np.float32)
        bodies = [{"seconds": s, "seed": 500 + i}
                  for i, s in enumerate(MESH_SERVE_SECONDS)]
        bodies.append({"seconds": 0.1, "seed": 600,
                       "prime": prime.tolist()})
        with _MeshServer(ck, tmp) as srv, _MeshServer(vck, tmp) as vsrv:
            replies, served = srv.serve(bodies)
            ranks_c = srv.stop()
            vb, mels = _vocoder_bodies(full_vocoder(), rs, prime)
            vreplies, vserved = vsrv.serve(vb)
            ranks_v = vsrv.stop()
        model = WaveNet.from_checkpoint(ck, device=dev)
        lengths = [int(b["seconds"] * 16000) for b in bodies]
        pcm = _pcm(bodies, lengths, replies, 16000)
        for i, (body, got) in enumerate(zip(bodies, pcm)):
            kw = {}
            if "prime" in body:
                kw["prime_tokens"] = mulaw.encode_np(prime)[None]
            want = model.generate(num_samples=lengths[i],
                                  seeds=[body["seed"]], **kw)[0]
            check(np.array_equal(got, _pcm_of(want)),
                  f"phase 18 (c) full: request {i} differs from its "
                  f"single-process replay")
        for r, rec in enumerate(ranks_c):
            got = {k: v for k, v in rec["counts"].items() if v}
            check(set(got) == {"decode_wide.launches"},
                  f"phase 18 (c) full rank {r}: launches {got}")
        del model
        vmodel = WaveNet.from_checkpoint(vck, device=dev)
        vlen = [int(b["seconds"] * 16000) for b in vb]
        vpcm = _pcm(vb, vlen, vreplies, 16000)
        for i, (body, got) in enumerate(zip(vb, vpcm)):
            kw = {}
            if "prime" in body:
                kw["prime_tokens"] = mulaw.encode_np(prime)[None]
            want = vmodel.generate(num_samples=vlen[i], seeds=[body["seed"]],
                                   mel=mels[i][None], **kw)[0]
            check(np.array_equal(got, _pcm_of(want)),
                  f"phase 18 (c) full_vocoder: request {i} differs from "
                  f"its single-process replay")
        for r, rec in enumerate(ranks_v):
            got = {k: v for k, v in rec["counts"].items() if v}
            check(set(got) == {"decode_wide.mel_launches"},
                  f"phase 18 (c) full_vocoder rank {r}: launches {got}")
        del vmodel
        res["c"] = {"full_realtime_factor": served,
                    "full_vocoder_realtime_factor": vserved,
                    "full_launches": [r["counts"]["decode_wide.launches"]
                                      for r in ranks_c],
                    "full_vocoder_launches": [
                        r["counts"]["decode_wide.mel_launches"]
                        for r in ranks_v],
                    "ready_seconds": [srv.ready_s, vsrv.ready_s]}
    print(f"phase 18 generation and serving over the mesh, two gloo ranks "
          f"sharing one card (not a scaling figure): (a) generate CLI full "
          f"DP={MESH_RANKS} B={MESH_DP_BATCH} {MESH_DP_SECONDS}s wavs equal "
          f"one process's, route decode_wide on each rank: {res['a']} | (b) "
          f"generate CLI full MP={MESH_RANKS} B={MESH_MP_BATCH} "
          f"{MESH_MP_SECONDS}s wavs equal the kernel decode's, no kernel "
          f"launched, library shard_rings_model tokens equal: {res['b']} | "
          f"(c) serve CLI DP={MESH_RANKS}, every response equal to its "
          f"single-process replay: {res['c']} | (d) fastgen_bench DP="
          f"{MESH_RANKS} B={MESH_FAST_BATCH} {MESH_FAST_SECONDS}s through "
          f"the narrow kernel, tokens equal one process's: {res['d']} | "
          f"phase_seconds={time.monotonic() - phase_t} card={card!r}",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 19: training over the mesh's seq and model axes
# ---------------------------------------------------------------------------

def phase_seqmodel(ts, dev, card: str, single: dict) -> dict:
    """Phase 19: train.main under torchrun, two gloo ranks on cuda:0, at
    `full`, B = 8, T = 8192 for SEQMODEL_STEPS steps, (a) over seq = 2
    through overlap-discard and (b) over model = 2 through the layer
    pipeline (microbatches of SEQMODEL_MICROBATCH rows), both on the
    train_stack kernels: the step-1 loss and the first step's gradients
    (reduced, gathered whole) against one process's with the same layer
    groups (the residual is rounded to bf16 at group edges: the
    pipeline's stage boundary is a group edge that the one-process plan
    lacks, so that process runs the stages' plan, as the reference's
    pipeline tests align the plans), each rank's stack launches against
    the route's formula (no other kernel), ms per step, collective ms per
    step (the device synchronised around each exchange) and peak memory
    per rank."""
    import torch
    from wavenet_tpu_torch import train
    from wavenet_tpu_torch.models import wavenet as wn
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.parallel import pipeline
    from wavenet_tpu_torch.utils.pytree_io import flatten_tree
    phase_t = time.monotonic()
    common = ["--preset", "full", "--synthetic", "--batch-size",
              str(TS_TRAIN_B), "--override", f"train_window={TS_T}",
              "--log-every", "1", "--steps", str(SEQMODEL_STEPS)]
    cfg = train.build_config(train.parse_args(common))
    L, TT = cfg.num_layers, ts.pick_tile(cfg, TS_T)
    plan = ts.group_plan(cfg, TT)
    Ls = L // 2
    stage = ts.plan_dils(cfg, pipeline.stage_dilations(cfg, 2), TT)
    staged = [(lo + s * Ls, hi + s * Ls) for s in range(2) for lo, hi in stage]
    n_mu = TS_TRAIN_B // SEQMODEL_MICROBATCH

    def one_process(groups):
        """One process's first-step loss and gradients (phase 17's batch
        and params) through the stack with these layer groups."""
        torch.cuda.empty_cache()
        scfg, toks = _first_batch()
        params = {k: v.requires_grad_(True) for k, v in wn.init_params(
            scfg, torch.Generator().manual_seed(scfg.seed), dev).items()}
        keep = ts.group_plan
        ts.group_plan = lambda c, t: list(groups)
        try:
            loss, _ = wn.loss_fn(params, scfg, toks.to(dev), use_fused=True)
        finally:
            ts.group_plan = keep
        keys = sorted(params)
        grads = {k: g.detach().cpu() for k, g in zip(
            keys, torch.autograd.grad(loss, [params[k] for k in keys]))}
        out = float(loss.detach()), grads
        del params, loss
        torch.cuda.empty_cache()
        return out

    routes = {
        "seq=2 overlap-discard": (
            ["--override", "seq_parallel=2"], plan,
            {"train_stack.fwd_launches": L + len(plan),
             "train_stack.bwd_launches": 7 * L + len(plan)}),
        "model=2 pipeline": (
            ["--override", "model_parallel=2", "--override",
             f"pipeline_microbatch={SEQMODEL_MICROBATCH}"], staged,
            {"train_stack.fwd_launches": n_mu * (Ls + len(stage)),
             "train_stack.bwd_launches": n_mu * (7 * Ls + len(stage))})}
    results = {}
    for name, (extra, groups, per_step) in routes.items():
        ref_loss, want = one_process(groups)
        with tempfile.TemporaryDirectory() as tmp:
            metrics = os.path.join(tmp, "m.jsonl")
            grads = os.path.join(tmp, "grads.pt")
            ckpt = os.path.join(tmp, "ckpt")
            ranks = _torchrun(2, common + extra + [
                "--dist-backend", "gloo", "--device", "cuda:0",
                "--metrics-file", metrics, "--ckpt", ckpt], tmp,
                env={"WAVENET_PROBE_GRADS": grads})
            losses = _losses(metrics)
            got = torch.load(grads, weights_only=True)
            # the checkpoint holds the whole model: it loads in this
            # process and decodes through the wide kernel
            model = WaveNet.from_checkpoint(ckpt, device=dev)
            check(sorted(flatten_tree(model.params)) == sorted(want),
                  f"phase 19 {name}: the checkpoint's leaves")
            decoded = model.generate(num_samples=SEQMODEL_DECODE, seed=1)
            check(tuple(decoded.shape) == (1, SEQMODEL_DECODE),
                  f"phase 19 {name}: decoded {tuple(decoded.shape)}")
            del model
        wantc = {k: v * SEQMODEL_STEPS for k, v in per_step.items()}
        rel_loss = abs(losses[1] - ref_loss) / abs(ref_loss)
        check(rel_loss <= SEQMODEL_LOSS_TOL,
              f"phase 19 {name}: step-1 loss {losses[1]} vs one process "
              f"{ref_loss}")
        check(sorted(got) == sorted(want), f"phase 19 {name}: leaves")
        rels = {k: float((got[k] - g).abs().max() / g.abs().max())
                for k, g in want.items()}
        bad = {k: v for k, v in rels.items() if v > SEQMODEL_GRAD_TOL}
        check(not bad, f"phase 19 {name}: first-step gradients off: {bad}")
        per_rank = []
        for r, rec in enumerate(ranks):
            launched = {k: v for k, v in rec["counts"].items() if v}
            check(launched == wantc, f"phase 19 {name} rank {r}: launches "
                                     f"{launched}, expected {wantc}")
            timed = rec["steps"][1:]             # the first step excluded
            per_rank.append({
                "ms_per_step": 1e3 * sum(w for w, _ in timed) / len(timed),
                "collective_ms_per_step":
                    1e3 * sum(c for _, c in timed) / len(timed),
                "peak_device_memory_gb": rec["peak_bytes"] / 1e9,
                "launches_per_step": {k: v // SEQMODEL_STEPS
                                      for k, v in launched.items()}})
        results[name] = {"losses": [losses[s] for s in sorted(losses)],
                         "rel_loss": rel_loss, "grad_rel": rels,
                         "ranks": per_rank}
        print(f"phase 19 {name}, two ranks sharing one card over gloo (not "
              f"a scaling figure): train.main full B={TS_TRAIN_B} T={TS_T} "
              f"steps={SEQMODEL_STEPS} losses={results[name]['losses']} "
              f"one_process_step1={ref_loss} with groups {groups} step1_rel="
              f"{rel_loss} (band {SEQMODEL_LOSS_TOL}; phase 5's step 1 with "
              f"groups {plan}: {single['losses'][0]}) first-step gradients "
              f"max|d|/max|g| per leaf (band {SEQMODEL_GRAD_TOL}): {rels} "
              f"ranks={per_rank} single_process_ms_per_step="
              f"{single['ms_per_step']} checkpoint_loaded_in_one_process_"
              f"and_decoded={SEQMODEL_DECODE} card={card!r}", flush=True)
    print(f"phase 19 seconds={time.monotonic() - phase_t}", flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 20: deployment artifacts (serving/aot.py) and the kernel build cache

_AOT_WORKER = ("import sys; sys.path.insert(0, sys.argv[1]); "
               "import chip_smoke; "
               "sys.exit(chip_smoke.aot_worker(sys.argv[2:]))")


def aot_worker(argv) -> int:
    """Phase 20's fresh process: loads each artifact of --spec (a JSON
    list) with load_decoder and decodes it `calls` times, the counts set
    to 0 before the first call and read after the last; or, for a spec of
    kind "facade", WaveNet.from_checkpoint plus generate.  Prints one line
    "AOT_WORKER {json}": per spec its seconds, counts and ms per step, the
    wall clock (time.time()) on entry, once the device is ready, after
    the first load and at the first tokens on the host, and whether
    models/api.py was imported."""
    marks = {"entered": time.time()}
    import argparse

    import numpy as np
    import torch
    from wavenet_tpu_torch.utils import compcache
    p = argparse.ArgumentParser()
    p.add_argument("--spec", required=True)
    p.add_argument("--out", required=True)
    compcache.add_cli_flag(p)
    args = p.parse_args(argv)
    compcache.enable_from_args(args)
    from wavenet_tpu_torch.ops.cuda import decode as pnarrow
    from wavenet_tpu_torch.ops.cuda import decode_wide as pwide
    register_counters(pnarrow, pwide)
    specs = json.loads(args.spec)
    if specs[0]["device"] == "cuda":
        torch.zeros(1, device="cuda")            # the CUDA context
    marks["ready"] = time.time()
    results = {}
    for spec in specs:
        t = time.monotonic()
        if spec.get("kind") == "facade":
            from wavenet_tpu_torch.models.api import WaveNet
            model = WaveNet.from_checkpoint(spec["ckpt"],
                                            device=spec["device"])
            run = functools.partial(
                model.generate, num_samples=spec["num_samples"],
                batch=spec["batch"], seed=spec["seed"])
            n = spec["num_samples"]
        else:
            from wavenet_tpu_torch.serving import load_decoder
            dec = load_decoder(spec["path"], device=spec["device"])
            mel = None if spec.get("mel") is None else np.load(spec["mel"])
            run = functools.partial(dec.generate, seed=spec["seed"], mel=mel,
                                    speaker=spec.get("speaker"))
            n = dec.num_samples
        load_s = time.monotonic() - t
        marks.setdefault("loaded", time.time())
        reset_counts()
        call_s, toks = [], None
        for _ in range(spec["calls"]):
            t = time.monotonic()
            toks = run().cpu()                   # read back: synchronised
            call_s.append(time.monotonic() - t)
            marks.setdefault("first_tokens", time.time())
        if toks is not None:
            np.save(os.path.join(args.out, spec["name"] + ".npy"),
                    toks.numpy())
        results[spec["name"]] = {
            "load_s": load_s, "call_s": call_s,
            "ms_per_step": 1e3 * call_s[-1] / n if call_s else None,
            "counts": {k: c.value for k, c in COUNTERS.items() if c.value}}
    results["marks"] = marks
    results["facade_imported"] = "wavenet_tpu_torch.models.api" in sys.modules
    print("AOT_WORKER " + json.dumps(results), flush=True)
    return 0


class _AotProcess:
    """aot_worker in a fresh process (the leader of its own process group),
    started at construction.  result() waits for it and returns (its
    results, seconds from the spawn to its first tokens, those seconds
    split into the interpreter's start, imports and the CUDA context, the
    first load and the first call); close() kills it if it still runs."""

    def __init__(self, specs, out: str, *extra):
        self.spawned = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _AOT_WORKER, ROOT, "--spec",
             json.dumps(specs), "--out", out, *extra], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)

    def result(self) -> tuple:
        try:
            text, _ = self.proc.communicate(timeout=AOT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.close()
            raise AssertionError(f"phase 20: a worker ran past "
                                 f"{AOT_TIMEOUT_S} s")
        check(self.proc.returncode == 0, f"phase 20: a worker exited "
                                         f"{self.proc.returncode}:\n"
                                         f"{text[-4000:]}")
        line = [ln for ln in text.splitlines()
                if ln.startswith("AOT_WORKER ")]
        check(len(line) == 1, f"phase 20: the worker printed no result:\n"
                              f"{text[-4000:]}")
        res = json.loads(line[0][len("AOT_WORKER "):])
        m = res["marks"]
        split = {"start_s": m["entered"] - self.spawned,
                 "imports_and_context_s": m["ready"] - m["entered"],
                 "load_s": m["loaded"] - m["ready"],
                 "first_call_s": m["first_tokens"] - m["loaded"]}
        return res, m["first_tokens"] - self.spawned, split

    def close(self) -> None:
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()


def _aot_checks(dev, ck: str, paths: dict, tmp: str, out: str) -> tuple:
    """Phase 20 (a)-(e) and (f) (i)-(ii): the library exports, the
    facade's tokens and times, one fresh process loading every artifact,
    and one fresh process through WaveNet.from_checkpoint.  Returns (the
    numbers by artifact, (i)'s seconds and split, (ii)'s)."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.config import fastgen_bench, full, full_vocoder
    from wavenet_tpu_torch.generate.sampler import kernel_module
    from wavenet_tpu_torch.models import wavenet as wn
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.serving import export_decoder
    gen = torch.Generator
    names = {"a": "full", "b": "fastgen_bench", "c": "full_vocoder",
             "d": f"full+{SPEAKERS} speakers"}
    models = {"a": (WaveNet.from_checkpoint(ck, device=dev), B, {})}
    fcfg = fastgen_bench()
    models["b"] = (WaveNet(fcfg, wn.init_params(
        fcfg, gen().manual_seed(0), dev)), NARROW_B, {})
    vcfg = full_vocoder()
    frames = -(-int(AOT_SECONDS * vcfg.sample_rate) // vcfg.mel.hop_length)
    mel = np.random.RandomState(20).normal(
        size=(B, frames, vcfg.mel.num_mels)).astype(np.float32)
    np.save(os.path.join(tmp, "mel.npy"), mel)
    models["c"] = (WaveNet(vcfg, wn.init_params(
        vcfg, gen().manual_seed(0), dev)), B, {"mel": mel})
    scfg = full().replace(global_classes=SPEAKERS)
    ids = [(37 * i + 5) % SPEAKERS for i in range(B)]
    models["d"] = (WaveNet(scfg, wn.init_params(
        scfg, gen().manual_seed(0), dev)), B, {"speaker": ids})
    reset_counts()
    for k in "bcd":
        m, batch, _ = models[k]
        export_decoder(m.params, m.cfg, paths[k],
                       num_samples=int(AOT_SECONDS * m.cfg.sample_rate),
                       batch=batch)
    check_only([], "phase 20 export")

    facade = {}
    for k, (m, batch, kw) in models.items():
        n = int(AOT_SECONDS * m.cfg.sample_rate)
        seconds = []
        for _ in range(2):
            t = time.monotonic()
            want = m.generate(num_samples=n, batch=batch, seed=AOT_SEED,
                              **kw).cpu().numpy()
            seconds.append(time.monotonic() - t)
        facade[k] = (want, 1e3 * seconds[-1] / n)
    e_want = models["a"][0].generate(num_samples=AOT_CPU_SAMPLES, batch=1,
                                     seed=AOT_SEED).cpu().numpy()

    specs = [{"name": k, "path": paths[k], "device": dev.type,
              "seed": AOT_SEED, "calls": 2,
              "mel": os.path.join(tmp, "mel.npy") if k == "c" else None,
              "speaker": ids if k == "d" else None} for k in "abcd"]
    specs += [{"name": "e_cuda", "path": paths["e"], "device": dev.type,
               "seed": AOT_SEED, "calls": 1},
              {"name": "e_cpu", "path": paths["e"], "device": "cpu",
               "seed": AOT_SEED, "calls": 1},
              {"name": "a_cpu", "path": paths["a"], "device": "cpu",
               "seed": AOT_SEED, "calls": 0}]
    res, cold_aot, split_aot = _AotProcess(specs, out).result()
    check(not res["facade_imported"],
          "phase 20: loading an artifact imported models/api.py")
    numbers = {}
    for k, (m, batch, _) in models.items():
        n = int(AOT_SECONDS * m.cfg.sample_rate)
        got = np.load(os.path.join(out, f"{k}.npy"))
        check(got.shape == (batch, n) and np.array_equal(got, facade[k][0]),
              f"phase 20 ({k}): the artifact's tokens differ from the "
              f"facade's")
        counter = counter_name(kernel_module(m.cfg, dev), m.cfg)
        check(res[k]["counts"] == {counter: 2},
              f"phase 20 ({k}): two artifact calls launched "
              f"{res[k]['counts']}, expected {{{counter!r}: 2}}")
        numbers[k] = {"model": names[k], "batch": batch, "kernel": counter,
                      "launches_per_call":
                          res[k]["counts"].get(counter, 0) / 2,
                      "artifact_ms_per_step": res[k]["ms_per_step"],
                      "facade_ms_per_step": facade[k][1],
                      "artifact_load_s": res[k]["load_s"],
                      "artifact_first_call_s": res[k]["call_s"][0]}
    e_cpu = np.load(os.path.join(out, "e_cpu.npy"))
    e_cuda = np.load(os.path.join(out, "e_cuda.npy"))
    check(np.array_equal(e_cpu, e_cuda) and np.array_equal(e_cuda, e_want),
          "phase 20 (e): the CPU load's tokens differ from the card's")
    check(not res["e_cpu"]["counts"] and res["e_cuda"]["counts"] ==
          {"decode_wide.launches": 1} and not res["a_cpu"]["counts"],
          f"phase 20 (e): launches {res['e_cpu']['counts']} (cpu), "
          f"{res['e_cuda']['counts']} (cuda)")

    _, cold_facade, split_facade = _AotProcess(
        [{"name": "f", "kind": "facade", "ckpt": ck, "seed": AOT_SEED,
          "device": dev.type,
          "num_samples": int(AOT_SECONDS * models["a"][0].cfg.sample_rate),
          "batch": B, "calls": 1}], out).result()
    check(np.array_equal(np.load(os.path.join(out, "f.npy")),
                         np.load(os.path.join(out, "a.npy"))),
          "phase 20 (f): the facade process's tokens differ")
    return numbers, cold_aot, split_aot, cold_facade, split_facade


def phase_aot(dev, card: str) -> dict:
    """Phase 20: deployment artifacts.  (a) `full` at AOT_SECONDS, B = 4,
    exported through the generate CLI's --export-aot from a checkpoint of
    the seeded random weights; (b) `fastgen_bench` at B = 64 (the narrow
    kernel), (c) `full_vocoder` with a static mel covering AOT_SECONDS and
    (d) `full` with SPEAKERS speakers, exported by export_decoder.  One
    fresh process loads each with load_decoder(device="cuda") and decodes
    it twice: tokens equal to the facade's generate at the same seed bit
    for bit, one launch of the right kernel variant per call, ms per step
    beside the facade's (each the second of two calls), models/api.py
    never imported.  (e) a 64-sample B = 1 export of (a)'s checkpoint
    decoded on the CPU (load_decoder(device="cpu"), the program moved off
    the card) and on the card: equal; (a)'s artifact passes the CPU
    platform check.  (f) cold start, seconds from a fresh process to the
    first tokens: (i) load_decoder (the first process above), (ii)
    WaveNet.from_checkpoint + generate, both with the build cache warm,
    (iii) load_decoder of (e)'s artifact with --compile-cache at an empty
    directory (the decode_wide build included), a process that runs
    beside all of the above, so the phase does not wait for its nvcc."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.config import full
    from wavenet_tpu_torch.generate import __main__ as generate
    from wavenet_tpu_torch.models import wavenet as wn
    from wavenet_tpu_torch.models.api import WaveNet
    phase_t = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ckpt")
        cfg = full()
        WaveNet(cfg, wn.init_params(cfg, torch.Generator().manual_seed(0),
                                    dev)).save(ck)
        paths = {k: os.path.join(tmp, f"{k}.wnx") for k in "abcde"}
        reset_counts()                           # the export launches nothing
        generate.main(["--ckpt", ck, "--seconds", str(AOT_SECONDS),
                       "--batch", str(B), "--export-aot", paths["a"],
                       "--device", str(dev)])
        generate.main(["--ckpt", ck, "--seconds",
                       str(AOT_CPU_SAMPLES / cfg.sample_rate), "--batch",
                       "1", "--export-aot", paths["e"], "--device",
                       str(dev)])
        check_only([], "phase 20 export")
        out = os.path.join(tmp, "out")
        os.makedirs(out)
        empty = os.path.join(tmp, "empty_cache")
        # (iii): nvcc builds decode_wide into an empty cache while the rest
        # of the phase runs beside it (its one decode: 64 steps of one row)
        build = _AotProcess([{"name": "e_cold", "path": paths["e"],
                              "device": dev.type, "seed": AOT_SEED,
                              "calls": 1}], out, "--compile-cache", empty)
        try:
            numbers, cold_aot, split_aot, cold_facade, split_facade = \
                _aot_checks(dev, ck, paths, tmp, out)
            cold, cold_build, split_build = build.result()
        finally:
            build.close()
        built = sorted(os.listdir(empty))
        check(len(built) == 1 and built[0].startswith("libdecode_wide-"),
              f"phase 20 (f): the empty cache holds {built}")
        check(cold["e_cold"]["counts"] == {"decode_wide.launches": 1},
              f"phase 20 (f): launches {cold['e_cold']['counts']}")
        check(np.array_equal(np.load(os.path.join(out, "e_cold.npy")),
                             np.load(os.path.join(out, "e_cuda.npy"))),
              "phase 20 (f): the empty cache's tokens differ")
    cold_start = {"load_decoder_s": cold_aot, "split": split_aot,
                  "from_checkpoint_s": cold_facade, "split_facade":
                  split_facade, "load_decoder_empty_cache_s": cold_build,
                  "split_empty_cache": split_build}
    print(f"phase 20 aot: artifacts vs the facade at seed {AOT_SEED}, "
          f"{AOT_SECONDS} s each (full B={B}, fastgen_bench B={NARROW_B}, "
          f"full_vocoder B={B} with a static mel, full + {SPEAKERS} "
          f"speakers B={B}): tokens_equal=True "
          f"facade_imported_in_loader=False {json.dumps(numbers)} | (e) "
          f"{AOT_CPU_SAMPLES} samples B=1 cpu == cuda == facade: True | (f) "
          f"cold start, seconds from a fresh process to the first tokens "
          f"((iii) with the 64-sample artifact, beside the rest of the "
          f"phase): {json.dumps(cold_start)} | phase_seconds="
          f"{time.monotonic() - phase_t} card={card!r}", flush=True)
    return {"numbers": numbers, "cold_start": cold_start}


# ---------------------------------------------------------------------------
# phase 21: the widths the stack kernels take since their layer blocks were
# row-tiled and their operands padded
# ---------------------------------------------------------------------------

def width_cases():
    """(name, config, its layer groups at T = 8192, the (forward,
    backward) row tile) of each width phase 21 checks: each refused by the
    kernels before, each fused by the reference (one with speakers)."""
    from wavenet_tpu_torch.config import MelConfig, full, tiny
    return (("full R=256", full().replace(residual_channels=256), 40,
             (64, 32)),
            ("full S=1024", full().replace(skip_channels=1024), 14, (64, 32)),
            ("tiny 80 mels", tiny().replace(mel=MelConfig()), 1, (64, 64)),
            ("full R=30 S=18 speakers", full().replace(
                residual_channels=30, skip_channels=18,
                global_classes=SPEAKERS), 1, (64, 64)))


def row_tiles_equal(ts, wn, dev, card: str) -> dict:
    """`full`'s first layer group (9 layers) at [TS_TRAIN_B, TS_T] through
    the kernels at each row tile: every tile's forward and backward equal
    the 64-row ones bit for bit; each tile's forward and backward ms."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.config import full
    cfg = full()
    params = wn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    lo, hi = ts.group_plan(cfg, ts.pick_tile(cfg, TS_T))[0]
    dils = tuple(cfg.dilations[lo:hi])
    ops = ts.prep_weights(*(params[k][lo:hi] for k in ts.GROUP_KEYS))
    rs = np.random.RandomState(21)
    toks = torch.from_numpy(rs.randint(0, cfg.quantization_channels, (
        TS_TRAIN_B, TS_T)).astype(np.int32)).to(dev)
    with torch.no_grad():
        x = wn.embed_tokens(params, cfg, toks,
                            wn._shifted_tokens(toks)).contiguous()
        skip = torch.zeros(TS_TRAIN_B, TS_T, cfg.skip_channels, device=dev)
        dskip = torch.from_numpy(rs.randn(TS_TRAIN_B, TS_T, cfg.skip_channels)
                                 .astype(np.float32) * 1e-4).to(dev)
        dxo = torch.zeros_like(x)
        ms, want = {}, None
        for rows in ts.ROW_TILES:
            kf = ts.group_fwd(x, skip, ops, dils, rows=rows)
            got = kf + ts.group_bwd(kf[2], dskip, dxo, ops, dils, rows=rows)
            if want is None:
                want = got
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{rows} rows differ from 64 rows")
            ms[rows] = (cuda_ms(lambda: ts.group_fwd(x, skip, ops, dils,
                                                     rows=rows), 3),
                        cuda_ms(lambda: ts.group_bwd(kf[2], dskip, dxo, ops,
                                                     dils, rows=rows), 3))
            del kf, got
    print(f"phase 21 row tiles: full group {(lo, hi)} B={TS_TRAIN_B} "
          f"T={TS_T}, forward and backward at 32 and 16 rows equal to 64 "
          f"rows bit for bit; (fwd_ms, bwd_ms) by rows {ms} card={card!r}",
          flush=True)
    return ms


def phase_widths(ts, wn, pwide, dev, card: str) -> dict:
    """Phase 21: every row tile gives the same bits (row_tiles_equal); the
    stack kernels vs plain at each of width_cases (phase 4's checks and
    times at B = 2 and 8, with the row tiles each launched and the
    widths it ran at); then `full` at R = 256 trained WIDTH_STEPS steps
    through the train CLI with a bit-exact resume, and its checkpoint
    decoded through the wide kernel, WIDTH_DECODE_STEPS steps vs plain
    with 0 flips.
    Returns the train run's numbers."""
    import torch
    phase_t = time.monotonic()
    row_tiles_equal(ts, wn, dev, card)
    for name, cfg, ng, rows in width_cases():
        params = wn.init_params(cfg, torch.Generator().manual_seed(0), dev)
        ts.tile_calls.clear()
        nums = phase_train_stack(ts, wn, cfg, params, dev, card, phase=21,
                                 num_groups=ng)
        tiles = dict(ts.tile_calls)
        check(set(tiles) == {f"fwd{rows[0]}", f"bwd{rows[1]}"},
              f"{name}: layer blocks launched at {tiles}, expected {rows}")
        nm = 0 if cfg.mel is None else cfg.mel.num_mels
        print(f"phase 21 {name}: R={cfg.residual_channels} "
              f"S={cfg.skip_channels} nm={nm} run at "
              f"{ts.padded_widths(cfg.residual_channels, cfg.skip_channels, nm)}"
              f" layer_block_calls_by_rows={tiles} B={TS_TRAIN_B} T={TS_T} "
              f"{json.dumps(nums)} card={card!r}", flush=True)
        del params
    trained = phase_train(ts, pwide, dev, card, phase=21,
                          overrides=("residual_channels=256",),
                          steps=WIDTH_STEPS, resume_at=WIDTH_RESUME_AT,
                          rows=(64, 32), keep_model=True)
    model = trained.pop("model")
    w = pwide.flatten_params(model.params, model.cfg)
    phase_kernel(pwide, model.cfg, w, dev, card, phase=21,
                 steps=WIDTH_DECODE_STEPS)
    print(f"phase 21 seconds={time.monotonic() - phase_t} card={card!r}",
          flush=True)
    return trained


# ---------------------------------------------------------------------------
# phase 22: the config's dtype fields
# ---------------------------------------------------------------------------

def leaf_grads(ts, wn, cfg, params, dev, fwd, bwd) -> dict:
    """The gradients of mean(skip * ct) with respect to every stack leaf
    through forward_skip_fused (autograd, the _GroupApply the trainer
    runs), its groups computed by fwd and bwd (the kernels, or their plain
    versions put in their place) at [TS_B, TS_T]."""
    import numpy as np
    import torch
    rs = np.random.RandomState(22)
    toks = torch.from_numpy(rs.randint(0, cfg.quantization_channels, (
        TS_B, TS_T)).astype(np.int32)).to(dev)
    ct = torch.from_numpy(rs.randn(TS_B, TS_T, cfg.skip_channels).astype(
        np.float32)).to(dev)
    leaves = {k: params[k].detach().clone().requires_grad_(True)
              for k in ts.GROUP_KEYS}
    x = wn.embed_tokens(params, cfg, toks, wn._shifted_tokens(toks))
    saved = ts.group_fwd, ts.group_bwd
    ts.group_fwd, ts.group_bwd = fwd, bwd
    try:
        skip = ts.forward_skip_fused(dict(params, **leaves), cfg, x)
        grads = torch.autograd.grad((skip * ct).mean(), list(leaves.values()))
    finally:
        ts.group_fwd, ts.group_bwd = saved
    torch.cuda.synchronize()
    return dict(zip(leaves, grads))


def train_plain(dev, card: str, overrides) -> dict:
    """`full` with `overrides` (a config no kernel takes) through the train
    CLI's main() at [DTYPE_TRAIN_B, TS_T] for DTYPE_STEPS steps, resumed
    from DTYPE_RESUME_AT bit for bit, with no kernel launched; then its
    checkpoint generates DTYPE_DECODE_STEPS steps at DTYPE_DECODE_B rows,
    fast == naive token for token, with no kernel launched.  Returns the
    train and decode ms per step."""
    import math
    import torch
    from wavenet_tpu_torch import train
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.models.api import WaveNet
    common = ["--preset", "full", "--synthetic", "--device", "cuda",
              "--batch-size", str(DTYPE_TRAIN_B), "--log-every", "1",
              "--override", f"train_window={TS_T}"]
    for o in overrides:
        common += ["--override", o]
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()                  # the training path starts here
        ma = train.main(common + [
            "--steps", str(DTYPE_STEPS), "--ckpt", a, "--ckpt-every",
            str(DTYPE_RESUME_AT), "--metrics-file",
            os.path.join(tmp, "a.jsonl")])
        torch.cuda.synchronize()
        check_only([], "phase 22 (c) training")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        os.makedirs(b)
        for f in ("params.json", f"ckpt_{DTYPE_RESUME_AT:08d}.pt"):
            shutil.copy(os.path.join(a, f), b)
        train.main(common + [
            "--steps", str(DTYPE_STEPS - DTYPE_RESUME_AT), "--ckpt", b,
            "--resume", "--metrics-file", os.path.join(tmp, "b.jsonl")])
        la = _losses(os.path.join(tmp, "a.jsonl"))
        lb = _losses(os.path.join(tmp, "b.jsonl"))
        check(all(math.isfinite(v) for v in la.values())
              and sorted(lb) == list(range(DTYPE_RESUME_AT + 1,
                                           DTYPE_STEPS + 1))
              and all(lb[k] == la[k] for k in lb),
              f"phase 22 (c): resumed losses {lb} differ from {la}")
        last = f"ckpt_{DTYPE_STEPS:08d}.pt"
        pa = torch.load(os.path.join(a, last), weights_only=True)["params"]
        pb = torch.load(os.path.join(b, last), weights_only=True)["params"]
        check(all(torch.equal(pa[k], pb[k]) for k in pa),
              "phase 22 (c): resumed params differ")
        check_only([], "phase 22 (c) resumed training")

        reset_counts()                  # the decode path starts here
        model = WaveNet.from_checkpoint(a, device=dev)
        check(sampler.kernel_module(model.cfg, dev) is sampler.PLAIN,
              "phase 22 (c): the model would decode on a kernel")
        out = {}

        def fast():
            out["fast"] = model.generate(num_samples=DTYPE_DECODE_STEPS,
                                         batch=DTYPE_DECODE_B, seed=1)
        dec_ms = cuda_ms(fast) / DTYPE_DECODE_STEPS
        naive = sampler.generate_naive(model.params, model.cfg,
                                       DTYPE_DECODE_STEPS,
                                       batch=DTYPE_DECODE_B, seeds=1,
                                       device=dev)
        torch.cuda.synchronize()
        check_only([], "phase 22 (c) decode")
        check(torch.equal(out["fast"], naive),
              "phase 22 (c): fast decode != naive")
    return {"losses": [la[k] for k in sorted(la)],
            "ms_per_step": 1e3 / ma["steps_per_sec"],
            "peak_device_memory_gb": peak_gb, "decode_ms_per_step": dec_ms}


def phase_dtypes(ts, wn, pwide, pnarrow, dev, card: str,
                 f32_trained: dict, f32_entry: dict) -> dict:
    """Phase 22: the config's two dtype fields at full widths.  (a) `full`
    with param_dtype bfloat16: the stack kernels vs plain on the bf16
    leaves at B = 2, T = 8192 (phase 4's bands, two runs bit-identical),
    and through autograd (the trainer's _GroupApply): the weight gradients
    bf16, kernel vs plain within phase 4's gradient band, two kernel runs
    bit-identical; train.main 6 steps with a bit-exact resume from step
    3, every leaf of the checkpoint (params, EMA, moments) bf16, ms per
    step and peak memory beside phase 5's f32 leaves, the save costs
    (utils/profiling.host_costs) beside phase 16's, and the checkpoint
    decoded through the wide kernel == plain bit for bit (256 steps);
    (b) `fastgen_bench` with bf16 leaves: the narrow kernel == plain bit
    for bit at B = 64 for 256 steps, and WaveNet.generate through it (the
    main path's launches); (c) `full` with compute_dtype
    float16, on the plain route (train_plain).  Returns the numbers."""
    import torch
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.config import fastgen_bench, full
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.training.trainer import Trainer
    from wavenet_tpu_torch.utils import profiling
    phase_t = time.monotonic()
    bf = 'param_dtype="bfloat16"'
    cfg = full().replace(param_dtype="bfloat16")
    params = wn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    check({v.dtype for v in params.values()} == {torch.bfloat16},
          "phase 22 (a): init_params drew other than bf16 leaves")
    phase_train_stack(ts, wn, cfg, params, dev, card, phase=22,
                      batches=(TS_B,))
    k1 = leaf_grads(ts, wn, cfg, params, dev, ts.group_fwd, ts.group_bwd)
    k2 = leaf_grads(ts, wn, cfg, params, dev, ts.group_fwd, ts.group_bwd)
    p = leaf_grads(ts, wn, cfg, params, dev, ts.group_fwd_reference,
                   ts.group_bwd_reference)
    check(all(g.dtype == torch.bfloat16 for g in k1.values()),
          "phase 22 (a): a weight gradient is not bf16")
    check(all(torch.equal(k1[k], k2[k]) for k in k1),
          "phase 22 (a): two kernel runs' gradients differ")
    rel = {k: float((k1[k].float() - p[k].float()).abs().max())
           / max(float(p[k].float().abs().max()), 1e-30) for k in k1}
    check(all(r <= GRAD_TOL for r in rel.values()),
          f"phase 22 (a): kernel vs plain leaf gradients {rel}")
    print(f"phase 22 (a) bf16 leaves through autograd B={TS_B} T={TS_T}: "
          f"weight gradients bf16, two kernel runs bit-identical, kernel vs "
          f"plain max|d|/max|g| by leaf {rel} card={card!r}", flush=True)
    del params, k1, k2, p
    trained = phase_train(ts, pwide, dev, card, phase=22, overrides=(bf,),
                          keep_model=True)
    model = trained.pop("model")
    check({v.dtype for v in model.params.values()} == {torch.bfloat16},
          "phase 22 (a): the checkpoint's model is not bf16")
    phase_kernel(pwide, model.cfg, pwide.flatten_params(model.params,
                                                        model.cfg),
                 dev, card, phase=22, steps=WIDTH_DECODE_STEPS)
    del model
    print(f"phase 22 (a) full train step, bf16 leaves against phase 5's f32 "
          f"leaves (B={TS_TRAIN_B} T={TS_T}): ms_per_step="
          f"{trained['ms_per_step']} vs {f32_trained['ms_per_step']} "
          f"peak_device_memory_gb={trained['peak_device_memory_gb']} vs "
          f"{f32_trained['peak_device_memory_gb']} card={card!r}",
          flush=True)
    ecfg = f32_entry["cfg"].replace(param_dtype="bfloat16")
    ds = AudioDataset.synthetic(ecfg, num_clips=8, clip_seconds=4.0)
    with tempfile.TemporaryDirectory() as ck:
        costs = profiling.host_costs(
            Trainer(ecfg, ds, checkpoint_dir=ck, device=dev),
            SAVE_COST_STEPS)
    trained["host_costs"] = costs
    print(f"phase 22 (a) ms per step at B={TS_TRAIN_B}, bf16 leaves against "
          f"phase 16's f32 leaves ({SAVE_COST_STEPS} steps a mode): "
          f"{json.dumps(costs)} vs {json.dumps(f32_entry['host_costs'])} "
          f"card={card!r}", flush=True)

    fcfg = fastgen_bench().replace(param_dtype="bfloat16")
    fparams = wn.init_params(fcfg, torch.Generator().manual_seed(0), dev)
    narrow = phase_kernel(pnarrow, fcfg, pnarrow.flatten_params(fparams,
                                                               fcfg),
                          dev, card, phase=22, batch=NARROW_B,
                          steps=DTYPE_NARROW_STEPS)
    reset_counts()                  # the decode path starts here
    toks = WaveNet(fcfg, fparams).generate(seconds=DECODE_SECONDS, seed=1)
    torch.cuda.synchronize()
    narrow["launches"] = check_only(["decode.launches"],
                                    "phase 22 (b) decode")["decode.launches"]
    check(tuple(toks.shape) == (1, int(DECODE_SECONDS * fcfg.sample_rate)),
          "phase 22 (b): bad decode of the bf16-leaf model")
    print(f"phase 22 (b) fastgen_bench bf16 leaves: WaveNet.generate of "
          f"{DECODE_SECONDS} s launched the narrow kernel "
          f"{narrow['launches']} time(s) card={card!r}", flush=True)
    del fparams
    plain = train_plain(dev, card, ('compute_dtype="float16"',))
    print(f"phase 22 (c) full compute_dtype float16 on the plain route "
          f"(cut to B={DTYPE_TRAIN_B}, T={TS_T} for training; "
          f"{DTYPE_DECODE_STEPS} decode steps at B={DTYPE_DECODE_B}): "
          f"trained {DTYPE_STEPS} steps, resumed from {DTYPE_RESUME_AT} bit "
          f"for bit, no kernel launched, fast == naive: {json.dumps(plain)} "
          f"card={card!r}", flush=True)
    print(f"phase 22 seconds={time.monotonic() - phase_t} card={card!r}",
          flush=True)
    return {"train_bf16": trained, "narrow_bf16": narrow, "float16": plain}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from wavenet_tpu_torch.config import (conditional, fastgen_bench,
                                              full, full_vocoder)
        from wavenet_tpu_torch.models import wavenet as wn
        from wavenet_tpu_torch.ops import rng
        from wavenet_tpu_torch.ops.cuda import build
        from wavenet_tpu_torch.ops.cuda import decode as pnarrow
        from wavenet_tpu_torch.ops.cuda import decode_wide as pwide
        from wavenet_tpu_torch.ops.cuda import probes
        from wavenet_tpu_torch.ops.cuda import train_stack as ts
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    card = nvidia_smi()
    dev = torch.device("cuda", 0)
    t = run_t = time.monotonic()
    build.load_all(["decode_wide", "train_stack", "decode", "probes"])
    for mod in (pwide, ts, pnarrow, probes):
        mod.library()
    register_counters(pnarrow, pwide, ts, probes)
    print(f"phase 0 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernel build_s={time.monotonic() - t}",
          flush=True)

    laps, last = {}, [time.monotonic()]

    def lap(phase: str) -> None:
        """Wall seconds since the previous lap, under the phase's name."""
        now = time.monotonic()
        laps[phase], last[0] = now - last[0], now

    phase_rng(pwide, rng, dev)
    lap("1")
    cfg = full()
    params = wn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    w = pwide.flatten_params(params, cfg)
    numbers = phase_kernel(pwide, cfg, w, dev, card, phase=2, plans=PLANS)
    lap("2")
    launches = phase_serve(pwide, cfg, dev, card)
    lap("3")
    stack = phase_train_stack(ts, wn, cfg, params, dev, card)
    phase_colsums(ts, dev, card)
    lap("4")
    trained = phase_train(ts, pwide, dev, card)
    lap("5")
    del params, w

    vcfg = full_vocoder()
    vparams = wn.init_params(vcfg, torch.Generator().manual_seed(0), dev)
    vw = pwide.flatten_params(vparams, vcfg)
    y = _mel_features(vparams, vcfg, B, STEPS, np.random.RandomState(6), dev)
    mel_numbers = phase_kernel(pwide, vcfg, vw, dev, card, phase=6, y=y)
    lap("6")
    mel_launches = phase_serve_vocoder(pwide, vcfg, dev, card)
    lap("7")
    mel_stack = phase_train_stack(ts, wn, vcfg, vparams, dev, card, phase=8,
                                  num_groups=6)
    lap("8")
    mel_trained = phase_train(ts, pwide, dev, card, "full_vocoder", phase=9)
    lap("9")
    del vparams, vw, y

    fcfg = fastgen_bench()
    fparams = wn.init_params(fcfg, torch.Generator().manual_seed(0), dev)
    fw = pnarrow.flatten_params(fparams, fcfg)
    narrow_numbers = phase_kernel(pnarrow, fcfg, fw, dev, card, phase=10,
                                  batch=NARROW_B, tiles=TILES)
    phase_kernel(pnarrow, fcfg, fw, dev, card, phase=10, batch=HAZARD_B,
                 steps=HAZARD_STEPS)
    del fparams, fw
    dcfg = fastgen_bench().replace(num_blocks=4, max_dilation=1)
    dparams = wn.init_params(dcfg, torch.Generator().manual_seed(3), dev)
    phase_kernel(pnarrow, dcfg, pnarrow.flatten_params(dparams, dcfg), dev,
                 card, phase=10, batch=HAZARD_B, steps=HAZARD_STEPS)
    lap("10")
    del dparams
    narrow_launches = phase_serve(pnarrow, fcfg, dev, card, phase=11,
                                  seeds=tuple(range(1001, 1017)),
                                  one_batch=True)
    lap("11")

    ccfg = conditional()
    cparams = wn.init_params(ccfg, torch.Generator().manual_seed(0), dev)
    cw = pnarrow.flatten_params(cparams, ccfg)
    y = _mel_features(cparams, ccfg, B, STEPS, np.random.RandomState(12), dev)
    cmel_numbers = phase_kernel(pnarrow, ccfg, cw, dev, card, phase=12, y=y)
    del cparams, cw, y
    cmel_launches = phase_serve_vocoder(pnarrow, ccfg, dev, card, phase=12)
    phase_train(ts, pnarrow, dev, card, "conditional", phase=12)
    lap("12")

    (gc_numbers, gc_launches), (wgc_numbers, wgc_launches) = phase_speakers(
        pnarrow, pwide, wn, dev, card)
    lap("13")

    scfg = full().replace(global_classes=SPEAKERS)
    sparams = wn.init_params(scfg, torch.Generator().manual_seed(0), dev)
    gc_stack = phase_train_stack(ts, wn, scfg, sparams, dev, card, phase=14)
    speaker_cost(ts, wn, scfg, sparams, dev, card)
    del sparams
    svcfg = full_vocoder().replace(global_classes=SPEAKERS)
    svparams = wn.init_params(svcfg, torch.Generator().manual_seed(0), dev)
    phase_train_stack(ts, wn, svcfg, svparams, dev, card, phase=14,
                      num_groups=6, batches=(TS_B,))
    del svparams
    gc_trained = phase_train(ts, pwide, dev, card, phase=14, speakers=True)
    lap("14")

    probe_nums, verify_counts = phase_verify(probes, dev, card)
    lap("15")
    entry = phase_entry_points(ts, dev, card)
    lap("16")
    phase_data(card)
    phase_dp(ts, dev, card, trained)
    lap("17")
    phase_mesh(dev, card)
    lap("18")
    phase_seqmodel(ts, dev, card, trained)
    lap("19")
    phase_aot(dev, card)
    lap("20")
    phase_widths(ts, wn, pwide, dev, card)
    lap("21")
    phase_dtypes(ts, wn, pwide, pnarrow, dev, card, trained, entry)
    lap("22")
    print(f"chip_smoke: wall seconds by phase (set-up included) "
          f"{json.dumps(laps)} card={card!r}", flush=True)
    print(f"chip_smoke: every phase passed in {time.monotonic() - run_t} s",
          flush=True)

    src = "wavenet_tpu_torch/csrc/"
    pallas = "wavenet_tpu/ops/pallas/"

    def row(name, source, replaces, launched, numbers, where=pallas):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": where + replaces, "launches": launched,
                **numbers}

    def probe_row(name, counter, replaces):
        return row(name, "probes.cu", replaces,
                   verify_counts[f"probes.{counter}"], probe_nums[name],
                   where="tools/")
    print(json.dumps({"kernels": [
        row("decode_wide", "decode_wide.cu", "decode_wide.py:170", launches,
            numbers),
        row("train_stack_fwd", "train_stack.cu", "train_stack.py:324",
            trained["train_stack_fwd"], stack["fwd"]),
        row("train_stack_bwd", "train_stack.cu", "train_stack.py:426",
            trained["train_stack_bwd"], stack["bwd"]),
        row("decode_wide_mel", "decode_wide.cu", "decode_wide.py:170",
            mel_launches, mel_numbers),
        row("train_stack_fwd_mel", "train_stack.cu", "train_stack.py:324",
            mel_trained["train_stack_fwd"], mel_stack["fwd"]),
        row("train_stack_bwd_mel", "train_stack.cu", "train_stack.py:426",
            mel_trained["train_stack_bwd"], mel_stack["bwd"]),
        row("decode", "decode.cu", "decode.py:180", narrow_launches,
            narrow_numbers),
        row("decode_mel", "decode.cu", "decode.py:180", cmel_launches,
            cmel_numbers),
        row("decode_gc", "decode.cu", "decode.py:180", gc_launches,
            gc_numbers),
        row("decode_wide_gc", "decode_wide.cu", "decode_wide.py:170",
            wgc_launches, wgc_numbers),
        row("train_stack_fwd_gc", "train_stack.cu", "train_stack.py:324",
            gc_trained["train_stack_fwd"], gc_stack["fwd"]),
        row("train_stack_bwd_gc", "train_stack.cu", "train_stack.py:426",
            gc_trained["train_stack_bwd"], gc_stack["bwd"]),
        probe_row("probe_scratch", "scratch_launches",
                  "tpu_scratch_test.py:6"),
        probe_row("probe_gate", "gate_launches", "tpu_tanh_probe.py:18"),
        probe_row("probe_lane_ops", "lane_launches",
                  "tpu_lane_ops_check.py:22"),
        probe_row("probe_shift_concat", "shift_launches",
                  "tpu_concat_probe.py:50")]}))
    print(card)
    # the run used one card, device 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
