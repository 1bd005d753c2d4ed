#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hifimeth_tpu_torch) on one GPU,
and on four where the host has them.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):
 1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
    build of every kernel library (in parallel) and of the host I/O core
    from this checkout, with each library's ptxas report;
 2. every kernel against its plain PyTorch version on the card, timed at
    its path's shape beside its bound and a PyTorch yardstick computing
    the same function (fused_forward's bound: the least FLOP the function
    needs, see least_flops, at the tensor cores' 3xTF32 rate; the FP32
    FFMA bound and the per-window count are printed beside it):
    group_windows_t bit-exact and fused_forward within
    2e-3 logits and +-1 u8 at the call path's 8192 sites (K=11 (CpG) and
    K=13 (CHH) models, forward and reverse, main (clipped bases, padded
    groups), greedy-split and odd-width plans); conv1d_relu for every
    layer of the three shipped nets, bn0 folded into the first, each layer
    fed the plain version's output of the one before, bit-equal to it
    (torch.equal) at 1, 8191, 8192 and 8197 sites and in the bf16 mode,
    timed at 8192 sites beside its FFMA bound and cuDNN's conv1d + bias +
    ReLU; group_windows,
    window_slices and window_rows bit-exact at the microbenchmark's 16384
    sites over a (4 Mi, 8) table (greedy-split plans, starts at the last
    legal row, odd row counts, 3-channel and misaligned tables, spp 8 and
    64, mixed strands, and one out-of-contract clamp case each; for
    window_rows also other out_rows, 8 and 1544 sites, each case's route
    printed, the microbenchmark's case held to the TMA route), and a DRAM
    probe (scripts/probe_window_rows.py): reading every other 32-byte row of
    a 256 MB table against every row;
 3. the main paths, each with every kernel's launch count set to 0 just
    before it and read just after: all-context `call` through the port's
    run_call at the shipped models' full width, over ~200 reads x 15 kb
    (~0.9 M sites), once per gather_impl through the asynchronous pipeline
    (decode workers, segment-streamed planes, dispatch/resolve/emit
    workers; "pallas": group_windows_t + conv1d_relu CNN; "fused":
    fused_forward; "slice" and "folded": indexing gathers + conv1d_relu
    CNN), every run that takes the direct route launching conv1d_relu 8
    times a program call (6 under conv_impl "auto", whose first and last
    convs are products); then pallas and fused with --sync-emit (sites/s
    beside
    the async run); pallas in bf16 (group_windows_t writing bf16
    windows); pallas on a forced schedule (256 Ki buffer, 48 Ki flushes,
    3 decode workers), which must roll buffers over, cut flushes at
    segments and carry reads, and make fewer page-locked host buffers (the
    engine's `pinned_new`) than it has flushes, each of which takes at
    least two, so the engine's pool reuses them; pallas with CallConfig.conv_impl "im2col"
    (every conv one cuBLAS float32 product over unfolded columns) and
    slice with "auto" (the first and last convs so); and the window-fetch
    microbenchmark (scripts/microbench_torch_gather.py, every variant, 2
    batches), which
    launches group_windows, window_slices and group_windows_t;
 4. outputs held to the parity contract (MM/MN byte-equal, ML within +-1,
    at most 5% of ML bytes off): fused against pallas, slice against
    pallas and folded against slice on the card over the big input; async
    against sync for pallas and fused, and the forced schedule against the
    default, byte-equal; pallas im2col and slice auto against their direct
    runs (contract, ML bytes off and peak device memory printed), and an
    im2col forward with TF32 switched on must raise; bf16 against f32
    pallas with MM/MN equal and ML
    inside bench.py's self-check gate (max 24, mean 2.0) and a mean of at
    least 0.3 (a run that skips the bf16 rounding reads near 0) over the
    big input, and on the input the JAX package's bf16 band was taken on
    (bench.py's self-check: 20 reads x 5 kb, uniform, seed 7) no wider
    than that band (BENCH_r05.json: mean 0.62, 2.423% of bytes off by more
    than 3; its max of 10, one site's extreme, is printed beside the
    port's); and the card against the port's CPU run on a small input, for
    every path and for bf16 (bf16 within max 10, mean 0.2);
 5. scale-out and quantification on the card, each call run with the
    kernels' counts set to 0 just before it and read just after (pallas
    runs must launch group_windows_t and conv1d_relu, slice runs
    conv1d_relu alone):
    `call --data-parallel` on one card (the single-device path: the
    card found alone on a one-card host, ["cuda:0"] named on a host with
    more), byte-equal to the pallas run, its sites/s beside it; the split over the
    device list ["cuda:0", "cuda:0"] (two replicas with their own segments,
    tables and streams, sharing the card's one read-only model set,
    ModelSet.cached) for pallas (byte-equal to one device)
    and slice (parity contract); `run_call` on shards 0/2 and 1/2 of
    50-read blocks then `merge_shard_bams` over the same blocks, byte-equal
    to the unsharded run; a one-rank NCCL group whose
    three collectives run on cuda tensors (the identity) and whose
    `run_pileup_multihost` on the golden corpus merges to the golden BEDs;
    and `pileup`, `cov2bed` and `corr` against the golden corpus.  The
    phase prints its wall seconds;
 6. the model lifecycle at full width: the three shipped models exported to
    ONNX and imported back (load_reference_onnx and import_models), every
    array bit-equal to its npz; a seeded world (tests/test_train_e2e.py's,
    scaled: a 200 kb genome with half of its CpGs methylated, a Bismark BED
    of labels, 400 mapped kinetics reads for training and 20 unmapped
    held-out reads of 1.5 kb); `extract-features` (CpG, at least 32,768
    samples); the first 3 training steps on the card against the same 3
    on the CPU, and in a one-rank NCCL group (every collective of the
    trainer) against no group, from the same carried weights, within the
    STEP_* tolerances (steps_close); the recipe on the card (kmer 401,
    batch 512, recipe widths, 3 epochs, float32 without TF32) to a final
    accuracy above 0.9, with its ms a step on the card's stream split
    into gather, forward+backward and optimizer, its samples/s and peak
    memory, and 10 steady steps under torch.profiler (device busy ms a
    step, idle share, top kernels); and the folded model serving
    the held-out reads through `call` on the card with pallas and with
    fused (each must launch its kernel), each with a held-out AUC above 0.9
    and fused within the parity contract of pallas.  The phase prints its
    wall seconds;
 7. the rest of the JAX package's surface on the card: the main path with
    the per-flush trace on (CallConfig.trace, the CLI's HIFIMETH_TRACE),
    pallas and fused, through the default async pipeline and then with
    --decode-workers 0 (whose untraced runs come first), each run with
    the counts set to 0 just before it and read just after (it must launch
    its kernel), its records byte-equal to phase 3's untraced run, one
    trace line per flush of its schedule with the seven stages in order,
    and per run the median and total over flushes of the queue wait
    (dispatch0 - flush), dispatch, the hand-over to resolve (resolve0 -
    dispatch1), resolve and emit, with its sites/s beside the untraced
    run's; the weight cache (two engines of one config share weight
    storage, ["cuda:0", "cuda:0"] shares one set, kmer.txt and an npz
    rewritten to another size with the mtime put back reload); and
    call_sites, the reference per-site call, against call_sites_group on
    the same 16 Ki sites within the parity contract.  The phase prints its
    wall seconds;
 8. graphs on the card (CallConfig.graphs; phases 1-7 run with it on, the
    default): the big input through pallas and fused four times each in
    turns with graphs off and on (eager, graph, graph, eager), through
    slice and folded twice (eager, graph; their programs index per site),
    and through pallas-bf16, the pallas split and the slice split over
    ["cuda:0", "cuda:0"] (the grid programs, a share of each batch per
    replica) once with graphs off (their graph turns are their runs of
    phases 3 and 5), each run with the counts and the peak device memory
    set to 0 just before it and read just after: every run byte-equal to
    phase 3's run of its path (the pallas split to phase 3's pallas, the
    slice split to phase 5's), launching its kernels as often as the graph
    runs of its path (the gather 126 times on the smoke input, the split
    more, as its plans pad to two devices; conv1d_relu 8 times a program
    call) and no other; per run its
    sites/s, the
    engine's capture seconds (inside the run's wall) and its peak device
    memory, allocated and reserved; then the default async pallas and
    fused runs under torch.profiler (scripts/profile_torch_call.py's
    device_profile), whose idle share is printed, whose device time must
    include the path's kernels, and whose device kernels of each name must
    number the wrapper's launches plus the programs' warm-ups
    (engine/programs.py warmup_launches): the profiler sees the kernels
    inside graphs one by one, so the counts are measured, not booked.
    The phase prints its wall seconds;
 9. `call --data-parallel` over four distinct cards, ["cuda:0", "cuda:1",
    "cuda:2", "cuda:3"], where torch.cuda.device_count() is at least 4
    (skipped with a line saying so elsewhere): pallas byte-equal to phase
    3's one-card run, slice within the parity contract of its one-card
    run, each launching its kernels and no other; the engine's exchange
    counters show the peer copies back to cuda:0 were made (`peer_bytes`
    three quarters of `slots`: each card's u8 results but the first's)
    and the planes were shipped (`ship_bytes`); the same pallas split over
    ["cuda:0"] * 4 (one card four times) byte-equal, with `peer_bytes` 0.
    Each run prints its sites/s beside the one-card run's, its
    `to_primary` seconds and its counters; the phase prints its wall
    seconds.
The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}.  window_rows lies on no path of the
repository: its `launches` are its phase-2 launches.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM device-memory rate, FP32 rate outside the tensor cores and
#: dense TF32 tensor-core rate (NVIDIA data sheet), bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
#: an f32-accurate product on the tensor cores is three TF32 passes (3xTF32)
F32_TENSOR_FLOPS = TF32_FLOPS / 3
#: batch sizes at which phase 2 holds conv1d_relu to its plain version bit
#: for bit (cuDNN in float32, TF32 off, sums the same products in the same
#: order): a ragged tile at the end of every one, and one site
CONV_RAGGED = (1, 8191, 8197)
#: base composition (A, C, G, T) of the synthetic reads: GC ~0.36, about
#: 0.30 all-context candidate sites per base, a plant genome's density
PLANT = (0.32, 0.18, 0.18, 0.32)
#: bench.py's "uniform" composition, of its self-check input
UNIFORM = (0.25, 0.25, 0.25, 0.25)
SITE_BATCH = 8192
CONTEXTS = ("CpG", "CHG", "CHH")
#: the window-fetch microbenchmark's shape (scripts/microbench_torch_gather.py)
MICRO_SITES = 16384
MICRO_ROWS = 1 << 22
GATHER_IMPLS = ("pallas", "fused", "slice", "folded")
#: the main-path runs of phase 3: label -> (CallConfig fields, the kernels
#: the run must launch)
PALLAS = ("group_windows_t", "conv1d_relu")
CNN = ("conv1d_relu",)
MAIN_RUNS = {
    "pallas": (dict(gather_impl="pallas"), PALLAS),
    "fused": (dict(gather_impl="fused"), ("fused_forward",)),
    "slice": (dict(gather_impl="slice"), CNN),
    "folded": (dict(gather_impl="folded"), CNN),
    "pallas-sync": (dict(gather_impl="pallas", async_emit=False), PALLAS),
    "fused-sync": (dict(gather_impl="fused", async_emit=False),
                   ("fused_forward",)),
    "pallas-bf16": (dict(gather_impl="pallas", compute_dtype="bfloat16"),
                    PALLAS),
    "pallas-forced": (dict(gather_impl="pallas", buffer_bases=1 << 18,
                           flush_bases=48 << 10, decode_workers=3), PALLAS),
    "pallas-im2col": (dict(gather_impl="pallas", conv_impl="im2col"),
                      ("group_windows_t",)),
    "slice-auto": (dict(gather_impl="slice", conv_impl="auto"), CNN),
}

#: phase 9's device list: four distinct cards of one host
CARDS = ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
#: reads per round-robin block of phase 5's shard runs: 200 reads make 4
#: blocks, 2 per shard
SHARD_BLOCK = 50
#: the JAX package's bf16 band against its float32 (BENCH_r05.json), taken
#: by bench.py's self-check on its input (20 reads x 5 kb, uniform, seed 7,
#: site_batch 16384): max and mean |diff| of the ML bytes and the share off
#: by more than 3
BF16_BAND = {"max": 10, "mean": 0.62, "share_gt3": 0.02423}
#: the self-check's own gate for bf16 on any input (bench.py run_selfcheck):
#: max and mean |diff|
BF16_GATE = (24, 2.0)
#: the least mean |diff| of bf16 against float32: the port read 0.58-0.61
#: on the card and the CPU (PERF.md), float32 against itself reads 0, so a
#: run under half of that did not round each layer to bf16
BF16_FLOOR_MEAN = 0.3
#: the card's bf16 against the CPU's bf16, max and mean |diff|: the two
#: differ only in the order of float32 sums (read: max 4, mean 0.05-0.07)
BF16_DEVICE = (10, 0.2)
#: phase 6's world: genome length, training and held-out reads, read length
#: (~94 CpG samples a read: WORLD_TRAIN reads give ~37,500)
WORLD_GLEN = 200_000
WORLD_TRAIN = 400
WORLD_HELD = 20
WORLD_RLEN = 1500
#: the recipe trained in phase 6, and the least samples it must train on
TRAIN_KMER = 401
TRAIN_BATCH = 512
TRAIN_EPOCHS = 3
TRAIN_MIN_SAMPLES = 32768
#: steps held card vs CPU and one-rank NCCL vs no group (steps_close):
#: float32 without TF32 on both sides, so they differ only in the order of
#: sums.  Each step's loss within STEP_LOSS_TOL; each parameter and BN
#: statistic after the first and the last step within STEP_SHARE of its own
#: change over the steps (read on the card: 0.069 after step 3 against the
#: CPU, 0.054 in the NCCL group; the CPU on 1 and 6 threads 0.031)
PARITY_STEPS = 3
STEP_LOSS_TOL = 1e-4
STEP_SHARE = (0.01, 0.25)
#: steady training steps profiled for the card's busy and idle time
PROFILE_STEPS = 10
#: the least final training accuracy and held-out AUC
MIN_FINAL_ACC = 0.9
MIN_HELD_AUC = 0.9


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def make_bam(path, n_reads, read_len, seed, composition=PLANT):
    """Unmapped HiFi-like reads with random codeV1 kinetics (fi/ri/fp/rp);
    the same draws as bench.py's make_synthetic_bam."""
    import numpy as np
    from hifimeth_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    with BamWriter(path, BamHeader("@HD\tVN:1.6\tSO:unknown\n", []),
                   threads=8) as w:
        for i in range(n_reads):
            rec = BamRecord(qname=f"m/{i}/ccs", flag=4)
            rec.set_seq(rng.choice(bases, read_len, p=composition),
                        qual=np.full(read_len, 40, np.uint8))
            for tag in ("fi", "ri", "fp", "rp"):
                rec.set_tag(tag, "B", ("C", rng.integers(
                    0, 256, read_len).astype(np.uint8)))
            rec.set_tag("fn", "C", 5)
            rec.set_tag("rn", "C", 5)
            w.write(rec)


def cuda_ms(fn, iters=50):
    """Mean device time of `fn` over back-to-back launches (CUDA events;
    a device-side sleep first lets the host enqueue all of them, so host
    launch overhead is not timed)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def feature_table(rng, n_cols, dev):
    """An (8, n_cols) table featurized on the card from random planes of
    plant composition, with the engine's zero-feature margin at the start
    (which padded groups, base 0, read)."""
    import numpy as np
    import torch
    from hifimeth_tpu_torch.features.windows import featurize_planes_t
    planes = np.empty((5, n_cols), np.uint8)
    planes[0] = rng.choice(4, n_cols, p=PLANT)
    planes[1:] = rng.integers(0, 256, (4, n_cols))
    planes[0, :401] = 255
    planes[1:, :401] = 0
    return featurize_planes_t(torch.from_numpy(planes).to(dev))


def gather_plan(rng, n_sites, lo, hi, n_cols, ng_multiple):
    """A real plan from the port's planner for n_sites sorted distinct
    window starts in [lo, hi), 128-aligned as the engine aligns it, padded
    with base-0 groups to a multiple of ng_multiple groups."""
    import numpy as np
    from hifimeth_tpu_torch.ops.gather import (BLOCK_LANES, GROUP,
                                               PLAN_EXTENT, check_plan,
                                               plan_groups)
    starts = np.sort(rng.choice(np.arange(lo, hi), n_sites, replace=False))
    bases, rels, _ = plan_groups(starts.astype(np.int32), GROUP, BLOCK_LANES,
                                 401, n_cols, extent=PLAN_EXTENT)
    b128 = (bases // 128) * 128
    rels = rels + (bases - b128)[:, None]
    pad = -len(b128) % ng_multiple
    b128 = np.concatenate([b128, np.zeros(pad, np.int32)]).astype(np.int32)
    rels = np.concatenate([rels, np.zeros((pad, GROUP), np.int32)])
    check_plan(b128, rels, n_cols, 401)
    return b128, rels.astype(np.int32)


def phase_gather():
    """group_windows_t vs plain version (bit-exact) and timings; returns the
    kernel's JSON row without `launches`."""
    import numpy as np
    import torch
    from hifimeth_tpu_torch.ops.gather import (GROUP, group_windows_t,
                                               group_windows_t_plain)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    kmer = 401
    n_cols = 1 << 21                    # the engine's default buffer
    ng = SITE_BATCH // GROUP
    table = torch.from_numpy(
        rng.standard_normal((8, n_cols)).astype(np.float32)).to(dev)
    # main-path shape: 8192 sites at ~0.3 sites/bp ending at the buffer's
    # last window start (clipped bases), plus padded groups
    main = gather_plan(rng, SITE_BATCH - 200, n_cols - 602 - 27000,
                       n_cols - 602, n_cols, ng)
    # spans split by the greedy planner (sparse sites) and a table whose
    # width is not a multiple of 4 (unaligned, bounds-checked staging)
    sparse = gather_plan(rng, 500, 401, n_cols - 602, n_cols, 1)
    odd_cols = 5003
    odd_table = torch.from_numpy(
        rng.standard_normal((8, odd_cols)).astype(np.float32)).to(dev)
    odd = gather_plan(rng, 300, 0, odd_cols - 602, odd_cols, 1)

    max_err = 0.0
    n_checked = 0
    for tab, (b, r) in ((table, main), (table, sparse), (odd_table, odd)):
        bd = torch.from_numpy(b).to(dev)
        rd = torch.from_numpy(r).to(dev)
        for rev in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                got = group_windows_t(tab, bd, rd, rev=rev, kmer=kmer,
                                      out_dtype=dt)
                want = group_windows_t_plain(tab, bd, rd, rev, kmer, dt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"group_windows_t != plain (rev={rev}, {dt}, "
                        f"{len(b)} groups): max |err| {err}")
                n_checked += 1
    print(f"[kernels] group_windows_t bit-exact vs plain in {n_checked} "
          f"cases (fwd/rev x f32/bf16 x main/split/unaligned plans)")

    b, r = main
    bd, rd = torch.from_numpy(b).to(dev), torch.from_numpy(r).to(dev)
    times = {}
    for rev in (False, True):
        times[rev] = cuda_ms(lambda: group_windows_t(table, bd, rd, rev=rev,
                                                     kmer=kmer))
    plain_ms = cuda_ms(lambda: group_windows_t_plain(
        table, bd, rd, False, kmer, torch.float32), iters=10)
    # library yardstick: one torch.take over precomputed flat indices
    starts = (bd.long()[:, None] + rd).reshape(-1)
    lanes = torch.arange(kmer, device=dev)
    flat = (torch.arange(8, device=dev)[None, :, None] * n_cols
            + starts[:, None, None] + lanes[None, None, :])
    lib = torch.take(table, flat)
    if not torch.equal(lib, group_windows_t_plain(table, bd, rd, False, kmer,
                                                  torch.float32)):
        raise AssertionError("torch.take yardstick disagrees with plain")
    library_ms = cuda_ms(lambda: torch.take(table, flat), iters=10)
    # bytes the function must move: each output once, each table lane the
    # windows cover once (all 8 channels), the plan arrays once
    need = np.zeros(n_cols, bool)
    s_np = (b.astype(np.int64)[:, None] + r).ravel()
    for s in np.unique(s_np):
        need[s:s + kmer] = True
    n_out = len(s_np) * 8 * kmer
    moved = n_out * 4 + int(need.sum()) * 8 * 4 + b.nbytes + r.nbytes
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] group_windows_t at {len(s_np)} sites: fwd "
          f"{times[False]:.4f} ms, rev {times[True]:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.take {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({moved} B at 3.35 TB/s)")
    return {"name": "group_windows_t", "route": "cuda",
            "source": "hifimeth_tpu_torch/ops/csrc/group_windows.cu",
            "replaces": "hifimeth_tpu/ops/gather.py:341",
            "max_abs_err": max_err, "ms": times[False],
            "rev_ms": times[True], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def least_flops(w, starts):
    """FLOP the fused function needs for windows at `starts` (FusedWeights
    w): each distinct window once, and conv1 once per distinct output
    position.  An interior conv1 output, whose taps all lie inside its
    window, depends only on the table lane its taps start at, so
    overlapping windows share it, as the replaced kernel's stride-1 block
    conv1 shares it; the outputs that reach a window's zero pad are
    computed per window.  Returns (FLOP, distinct windows, conv1 outputs)."""
    import numpy as np
    u = np.unique(starts)
    k1, cin, cout = w.layout["convs.0.w"][1]
    first = 2 * np.arange(w.lengths[0]) - 1     # window lane of tap 0
    inner = (first >= 0) & (first + k1 <= w.kmer)
    n_conv1 = (len(np.unique((u[:, None] + first[inner]).ravel()))
               + int((~inner).sum()) * len(u))
    conv1 = 2 * k1 * cin * cout
    return ((w.flops_per_window() - conv1 * w.lengths[0]) * len(u)
            + conv1 * n_conv1, len(u), n_conv1)


def phase_fused():
    """fused_forward vs plain version within 2e-3 logits and +-1 u8, and
    timings; returns the kernel's JSON row without `launches`."""
    import numpy as np
    import torch
    from hifimeth_tpu_torch.engine.call import default_model_dir
    from hifimeth_tpu_torch.features.windows import call_sites_group
    from hifimeth_tpu_torch.model.cnn import (exact_float32, load_model_npz,
                                              logits_to_scaled_probs)
    from hifimeth_tpu_torch.ops.fused import (fused_forward,
                                              fused_forward_plain,
                                              prepare_fused_params)
    from hifimeth_tpu_torch.ops.gather import GROUP
    exact_float32()                     # the plain version's cuDNN in f32
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    n_cols = 1 << 21
    ng = SITE_BATCH // GROUP
    table = feature_table(rng, n_cols, dev)
    odd_cols = 5003
    odd_table = feature_table(rng, odd_cols, dev)
    main = gather_plan(rng, SITE_BATCH - 200, n_cols - 602 - 27000,
                       n_cols - 602, n_cols, ng)
    sparse = gather_plan(rng, 500, 401, n_cols - 602, n_cols, 1)
    odd = gather_plan(rng, 300, 0, odd_cols - 602, odd_cols, 1)
    models, weights = {}, {}
    for ctx in ("CpG", "CHH"):          # conv1 K=11 and K=13
        models[ctx] = load_model_npz(
            os.path.join(default_model_dir(), f"{ctx}.npz"), dev)
        weights[ctx] = prepare_fused_params(models[ctx], dev)

    max_err, max_du8, n_checked = 0.0, 0, 0
    for ctx, w in weights.items():
        for tab, (b, r) in ((table, main), (table, sparse), (odd_table, odd)):
            bd = torch.from_numpy(b).to(dev)
            rd = torch.from_numpy(r).to(dev)
            for rev in (False, True):
                got = fused_forward(w, tab, bd, rd, rev=rev)
                want = fused_forward_plain(w, tab, bd, rd, rev)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                du8 = (logits_to_scaled_probs(got).int()
                       - logits_to_scaled_probs(want).int()).abs().max().item()
                max_err, max_du8 = max(max_err, err), max(max_du8, du8)
                if not (err <= 2e-3 and du8 <= 1):
                    raise AssertionError(
                        f"fused_forward != plain ({ctx}, rev={rev}, {len(b)} "
                        f"groups): max |logit err| {err}, max |u8 diff| {du8}")
                n_checked += 1
    print(f"[kernels] fused_forward within tolerance of plain in {n_checked} "
          f"cases (K=11/13 x fwd/rev x main/split/unaligned plans): max "
          f"|logit err| {max_err:.3g} (<= 2e-3), max |u8 diff| {max_du8}")

    b, r = main
    bd, rd = torch.from_numpy(b).to(dev), torch.from_numpy(r).to(dev)
    n_sites = len(b) * GROUP
    times = {}
    for ctx, w in weights.items():
        for rev in (False, True):
            times[ctx, rev] = cuda_ms(
                lambda: fused_forward(w, table, bd, rd, rev=rev), iters=10)
    w = weights["CpG"]
    plain_ms = cuda_ms(lambda: fused_forward_plain(w, table, bd, rd, False),
                       iters=5)
    # yardstick: the pallas path's device work for the same sites (gather
    # kernel + cuDNN CNN in f32 + u8 conversion), several calls composed
    library_ms = cuda_ms(lambda: call_sites_group(models["CpG"], table, bd,
                                                  rd, False), iters=5)
    starts = (b.astype(np.int64)[:, None] + r).ravel()
    # the least time for f32-accurate products is the tensor cores' in
    # 3xTF32; the FP32 units' FFMA bound is printed beside it
    bounds = {}
    for ctx in weights:
        f, n_win, n_conv1 = least_flops(weights[ctx], starts)
        per_window = weights[ctx].flops_per_window() * n_sites
        moved = (weights[ctx].buf.numel() * 4 + n_sites * 2 * 4 + b.nbytes
                 + r.nbytes
                 + 8 * 4 * (int(b.max()) + 2048 - int(b[b > 0].min())))
        bounds[ctx] = max(f / F32_TENSOR_FLOPS, moved / HBM_BYTES_PER_S) * 1e3
        ffma = max(f / FP32_FLOPS, moved / HBM_BYTES_PER_S) * 1e3
        print(f"[kernels] fused_forward {ctx} at {n_sites} sites: fwd "
              f"{times[ctx, False]:.4f} ms, rev {times[ctx, True]:.4f} ms; "
              f"least work {f} FLOP ({n_win} distinct windows, conv1 at "
              f"{n_conv1} distinct outputs; {per_window} FLOP counted per "
              f"window): 3xTF32 bound {bounds[ctx]:.4f} ms "
              f"({100 * bounds[ctx] / times[ctx, False]:.1f}% of it) at 165 "
              f"TFLOP/s, FFMA bound {ffma:.4f} ms "
              f"({100 * ffma / times[ctx, False]:.1f}%) at 67 TFLOP/s; "
              f"per-window count at 165 TFLOP/s "
              f"{per_window / F32_TENSOR_FLOPS * 1e3:.4f} ms")
    print(f"[kernels] fused_forward CpG: plain {plain_ms:.4f} ms, yardstick "
          f"(group_windows_t + cuDNN CNN + u8) {library_ms:.4f} ms, bound "
          f"{bounds['CpG']:.4f} ms (operations; bytes of the last model "
          f"{moved} B = {moved / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return {"name": "fused_forward", "route": "cuda",
            "source": "hifimeth_tpu_torch/ops/csrc/fused_forward.cu",
            "replaces": "hifimeth_tpu/ops/fused.py:373",
            "max_abs_err": max_err, "ms": times["CpG", False],
            "rev_ms": times["CpG", True], "chh_ms": times["CHH", False],
            "plain_ms": plain_ms, "bound_ms": bounds["CpG"],
            "bound_by": "operations", "library_ms": library_ms}


def phase_conv():
    """conv1d_relu against its plain version for every layer of the three
    shipped nets (bn0 folded into the first), each layer fed the plain
    version's output of the one before on real windows: bit for bit
    (torch.equal) at SITE_BATCH sites and at each of CONV_RAGGED, and in
    the bf16 mode (bf16-valued inputs and weights, bn0 before the first
    layer); timed at SITE_BATCH sites beside its FFMA bound, the plain
    version and cuDNN.  Returns the kernel's JSON row without `launches`
    (times: the CHH net, the largest, one batch through its eight
    layers)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from hifimeth_tpu_torch.model.cnn import exact_float32, load_model_npz
    from hifimeth_tpu_torch.ops.conv import (PAD, STRIDE, conv1d_relu,
                                             conv1d_relu_plain, unpack_weight)
    from hifimeth_tpu_torch.ops.gather import group_windows_t_plain
    exact_float32()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n_cols = 1 << 20
    n_max = max(SITE_BATCH, *CONV_RAGGED)
    sizes = ", ".join(map(str, sorted((SITE_BATCH, *CONV_RAGGED))))
    table = feature_table(rng, n_cols, dev)
    b, r = gather_plan(rng, n_max, 401, n_cols - 602, n_cols, 1)
    windows = group_windows_t_plain(table, torch.from_numpy(b).to(dev),
                                    torch.from_numpy(r).to(dev), False, 401,
                                    torch.float32)[:n_max].contiguous()

    def layer(ctx, h, conv, w, i, bn0):
        """The kernel's and the plain version's output of one layer, held
        equal bit for bit."""
        affine = (bn0.scale, bn0.shift) if bn0 is not None else ()
        got = conv1d_relu(h, w, conv.bias, STRIDE, PAD, *affine)
        want = conv1d_relu_plain(h, unpack_weight(w, h.shape[1]), conv.bias,
                                 STRIDE, PAD, *affine)
        check_equal(f"conv1d_relu {ctx} conv{i} at {h.shape[0]} sites", got,
                    want)
        return got, want, affine

    totals = {}
    for ctx in CONTEXTS:
        path = os.path.join(ROOT, "models", f"{ctx}.npz")
        model = load_model_npz(path, dev).requires_grad_(False)
        for n in CONV_RAGGED:
            h = windows[:n]
            for i, conv in enumerate(model.convs):
                _, h, _ = layer(ctx, h, conv, conv._mat, i,
                                model.bn0 if i == 0 else None)
        low = load_model_npz(path, dev, torch.bfloat16).requires_grad_(False)
        h = low.bn0(windows[:SITE_BATCH]).to(torch.bfloat16).float()
        for i, (conv, w) in enumerate(zip(low.convs, low._low[0])):
            _, h, _ = layer(f"{ctx} bf16", h, conv, w, i, None)
            h = h.to(torch.bfloat16).float()
        h = windows[:SITE_BATCH]
        sums = np.zeros(4)
        for i, conv in enumerate(model.convs):
            got, want, affine = layer(ctx, h, conv, conv._mat, i,
                                      model.bn0 if i == 0 else None)
            args = (h, conv._mat, conv.bias, STRIDE, PAD, *affine)
            cout, cin, k = conv.weight.shape
            flops = 2 * got.numel() * cin * k
            ms = cuda_ms(lambda: conv1d_relu(*args))
            plain_ms = cuda_ms(lambda: conv1d_relu_plain(
                h, conv.weight, conv.bias, STRIDE, PAD, *affine), iters=10)
            lib_in = model.bn0(h) if i == 0 else h
            library_ms = cuda_ms(lambda: F.conv1d(
                lib_in, conv.weight, conv.bias, stride=STRIDE,
                padding=PAD[0]).relu_(), iters=10)
            bound_ms = flops / FP32_FLOPS * 1e3
            sums += (ms, bound_ms, plain_ms, library_ms)
            print(f"[kernels] conv1d_relu {ctx} conv{i} ({cin}->{cout}, K "
                  f"{k}, {h.shape[2]}->{got.shape[2]}"
                  f"{', bn0 folded' if i == 0 else ''}) at {h.shape[0]} "
                  f"sites: {ms:.4f} ms, FFMA bound {bound_ms:.4f} ms "
                  f"({100 * bound_ms / ms:.1f}%), plain {plain_ms:.4f} ms, "
                  f"cuDNN conv1d + bias + relu_ {library_ms:.4f} ms; "
                  f"bit-equal at {sizes} sites and in bf16; zeros "
                  f"{(want == 0).float().mean().item():.3f}")
            h = want
        totals[ctx] = sums
        print(f"[kernels] conv1d_relu {ctx}, eight layers a batch: "
              f"{sums[0]:.4f} ms, FFMA bound {sums[1]:.4f} ms "
              f"({100 * sums[1] / sums[0]:.1f}%), plain {sums[2]:.4f} ms, "
              f"cuDNN {sums[3]:.4f} ms")
    ms, bound_ms, plain_ms, library_ms = totals["CHH"]
    return {"name": "conv1d_relu", "route": "cuda",
            "source": "hifimeth_tpu_torch/ops/csrc/conv1d_relu.cu",
            "replaces": "cuDNN conv1d + bias + ReLU (no TPU kernel)",
            "max_abs_err": 0.0, "ms": ms, "bound_ms": bound_ms,
            "bound_by": "FFMA", "plain_ms": plain_ms,
            "library_ms": library_ms,
            "net_ms": {c: t[0] for c, t in totals.items()}}


def covered_rows(starts, n, n_rows, step=1):
    """Distinct rows of an n_rows table that windows of n rows taken every
    `step` rows from `starts` read."""
    import numpy as np
    need = np.zeros(n_rows, bool)
    need[(starts.astype(np.int64)[:, None]
          + step * np.arange(n)).ravel()] = True
    return int(need.sum())


def odd_tables(rng, n_rows, dev):
    """Tables that take the kernels' scalar path: 3 channels, and 8
    channels whose data pointer is 4 bytes off 16-byte alignment; both with
    a row count that is not a multiple of 4."""
    import numpy as np
    import torch
    narrow = torch.from_numpy(
        rng.standard_normal((n_rows, 3), dtype=np.float32)).to(dev)
    flat = torch.from_numpy(
        rng.standard_normal(n_rows * 8 + 1, dtype=np.float32)).to(dev)
    shifted = flat[1:].view(n_rows, 8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    return {"3-channel": narrow, "misaligned": shifted}


def check_equal(label, got, want):
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        err = ((got - want).abs().max().item() if got.shape == want.shape
               else float("inf"))
        raise AssertionError(f"{label}: kernel != plain, max |err| {err}")


def phase_row_windows():
    """group_windows, window_slices and window_rows against their plain
    versions (bit-exact) at the window-fetch microbenchmark's shape, plus
    odd tables and out-of-contract starts, and timings; returns the three
    kernels' JSON rows without `launches`."""
    import numpy as np
    import probe_window_rows
    import torch
    from hifimeth_tpu_torch.ops import gather as G
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    kmer, n, b = 401, MICRO_ROWS, MICRO_SITES
    group, block, fetch = 32, 1024, 2 * 401
    feats = torch.from_numpy(
        rng.standard_normal((n, 8), dtype=np.float32)).to(dev)
    feats_r = torch.from_numpy(
        rng.standard_normal((n, 8), dtype=np.float32)).to(dev)
    n_odd = 5003
    odd = odd_tables(rng, n_odd, dev)
    odd_r = odd_tables(rng, n_odd, dev)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    # -- group_windows: the microbenchmark's plan (sorted starts ~2.5 rows
    # apart from row kmer), the same density ending at the last legal row
    # (bases clipped to n - block), a greedy-split plan (real idx), odd
    # tables, and out-of-contract bases and rels
    def dense_starts(first, count):
        return (first + np.cumsum(rng.integers(1, 5, count))).astype(np.int32)

    def plan(starts, n_rows, split=None):
        bases, rels, idx = G.plan_groups(np.sort(starts), group, block, kmer,
                                         n_rows)
        if split is not None and (idx is not None) != split:
            raise AssertionError(f"plan_groups: split {idx is not None}")
        return bases, rels

    micro = plan(dense_starts(kmer, b), n, split=False)
    tail = dense_starts(0, b)
    gplans = {
        "microbenchmark": (feats, micro),
        "last-row": (feats, plan(tail + (n - kmer - int(tail[-1])), n,
                                 split=False)),
        "greedy-split": (feats, plan(np.concatenate([
            rng.integers(0, n - kmer + 1, 3000),
            dense_starts(n // 2, 1000)]).astype(np.int32), n, split=True)),
    }
    for name, t in odd.items():
        gplans[name] = (t, plan(rng.integers(0, n_odd - kmer + 1, 300)
                                .astype(np.int32), n_odd))
    cb = np.array([-7, n - block + 5, 100, 1 << 30], np.int32)
    cr = rng.integers(0, block - kmer + 1, (4, group))
    cr[:, :3] = (-3, block - kmer + 1, 1 << 20)
    gplans["clamp"] = (feats, (cb, cr.astype(np.int32)))
    for name, (t, (bases, rels)) in gplans.items():
        bd, rd = i32(bases), i32(rels)
        check_equal(f"group_windows ({name})",
                    G.group_windows(t, bd, rd, group, block, kmer),
                    G.group_windows_plain(t, bd, rd, group, block, kmer))
    print(f"[kernels] group_windows bit-exact vs plain in {len(gplans)} "
          f"cases ({', '.join(gplans)})")

    # -- window_slices: random starts with the first and last legal ones,
    # spp 8 and 64, odd tables, out-of-contract starts
    starts = rng.integers(0, n - kmer + 1, b).astype(np.int32)
    starts[:2] = (0, n - kmer)
    sd = i32(starts)
    clamp = np.array([-5, -1000, n - kmer + 1, 1 << 30, 7, 0, 3, 9] * 8,
                     np.int32)
    scases = {f"spp {spp}": (feats, sd, spp) for spp in (8, 64)}
    for name, t in odd.items():
        scases[name] = (t, i32(rng.integers(0, n_odd - kmer + 1, 64)), 8)
    scases["clamp"] = (feats, i32(clamp), 64)
    for name, (t, s, spp) in scases.items():
        check_equal(f"window_slices ({name})",
                    G.window_slices(t, s, kmer, spp=spp),
                    G.window_slices_plain(t, s, kmer))
    print(f"[kernels] window_slices bit-exact vs plain in {len(scases)} "
          f"cases ({', '.join(scases)})")

    # -- window_rows: random starts with the last legal one, mixed strands
    # (the microbenchmark's case; and all forward, all reverse), an aligned
    # 8-channel table of odd row count with its odd last legal start,
    # out_rows of one box and of two boxes not filled (R = 32 and 168), 8
    # sites (fewer than the CTAs), 1544 sites (a short last chunk of the
    # TMA route's site order), odd tables (the scalar route),
    # out-of-contract starts
    G.window_rows.launches = 0
    rstarts = rng.integers(0, n - fetch + 1, b).astype(np.int32)
    rstarts[:2] = (0, n - fetch)
    rs = i32(rstarts)
    is_rev = rng.integers(0, 2, b).astype(np.int32)
    rv = i32(is_rev)
    rcases = {"mixed": (feats, feats_r, rs, rv, fetch, kmer),
              "forward": (feats, feats_r, rs, torch.zeros_like(rv), fetch,
                          kmer),
              "reverse": (feats, feats_r, rs, torch.ones_like(rv), fetch,
                          kmer)}
    odd8 = [torch.from_numpy(rng.standard_normal((n_odd, 8), dtype=np.float32)
                             ).to(dev) for _ in range(2)]
    ostarts = rng.integers(0, n_odd - fetch + 1, 64).astype(np.int32)
    ostarts[:4] = (n_odd - fetch, n_odd - fetch - 1, 1, 0)
    rcases["odd rows"] = (*odd8, i32(ostarts), i32(rng.integers(0, 2, 64)),
                          fetch, kmer)
    rcases["out_rows 29"] = (feats, feats_r, rs, rv, 64, 29)
    rcases["out_rows 333"] = (feats, feats_r, rs, rv, fetch, 333)
    rcases["8 sites"] = (feats, feats_r, rs[-8:], rv[-8:], fetch, kmer)
    rcases["1544 sites"] = (feats, feats_r, rs[:1544], rv[:1544], fetch, kmer)
    for name, t in odd.items():
        rcases[name] = (t, odd_r[name],
                        i32(rng.integers(0, n_odd - fetch + 1, 64)),
                        i32(rng.integers(0, 2, 64)), fetch, kmer)
    rcases["clamp"] = (feats, feats_r,
                       i32(np.array([-5, n - fetch + 3, 1 << 30, -1] * 2)),
                       i32([0, 1, 0, 1, 1, 0, 1, 0]), fetch, kmer)
    routes = {}
    for name, (d, dr, s, r, f, o) in rcases.items():
        got = G.window_rows(d, dr, s, r, f, o)
        check_equal(f"window_rows ({name})", got,
                    G.window_rows_plain(d, dr, s, r, f, o))
        routes[name] = G.window_rows_route(d.shape[1], o, d.data_ptr(),
                                           dr.data_ptr(), got.data_ptr())
    print(f"[kernels] window_rows bit-exact vs plain in {len(rcases)} cases, "
          f"route: " + ", ".join(f"{k} {v}" for k, v in routes.items()))
    if routes["mixed"] != "tma":
        raise AssertionError(f"window_rows took the {routes['mixed']} route "
                             f"at the microbenchmark's shape, not tma")
    probe_window_rows.dram_probe(dev)

    # -- timings at the microbenchmark's shape.  The library yardstick is
    # the faster of two single PyTorch calls over precomputed indices
    # (index_select of whole rows, torch.take of elements), each checked
    # equal to the plain version
    def library(table, rows, n_out, want):
        flat = rows.reshape(-1)
        elems = (flat[:, None] * table.shape[1]
                 + torch.arange(table.shape[1], device=dev)).view(
                     -1, n_out, table.shape[1])
        calls = {"index_select": lambda: table.index_select(0, flat),
                 "torch.take": lambda: torch.take(table, elems)}
        times = {}
        for name, fn in calls.items():
            check_equal(f"{name} yardstick",
                        fn().view(-1, n_out, table.shape[1]), want)
            times[name] = cuda_ms(fn, iters=10)
        best = min(times, key=times.get)
        return times[best], best, times

    def row(name, line, ms, plain_ms, lib, moved, what):
        library_ms, library, lib_times = lib
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        print(f"[kernels] {name} at {b} sites over ({n}, 8): {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in lib_times.items())
              + f", bound {bound_ms:.4f} ms ({moved} B at 3.35 TB/s: {what})")
        return {"name": name, "route": "cuda",
                "source": "hifimeth_tpu_torch/ops/csrc/row_windows.cu",
                "replaces": f"hifimeth_tpu/ops/gather.py:{line}",
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": library_ms, "library": library}

    rows = []
    out_bytes = b * kmer * 8 * 4
    bases, rels = micro
    bd, rd = i32(bases), i32(rels)
    gstarts = (bases.astype(np.int64)[:, None] + rels).ravel()
    want = G.group_windows_plain(feats, bd, rd, group, block, kmer)
    rows.append(row(
        "group_windows", 197,
        cuda_ms(lambda: G.group_windows(feats, bd, rd, group, block, kmer)),
        cuda_ms(lambda: G.group_windows_plain(feats, bd, rd, group, block,
                                              kmer), iters=10),
        library(feats, torch.from_numpy(gstarts).to(dev)[:, None]
                + torch.arange(kmer, device=dev), kmer, want),
        out_bytes + covered_rows(gstarts, kmer, n) * 32 + bases.nbytes
        + rels.nbytes, "windows out, distinct rows in, plan"))
    want = G.window_slices_plain(feats, sd, kmer)
    rows.append(row(
        "window_slices", 134,
        cuda_ms(lambda: G.window_slices(feats, sd, kmer)),
        cuda_ms(lambda: G.window_slices_plain(feats, sd, kmer), iters=10),
        library(feats, sd.long()[:, None] + torch.arange(kmer, device=dev),
                kmer, want),
        out_bytes + covered_rows(starts, kmer, n) * 32 + starts.nbytes,
        "windows out, distinct rows in, starts"))
    want = G.window_rows_plain(feats, feats_r, rs, rv, fetch, kmer)
    both = torch.cat([feats, feats_r])
    rev = is_rev.astype(bool)
    rows.append(row(
        "window_rows", 81,
        cuda_ms(lambda: G.window_rows(feats, feats_r, rs, rv, fetch, kmer)),
        cuda_ms(lambda: G.window_rows_plain(feats, feats_r, rs, rv, fetch,
                                            kmer), iters=10),
        library(both, (rs.long() + n * rv.long())[:, None]
                + 2 * torch.arange(kmer, device=dev), kmer, want),
        out_bytes + (covered_rows(rstarts[~rev], kmer, n, 2)
                     + covered_rows(rstarts[rev], kmer, n, 2)) * 32
        + rstarts.nbytes + is_rev.nbytes,
        "windows out, distinct rows of both tables in, starts, strands"))
    # the floor of a DRAM that moves 64-byte bursts: row s + 2j lies in
    # 64-byte pair s // 2 + j, whichever half it is
    pairs = (out_bytes + (covered_rows(rstarts[~rev] >> 1, kmer, n // 2)
                          + covered_rows(rstarts[rev] >> 1, kmer, n // 2))
             * 64 + rstarts.nbytes + is_rev.nbytes)
    pairs_ms = pairs / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] window_rows ({routes['mixed']} route): "
          f"{100 * rows[-1]['bound_ms'] / rows[-1]['ms']:.1f}% of the "
          f"32-byte bound; 64-byte pair count {pairs} B = {pairs_ms:.4f} ms "
          f"({100 * pairs_ms / rows[-1]['ms']:.1f}% of it)")
    rows[-1]["path"] = ("none: no path of the repository calls window_rows; "
                        "launches are this phase's")
    rows[-1]["launches"] = G.window_rows.launches
    return rows


def read_tags(path):
    from hifimeth_tpu_torch.io.bam import BamReader
    out = []
    for rec in BamReader(path):
        mm, ml, mn = (rec.get_tag(t) for t in ("MM", "ML", "MN"))
        out.append((rec.qname, mm[1] if mm else None,
                    ml[1][1] if ml else None, mn[1] if mn else None))
    return out


def compare(path_a, path_b, label, mode="contract"):
    """Two outputs: same records in order, MM/MN byte-equal, and ML by
    `mode`: "contract" within +-1 with at most 5% of ML bytes off, "equal"
    byte-equal, "bf16-gate" (bf16 against float32) inside BF16_GATE with
    a mean of at least BF16_FLOOR_MEAN, "bf16" as "bf16-gate" and no wider
    than BF16_BAND in mean and share off by more than 3 (its max, one
    site's extreme, is printed beside the band's), "bf16-device" (bf16 on
    two devices) inside BF16_DEVICE."""
    import numpy as np
    a, b = read_tags(path_a), read_tags(path_b)
    if [x[0] for x in a] != [x[0] for x in b]:
        raise AssertionError(f"{label}: records differ in order")
    n_off = n_tot = max_d = sum_d = n_gt3 = 0
    for (q, mm, ml, mn), (_, mm2, ml2, mn2) in zip(a, b):
        if mm != mm2 or mn != mn2 or (ml is None) != (ml2 is None):
            raise AssertionError(f"{label}: {q}: MM/MN differ")
        if ml is None:
            continue
        if len(ml) != len(ml2):
            raise AssertionError(f"{label}: {q}: ML lengths differ")
        d = np.abs(ml.astype(int) - ml2.astype(int))
        max_d = max(max_d, int(d.max()) if len(d) else 0)
        n_off += int((d > 0).sum())
        n_gt3 += int((d > 3).sum())
        sum_d += int(d.sum())
        n_tot += len(d)
    mean_d = sum_d / max(n_tot, 1)
    share_gt3 = n_gt3 / max(n_tot, 1)
    print(f"[{label}] {len(a)} reads, {n_tot} ML bytes: MM/MN equal, "
          f"{n_off} ML bytes off, max |diff| {max_d}, mean |diff| {mean_d}, "
          f"share > 3 {share_gt3}"
          + (f" (JAX package's bf16 band: max {BF16_BAND['max']}, mean "
             f"{BF16_BAND['mean']}, share > 3 {BF16_BAND['share_gt3']})"
             if mode == "bf16" else ""))
    if n_tot == 0:
        raise AssertionError(f"{label}: no ML bytes")
    if mode == "equal" and n_off:
        raise AssertionError(f"{label}: {n_off} of {n_tot} ML bytes differ "
                             f"(must be byte-equal)")
    if mode == "contract" and (max_d > 1 or n_off > 0.05 * n_tot):
        raise AssertionError(f"{label}: ML max |diff| {max_d}, {n_off} of "
                             f"{n_tot} bytes off (contract: +-1, <= 5%)")
    if mode in ("bf16", "bf16-gate") and (max_d > BF16_GATE[0]
                                          or mean_d > BF16_GATE[1]):
        raise AssertionError(f"{label}: ML max |diff| {max_d}, mean "
                             f"{mean_d} (bench.py's bf16 gate: max "
                             f"{BF16_GATE[0]}, mean {BF16_GATE[1]})")
    if mode in ("bf16", "bf16-gate") and mean_d < BF16_FLOOR_MEAN:
        raise AssertionError(f"{label}: ML mean |diff| {mean_d} under "
                             f"{BF16_FLOOR_MEAN}: the run did not compute "
                             f"in bf16")
    if mode == "bf16-device" and (max_d > BF16_DEVICE[0]
                                  or mean_d > BF16_DEVICE[1]):
        raise AssertionError(f"{label}: ML max |diff| {max_d}, mean "
                             f"{mean_d} (limit for bf16 on two devices: "
                             f"max {BF16_DEVICE[0]}, mean {BF16_DEVICE[1]})")
    if mode == "bf16" and (mean_d > BF16_BAND["mean"]
                           or share_gt3 > BF16_BAND["share_gt3"]):
        raise AssertionError(f"{label}: ML mean |diff| {mean_d}, share > 3 "
                             f"{share_gt3}: wider than the JAX package's "
                             f"bf16 band {BF16_BAND}")


def kernel_wrappers():
    """Every kernel wrapper of the port by kernel name; each carries its
    launch count in `.launches`."""
    from hifimeth_tpu_torch.ops import conv, fused, gather
    return {"group_windows_t": gather.group_windows_t,
            "fused_forward": fused.fused_forward,
            "conv1d_relu": conv.conv1d_relu,
            "group_windows": gather.group_windows,
            "window_slices": gather.window_slices,
            "window_rows": gather.window_rows}


def reset_launches():
    from hifimeth_tpu_torch.engine import programs
    for fn in kernel_wrappers().values():
        fn.launches = 0
    programs.warmup_launches.clear()


def read_launches():
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def direct_convs(conv_impl):
    """conv1d_relu launches a program call (one forward of a net) under
    `conv_impl`: the convs of a shipped net that take the direct route
    (all eight; under "auto" all but those with Cin * K <= 256, the
    first and the last)."""
    from hifimeth_tpu_torch.model.cnn import load_params_npz, uses_im2col
    convs = load_params_npz(os.path.join(ROOT, "models", "CpG.npz"))["convs"]
    return sum(not uses_im2col(conv_impl, c["w"].shape[1], c["w"].shape[0])
               for c in convs)


def run_main(big, out, label, fields, td, devices=None):
    """One main-path run of `call` with CallConfig `fields` (and the
    engine's device list `devices`); every kernel's count is set to 0 just
    before it and read just after, and so is the peak device memory.
    Returns the launch counts and the run's stats JSON, with its sites/s,
    its launches and its peak device memory (MiB allocated, reserved).
    On the planned paths the engine's `batches` count must equal the
    launches of the path's kernel (one a program call), and on every path
    that runs the convolution kernel its launches must be direct_convs of
    its route a program call.  On every path the flush-wide MM/ML builder
    must have made every called read's tags, in one call a flush."""
    import gc

    import torch
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call
    stats_json = os.path.join(td, f"stats.{label}.json")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stats = run_call(big, out, CallConfig(device="cuda", stats_json=stats_json,
                                          **fields), devices=devices)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    n_sites = sum(stats[c] for c in CONTEXTS)
    with open(stats_json) as f:
        run = json.load(f)
    run["sites_per_s"] = n_sites / secs
    run["launches"] = launches
    run["peak_mib"] = (torch.cuda.max_memory_allocated() / 2**20,
                       torch.cuda.max_memory_reserved() / 2**20)
    print(f"[main {label}] {stats['reads']} reads, {stats['bases']} bases, "
          f"{n_sites} sites ({', '.join(f'{c} {stats[c]}' for c in CONTEXTS)})"
          f" in {secs:.3f} s = {n_sites / secs:.1f} sites/s; launches "
          f"{launches}")
    print(f"[main {label}] engine timers (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run["timers"].items())
          + f"; schedule {run['schedule']}; config {run['config']}")
    gathers = launches["group_windows_t"] + launches["fused_forward"]
    if gathers and run["timers"]["batches"] != gathers:
        raise AssertionError(f"{label}: {run['timers']['batches']} batches "
                             f"counted, {gathers} kernel launches")
    convs = launches["conv1d_relu"]
    layers = direct_convs(fields.get("conv_impl", "direct"))
    if convs and convs != layers * run["timers"]["batches"]:
        raise AssertionError(f"{label}: {convs} conv1d_relu launches over "
                             f"{run['timers']['batches']} batches, not "
                             f"{layers} a batch")
    timers = run["timers"]
    if (timers["mmbuild_native"] != stats["called_reads"]
            or timers["mmbuild_calls"] != run["schedule"]["flushes"]):
        raise AssertionError(
            f"{label}: the flush-wide MM/ML builder made the tags of "
            f"{timers['mmbuild_native']} of {stats['called_reads']} called "
            f"reads in {timers['mmbuild_calls']} calls over "
            f"{run['schedule']['flushes']} flushes")
    recs = read_tags(out)
    n_ml = sum(len(ml) for _, _, ml, _ in recs if ml is not None)
    if len(recs) != 200 or any(mm is None for _, mm, _, _ in recs):
        raise AssertionError(f"{label} main path output lacks records or MM")
    if n_ml != n_sites:
        raise AssertionError(f"{label}: ML holds {n_ml} probabilities for "
                             f"{n_sites} sites")
    return launches, run


def run_microbench():
    """The window-fetch microbenchmark's main function, every variant at
    --nb 2 and its default shape; every kernel's count is set to 0 just
    before it and read just after.  Returns the launch counts."""
    import microbench_torch_gather as mb
    import torch
    reset_launches()
    t0 = time.perf_counter()
    mb.main(["--variants", ",".join(mb.VARIANTS), "--nb", "2"])
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[microbench] every variant in {time.perf_counter() - t0:.3f} s; "
          f"launches {launches}")
    return launches


def record_bytes(path):
    from hifimeth_tpu_torch.io.bam import BamReader
    return [rec.to_bytes() for rec in BamReader(path)]


def same_records(path_a, path_b, label):
    """Every record of two outputs byte-equal, in order (the headers' @PG
    command lines may differ)."""
    a, b = record_bytes(path_a), record_bytes(path_b)
    if not a or a != b:
        raise AssertionError(f"{label}: {len(a)} and {len(b)} records, not "
                             f"byte-equal")
    print(f"[{label}] {len(a)} records byte-equal")


def check_launches(label, got, want):
    """A phase-5 call run launched each kernel of `want` and no other."""
    for kernel in want:
        if got[kernel] <= 0:
            raise AssertionError(f"the {label} run launched {kernel} no time")
    other = {k: v for k, v in got.items() if k not in want and v}
    if other:
        raise AssertionError(f"the {label} run launched another kernel "
                             f"({other})")


def same_golden_beds(prefix, label):
    for ctx in CONTEXTS:
        with open(f"{prefix}.{ctx}.cov.bed", "rb") as f:
            got = f.read()
        with open(os.path.join(ROOT, "tests", "data",
                               f"golden_pileup.{ctx}.cov.bed"), "rb") as f:
            want = f.read()
        if got != want:
            raise AssertionError(f"{label}: {ctx} BED differs from the "
                                 f"golden corpus")
    print(f"[{label}] CpG/CHG/CHH BEDs byte-equal to the golden corpus")


def check_conv_impl(runs):
    """Phase 4's conv_impl lines: the im2col and auto runs' sites/s and
    peak device memory beside their direct runs', and an im2col forward on
    the card with TF32 switched on, which must raise (the route runs its
    products in full float32 only)."""
    import torch
    from hifimeth_tpu_torch.model.cnn import load_model_npz
    for label, ref in (("pallas-im2col", "pallas"), ("slice-auto", "slice")):
        a, b = runs[label], runs[ref]
        print(f"[conv_impl {label}] sites/s {a['sites_per_s']:.1f} against "
              f"{b['sites_per_s']:.1f} direct; peak device memory "
              f"{a['peak_mib'][0]:.1f} MiB allocated, {a['peak_mib'][1]:.1f} "
              f"MiB reserved against {b['peak_mib'][0]:.1f} and "
              f"{b['peak_mib'][1]:.1f} direct")
    model = load_model_npz(os.path.join(ROOT, "models", "CpG.npz"), "cuda",
                           conv_impl="im2col")
    x = torch.zeros((2, 8, 401), device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            model(x)
    except RuntimeError as e:
        print(f"[conv_impl] im2col with TF32 on raises: {e}")
    else:
        raise AssertionError("an im2col forward ran with TF32 on")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_scale_out(big, td, runs):
    """Phase 5 (see the module notes); `runs` holds phase 3's stats."""
    import socket

    import torch
    import torch.distributed as dist
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call
    from hifimeth_tpu_torch.parallel import collectives
    from hifimeth_tpu_torch.parallel.dist import ShardSpec, merge_shard_bams
    from hifimeth_tpu_torch.quant.pileup import (merge_pileup_shards,
                                                 run_pileup,
                                                 run_pileup_multihost)
    from hifimeth_tpu_torch.tools.corr import run_corr
    from hifimeth_tpu_torch.tools.cov2bed import run_cov2bed

    t_phase = time.perf_counter()
    data = os.path.join(ROOT, "tests", "data")
    pallas = os.path.join(td, "big.pallas.bam")

    def out(name):
        return os.path.join(td, f"big.{name}.bam")

    # call --data-parallel on one card: the single-device path (found
    # alone where the host has one card, named where it has more)
    one = None if torch.cuda.device_count() == 1 else ["cuda:0"]
    got, run = run_main(big, out("dp"), "pallas-data-parallel",
                        dict(gather_impl="pallas", data_parallel=True), td,
                        devices=one)
    check_launches("pallas-data-parallel", got, PALLAS)
    if run["config"]["devices"] != ["cuda:0"]:
        raise AssertionError(f"--data-parallel on one card ran over "
                             f"{run['config']['devices']}")
    same_records(out("dp"), pallas, "pallas-data-parallel-vs-pallas")
    print(f"[scale-out] sites/s: pallas {runs['pallas']['sites_per_s']:.1f},"
          f" pallas --data-parallel (one card) {run['sites_per_s']:.1f}")
    # the split over two replicas on the one card
    for impl, kernels in (("pallas", PALLAS), ("slice", CNN)):
        label = f"{impl}-split"
        got, run = run_main(big, out(label), label, dict(
            gather_impl=impl, data_parallel=True), td,
            devices=["cuda:0", "cuda:0"])
        check_launches(label, got, kernels)
        if run["config"]["devices"] != ["cuda:0", "cuda:0"]:
            raise AssertionError(f"{label} ran over "
                                 f"{run['config']['devices']}")
        runs[label] = run
        if impl == "pallas":
            same_records(out(label), pallas, f"{label}-vs-pallas")
        else:
            compare(out(label), out("slice"), f"{label}-vs-slice")
        print(f"[scale-out] {label} sites/s {run['sites_per_s']:.1f}")
    # shards 0/2 and 1/2 of SHARD_BLOCK-read blocks, then their merge
    sharded = out("sharded")
    for pid in range(2):
        reset_launches()
        t0 = time.perf_counter()
        run_call(big, sharded, CallConfig(device="cuda"),
                 shard=ShardSpec(pid, 2, batch_size=SHARD_BLOCK))
        torch.cuda.synchronize()
        got = read_launches()
        check_launches(f"shard {pid}/2", got, PALLAS)
        print(f"[scale-out] call shard {pid}/2 in "
              f"{time.perf_counter() - t0:.3f} s; launches {got}")
    merge_shard_bams(out("merged"), [sharded + ".shard0000",
                                     sharded + ".shard0001"],
                     batch_size=SHARD_BLOCK)
    same_records(out("merged"), pallas, "shards-merged-vs-pallas")
    # a one-rank NCCL group: the collectives on the card, pileup over it
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        import numpy as np
        if collectives._group_device().type != "cuda":
            raise AssertionError("the NCCL group's tensors are not on the "
                                 "card")
        rng = np.random.default_rng(0)
        bins = rng.integers(0, 1 << 40, (3, 256))
        flags = rng.integers(0, 2, 9)
        parts = [rng.integers(0, 1 << 20, 1 << 22).astype(np.int32)
                 for _ in range(3)]
        if not (np.array_equal(collectives.psum_histograms_multihost(bins),
                               bins)
                and np.array_equal(collectives.psum_i64_multihost(flags),
                                   flags)
                and all(np.array_equal(g, w) for g, w in zip(
                    collectives.psum_site_partials_multihost(*parts),
                    parts))):
            raise AssertionError("a one-rank NCCL collective is not the "
                                 "identity")
        print("[scale-out] NCCL (one rank): int64 SUM (3, 256) and (9,), "
              "int32 SUM (2, 4 Mi) and MAX (4 Mi) on cuda tensors: identity")
        prefix = os.path.join(td, "mh")
        res = run_pileup_multihost(
            os.path.join(data, "golden_ref.fa"),
            os.path.join(data, "golden_mapped.bam"), prefix,
            ShardSpec(0, 1), spill_dir=td)
        merge_pileup_shards(prefix, 1)
        same_golden_beds(prefix, f"pileup over NCCL ({res['bed_rows']} rows)")
    finally:
        dist.destroy_process_group()
    # the host tools against the golden corpus
    prefix = os.path.join(td, "one")
    run_pileup(os.path.join(data, "golden_ref.fa"),
               os.path.join(data, "golden_mapped.bam"), prefix, spill_dir=td)
    same_golden_beds(prefix, "pileup")
    for ctx in CONTEXTS:
        bed = os.path.join(td, f"c.{ctx}.bed")
        run_cov2bed(os.path.join(data, "golden_ref.fa"), ctx,
                    os.path.join(data, "golden_bismark.cov"), bed)
        with open(bed, "rb") as f, open(os.path.join(
                data, f"golden_cov2bed.{ctx}.bed"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"cov2bed {ctx} differs from the "
                                     f"golden corpus")
    r = run_corr(os.path.join(data, "golden_pileup.CpG.cov.bed"),
                 os.path.join(data, "golden_cov2bed.CpG.bed"), min_cov=1)
    with open(os.path.join(data, "golden_corr.txt")) as f:
        if f"{r:.10f}\n" != f.read():
            raise AssertionError(f"corr {r} differs from the golden corpus")
    print("[scale-out] cov2bed CpG/CHG/CHH and corr equal to the golden "
          "corpus")
    print(f"[phase 5] scale-out and quantification in "
          f"{time.perf_counter() - t_phase:.3f} s wall")


# -- phase 6: the model lifecycle ---------------------------------------------

def phase_onnx(td):
    """Each shipped model exported to ONNX by the port and imported back
    (load_reference_onnx, and import_models over the directory): every
    array bit-equal to the npz's."""
    import numpy as np
    from hifimeth_tpu_torch.engine.call import default_model_dir
    from hifimeth_tpu_torch.model.cnn import (load_params_npz,
                                              load_reference_onnx,
                                              params_to_numpy)
    from hifimeth_tpu_torch.model.onnx_export import export_onnx
    from hifimeth_tpu_torch.tools.import_model import import_models

    src = os.path.join(td, "onnx")
    os.makedirs(src)
    dst = os.path.join(td, "imported")
    want = {}
    for ctx in CONTEXTS:
        with np.load(os.path.join(default_model_dir(), f"{ctx}.npz")) as z:
            want[ctx] = {k: z[k] for k in z.files}
        export_onnx(load_params_npz(os.path.join(default_model_dir(),
                                                 f"{ctx}.npz")),
                    os.path.join(src, f"{ctx}.onnx"))
    import_models(src, dst)
    for ctx in CONTEXTS:
        with np.load(os.path.join(dst, f"{ctx}.npz")) as z:
            imported = {k: z[k] for k in z.files}
        direct = params_to_numpy(load_reference_onnx(
            os.path.join(src, f"{ctx}.onnx")))
        for got in (imported, direct):
            if sorted(got) != sorted(want[ctx]) or any(
                    got[k].dtype != w.dtype or got[k].tobytes() != w.tobytes()
                    for k, w in want[ctx].items()):
                raise AssertionError(f"{ctx}: the ONNX round trip is not "
                                     f"bit-equal to the npz")
    print(f"[lifecycle] export-model + import-model of {', '.join(CONTEXTS)}:"
          f" every array bit-equal to the shipped npz")


def read_kinetics(rng, meth, pos, length):
    """Native-forward codeV1 kinetics (fi, fp, ri, rp) with IPD/PW raised
    by 120 within 3 bases of each methylated C: the learnable signal of
    tests/test_train_e2e.py."""
    import numpy as np
    ks = [rng.integers(20, 90, length).astype(np.uint8) for _ in range(4)]
    for q in np.flatnonzero(meth[pos:pos + length]):
        lo, hi = max(0, q - 3), min(length, q + 4)
        for a in ks:
            a[lo:hi] = np.minimum(a[lo:hi].astype(np.int32) + 120, 255)
    return ks


def make_world(td, seed=5):
    """Phase 6's seeded world (tests/test_train_e2e.py's, scaled up): a
    uniform random genome with half of its CpGs methylated, a Bismark BED of
    labels (cov 12 at 0% or 100%), WORLD_TRAIN mapped kinetics reads and
    WORLD_HELD unmapped held-out reads of WORLD_RLEN bases.  Returns the
    paths, the methylation map and the held-out reads' positions."""
    import numpy as np
    from hifimeth_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter

    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), WORLD_GLEN)
    cpg = np.flatnonzero((genome[:-1] == ord("C")) & (genome[1:] == ord("G")))
    meth = np.zeros(WORLD_GLEN, bool)
    meth[cpg[rng.random(len(cpg)) < 0.5]] = True
    fasta = os.path.join(td, "world.fa")
    with open(fasta, "w") as f:
        g = genome.tobytes().decode()
        f.write(">chr1\n" + "".join(g[i:i + 70] + "\n"
                                    for i in range(0, WORLD_GLEN, 70)))
    bed = os.path.join(td, "world.labels.bed")
    with open(bed, "w") as f:
        for p in cpg:
            f.write(f"chr1\t{p}\t{p + 1}\t100\t12\t0\tCG\n" if meth[p]
                    else f"chr1\t{p}\t{p + 1}\t0\t0\t12\tCG\n")

    def write_reads(path, n, mapped, tag):
        hdr = (BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", WORLD_GLEN)])
               if mapped else BamHeader("@HD\tVN:1.6\tSO:unknown\n", []))
        poss = np.sort(rng.integers(0, WORLD_GLEN - WORLD_RLEN, n))
        with BamWriter(path, hdr, threads=4, level=1) as w:
            for i, pos in enumerate(poss):
                if mapped:
                    rec = BamRecord(qname=f"{tag}{i}", flag=0, refid=0,
                                    pos=int(pos), mapq=60)
                    rec.set_cigar_str(f"{WORLD_RLEN}M")
                else:
                    rec = BamRecord(qname=f"{tag}{i}", flag=4)
                rec.set_seq(genome[pos:pos + WORLD_RLEN].tobytes())
                for t, a in zip(("fi", "fp", "ri", "rp"), read_kinetics(
                        rng, meth, int(pos), WORLD_RLEN)):
                    rec.set_tag(t, "B", ("C", a))
                rec.set_tag("fn", "C", 5)
                rec.set_tag("rn", "C", 5)
                w.write(rec)
        return poss

    train_bam = os.path.join(td, "world.train.bam")
    held_bam = os.path.join(td, "world.held.bam")
    write_reads(train_bam, WORLD_TRAIN, True, "t")
    held_pos = write_reads(held_bam, WORLD_HELD, False, "h")
    return fasta, bed, train_bam, held_bam, meth, held_pos


def run_steps(blob, cfg, init, layout=None):
    """The first PARITY_STEPS steps of train_context's schedule from the
    weights `init`; returns each step's (loss, acc) and the (params,
    state) after the first step and after the last."""
    import numpy as np
    from hifimeth_tpu_torch.train.trainer import TrainStep, float32_scope
    with float32_scope():
        tr = TrainStep(cfg, blob.planes_t, *init, layout=layout)
        order = np.random.default_rng(cfg.seed).permutation(blob.n_samples)
        metrics, trees = [], []
        for i in range(PARITY_STEPS):
            metrics.append(tr.step(blob, order[i * cfg.batch_size:
                                               (i + 1) * cfg.batch_size])
                           .tolist())
            if i in (0, PARITY_STEPS - 1):
                trees.append(tr.jax_params())
        return metrics, trees


def tree_leaves(*trees):
    """The arrays of equal-shaped pytrees (dicts, lists, tuples), zipped."""
    import numpy as np
    if isinstance(trees[0], dict):
        return [x for k in trees[0] for x in tree_leaves(*(t[k] for t in trees))]
    if isinstance(trees[0], (list, tuple)):
        return [x for parts in zip(*trees) for x in tree_leaves(*parts)]
    return [tuple(np.asarray(t, np.float64) for t in trees)]


def steps_close(label, got, want, init):
    """Two runs of the first steps from the weights `init` within the
    STEP_* tolerances: each step's loss, and each parameter and BN
    statistic after the first and after the last step, whose max |diff| is
    held against that array's largest change from `init` (STEP_SHARE).
    Float32 sums taken in another order move a few ReLUs across zero and
    each step spreads that, so the arrays are held relative to the
    training's own movement, which a wrong update term (rate, momentum,
    batch statistics) changes by a large part."""
    import numpy as np
    (gm, gtrees), (wm, wtrees) = got, want
    loss_d = max(abs(a[0] - b[0]) for a, b in zip(gm, wm))
    shares, diffs = [], []
    for g, w in zip(gtrees, wtrees):
        leaves = tree_leaves(g, w, init)
        shares.append(max(float(np.abs(a - b).max()
                                / max(np.abs(b - i).max(), 1e-12))
                          for a, b, i in leaves))
        diffs.append(max(float(np.abs(a - b).max()) for a, b, _ in leaves))
    print(f"[lifecycle] {label}: losses {[m[0] for m in gm]} vs "
          f"{[m[0] for m in wm]} (max |diff| {loss_d}, limit "
          f"{STEP_LOSS_TOL}); params and BN state max |diff| after step 1 "
          f"{diffs[0]}, after step {PARITY_STEPS} {diffs[1]}; at most "
          f"{shares[0]:.5f} and {shares[1]:.5f} of an array's change "
          f"(limits {STEP_SHARE[0]} and {STEP_SHARE[1]})")
    if loss_d > STEP_LOSS_TOL or any(a > b for a, b in zip(shares,
                                                            STEP_SHARE)):
        raise AssertionError(f"{label}: the first steps disagree beyond "
                             f"the tolerance")


def profile_steps(blob, cfg, init, card):
    """PROFILE_STEPS steady training steps on the card (after 3 warm-up
    steps) under torch.profiler, device activity only: wall and device
    busy ms per step (the union of the kernels' and copies' intervals),
    the idle share, and the kernels that take the most device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hifimeth_tpu_torch.parallel.mesh import TrainLayout
    from hifimeth_tpu_torch.train.trainer import TrainStep, float32_scope
    with float32_scope():
        tr = TrainStep(cfg, blob.planes_t, *init, layout=TrainLayout())
        order = np.random.default_rng(0).permutation(blob.n_samples)
        batches = [order[i * cfg.batch_size:(i + 1) * cfg.batch_size]
                   for i in range(PROFILE_STEPS + 3)]
        for b in batches[:3]:
            tr.step(blob, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[3:]:
                tr.step(blob, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    spans, by_kernel = [], {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            by_kernel[ev.name] = (by_kernel.get(ev.name, 0.0)
                                  + ev.time_range.elapsed_us())
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    n = PROFILE_STEPS
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"[lifecycle] {n} profiled steps on {card}: wall "
          f"{wall / n * 1e3:.4f} ms a step, device busy "
          f"{busy_us / n / 1e3:.4f} ms a step (idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}%), {len(spans) // n} "
          f"kernels and copies a step; top device ms a step: "
          + "; ".join(f"{us / n / 1e3:.4f} {name[:60]}" for name, us in top))


def held_out_auc(path, meth, held_pos):
    """Midrank AUC of the called CpG probabilities against the genome's
    methylation, and the number of sites."""
    import numpy as np
    from hifimeth_tpu_torch.features.read_decode import native_fwd_seq
    from hifimeth_tpu_torch.io.bam import BamReader
    from hifimeth_tpu_torch.io.mmtags import parse_mod_tags_flat
    from hifimeth_tpu_torch.tools.read_level_metrics import roc_auc
    y, p = [], []
    for i, rec in enumerate(BamReader(path)):
        qoffs, _strands, _codes, probs = parse_mod_tags_flat(
            rec, native_fwd_seq(rec))
        y += [bool(meth[held_pos[i] + q]) for q in qoffs]
        p += [pr / 255.0 for pr in probs]
    return roc_auc(np.asarray(y), np.asarray(p)), len(y)


def phase_lifecycle(td, card):
    """Phase 6 (see the module notes); `card` is nvidia-smi's name and power
    limit, printed beside the training's numbers."""
    import dataclasses
    import socket

    import torch
    import torch.distributed as dist
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call
    from hifimeth_tpu_torch.parallel.mesh import TrainLayout, train_layout
    from hifimeth_tpu_torch.tools.extract_features import run_extract_features
    from hifimeth_tpu_torch.train.data import load_feature_blob
    from hifimeth_tpu_torch.train.model import init_params
    from hifimeth_tpu_torch.train.trainer import TrainConfig, train_context

    t_phase = time.perf_counter()
    td = os.path.join(td, "lifecycle")
    os.makedirs(td)
    phase_onnx(td)
    t0 = time.perf_counter()
    fasta, bed, train_bam, held_bam, meth, held_pos = make_world(td)
    t_world = time.perf_counter() - t0
    prefix = os.path.join(td, "blob")
    t0 = time.perf_counter()
    res = run_extract_features(fasta, "CpG", bed, train_bam, prefix,
                               min_read_size=500)
    blob = load_feature_blob(f"{prefix}.features", f"{prefix}.samples",
                             f"{prefix}.offsets")
    print(f"[lifecycle] world {WORLD_GLEN} bp, {WORLD_TRAIN} + {WORLD_HELD} "
          f"reads of {WORLD_RLEN} in {t_world:.3f} s; extract-features: "
          f"{res['reads']} reads, {blob.n_samples} CpG samples ("
          f"{res['positives']} methylated) in {time.perf_counter() - t0:.3f} s")
    if blob.n_samples < TRAIN_MIN_SAMPLES:
        raise AssertionError(f"{blob.n_samples} samples, under "
                             f"{TRAIN_MIN_SAMPLES}")

    # the first steps: the card against the CPU, a one-rank NCCL group
    # against no group, all from the same carried weights
    cfg = TrainConfig(kmer=TRAIN_KMER, batch_size=TRAIN_BATCH,
                      epochs=TRAIN_EPOCHS, log_every=20, device="cuda")
    init = init_params(cfg.seed, kmer=cfg.kmer)
    card_run = run_steps(blob, cfg, init, TrainLayout())
    steps_close(f"card ({card}) vs CPU", card_run, run_steps(
        blob, dataclasses.replace(cfg, device="cpu"), init, TrainLayout()),
        init)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        layout = train_layout(cfg.n_model_shards, cfg.batch_size)
        steps_close(f"one-rank NCCL group vs no group ({card})",
                    run_steps(blob, cfg, init, layout), card_run, init)
    finally:
        dist.destroy_process_group()

    # the recipe on the card
    model_dir = os.path.join(td, "models")
    os.makedirs(model_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = train_context(blob, cfg, os.path.join(model_dir, "CpG.npz"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(model_dir, "kmer.txt"), "w") as f:
        f.write(f"{cfg.kmer}\n")
    steps = run["steps"]
    ms = {k: v / steps * 1e3 for k, v in run["timers"].items()}
    print(f"[lifecycle] train (kmer {cfg.kmer}, batch {cfg.batch_size}, "
          f"{cfg.epochs} epochs, recipe widths, float32 without TF32) on "
          f"{card}: {steps} steps in {run['wall_s']:.3f} s = "
          f"{steps * cfg.batch_size / run['wall_s']:.1f} samples/s; ms a "
          f"step on the card's stream between CUDA events (waits for the "
          f"host included): " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f" (sum {sum(ms.values()):.4f}); peak memory {peak} B; final "
          f"loss {run['final_loss']:.4f}, accuracy {run['final_acc']:.4f}")
    if not run["final_acc"] > MIN_FINAL_ACC:
        raise AssertionError(f"final accuracy {run['final_acc']} not above "
                             f"{MIN_FINAL_ACC}")
    profile_steps(blob, cfg, init, card)

    # the trained model serves the held-out reads through both kernels
    outs = {}
    for impl, kernels in (("pallas", PALLAS), ("fused", ("fused_forward",))):
        outs[impl] = os.path.join(td, f"held.{impl}.bam")
        reset_launches()
        t0 = time.perf_counter()
        run_call(held_bam, outs[impl], CallConfig(
            model_dir=model_dir, contexts=("CpG",), min_read_size=500,
            gather_impl=impl, device="cuda"))
        torch.cuda.synchronize()
        got = read_launches()
        check_launches(f"held-out {impl}", got, kernels)
        auc, n = held_out_auc(outs[impl], meth, held_pos)
        print(f"[lifecycle] call --gather-impl {impl} of the held-out reads "
              f"with the trained model on {card} in "
              f"{time.perf_counter() - t0:.3f} s: "
              f"{n} CpG sites, AUC {auc:.4f}; launches {got}")
        if not auc > MIN_HELD_AUC:
            raise AssertionError(f"held-out AUC {auc} through {impl} not "
                                 f"above {MIN_HELD_AUC}")
    compare(outs["fused"], outs["pallas"], "held-out fused-vs-pallas")
    print(f"[phase 6] model lifecycle in {time.perf_counter() - t_phase:.3f} "
          f"s wall")


# -- phase 7: the pipeline trace, the weight cache, the per-site call ---------

#: the trace's stages of one flush, in pipeline order
TRACE_STAGES = ("flush", "dispatch0", "dispatch1", "resolve0", "resolve1",
                "emit0", "emit1")
#: the per-flush intervals phase 7 prints: name -> (from, to) stages
TRACE_SPANS = {"queue wait": ("flush", "dispatch0"),
               "dispatch": ("dispatch0", "dispatch1"),
               "to resolve": ("dispatch1", "resolve0"),
               "resolve": ("resolve0", "resolve1"),
               "emit": ("emit0", "emit1")}
#: reference per-site call on the card: sites, table lanes, read lengths
REF_SITES = 16384
REF_LANES = 1 << 21


def trace_rows(err, flushes, label):
    """The `[trace flush N]` lines of a run's stderr -> one {stage: s} per
    flush; fails unless there is one line per flush of the run's schedule,
    numbered in order, each with the seven stages in order at
    non-decreasing times."""
    import re
    rows = []
    for line in err.splitlines():
        m = re.match(r"^\[trace flush (\d+)\] (.*)$", line)
        if m:
            ev = [e.split("@") for e in m.group(2).split()]
            times = [float(t) for _, t in ev]
            if (int(m.group(1)) != len(rows)
                    or tuple(s for s, _ in ev) != TRACE_STAGES
                    or times != sorted(times)):
                raise AssertionError(f"{label}: bad trace line {line!r}")
            rows.append(dict(zip(TRACE_STAGES, times)))
    if len(rows) != flushes:
        raise AssertionError(f"{label}: {len(rows)} trace lines for "
                             f"{flushes} flushes")
    return rows


def phase_trace(big, td, runs):
    """The traced runs of phase 7; `runs` holds phase 3's stats."""
    import contextlib
    import io

    import numpy as np
    kernels = {"pallas": PALLAS, "fused": ("fused_forward",)}
    for workers in (-1, 0):
        for impl, wanted in kernels.items():
            base = impl
            if workers == 0:
                base = f"{impl}-inline"
                got, runs[base] = run_main(
                    big, os.path.join(td, f"big.{base}.bam"), base,
                    dict(gather_impl=impl, decode_workers=0), td)
                check_launches(base, got, wanted)
                same_records(os.path.join(td, f"big.{base}.bam"),
                             os.path.join(td, f"big.{impl}.bam"),
                             f"{base}-vs-{impl}")
            label = f"{base}-traced"
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                got, run = run_main(big, os.path.join(td, f"big.{label}.bam"),
                                    label, dict(gather_impl=impl,
                                                decode_workers=workers,
                                                trace=True), td)
            check_launches(label, got, wanted)
            same_records(os.path.join(td, f"big.{label}.bam"),
                         os.path.join(td, f"big.{impl}.bam"),
                         f"{label}-vs-{impl}")
            rows = trace_rows(err.getvalue(), run["schedule"]["flushes"],
                              label)
            for line in err.getvalue().splitlines():
                if line.startswith("[trace flush"):
                    print(f"[trace {label}] {line}")
            spans = []
            for name, (a, b) in TRACE_SPANS.items():
                d = np.array([r[b] - r[a] for r in rows])
                spans.append(f"{name} median {np.median(d):.4f} s, total "
                             f"{d.sum():.3f} s")
            print(f"[trace {label}] {len(rows)} flushes (decode workers "
                  f"{run['config']['decode_workers']}), last emit at "
                  f"{rows[-1]['emit1']:.3f} s; " + "; ".join(spans))
            print(f"[trace {label}] sites/s traced {run['sites_per_s']:.1f},"
                  f" untraced {runs[base]['sites_per_s']:.1f}")


def phase_cache(td, dev="cuda"):
    """ModelSet.cached on the card: engines of one config share the
    weights' storage, a device named twice shares one set, and a model
    file rewritten to another size with its mtime put back reloads."""
    import shutil

    import numpy as np
    from hifimeth_tpu_torch.engine.call import (CallConfig, CallEngine,
                                                default_model_dir)

    def ptr(engine, fused=False):
        ms = engine.models
        return (ms.fused["CpG"].buf.data_ptr() if fused
                else ms.models["CpG"].convs[0].weight.data_ptr())

    engines = {}
    for impl in ("pallas", "fused"):
        cfg = CallConfig(device=dev, gather_impl=impl)
        a, b = engines[impl] = CallEngine(cfg), CallEngine(cfg)
        if a.models is not b.models or \
                ptr(a, impl == "fused") != ptr(b, impl == "fused"):
            raise AssertionError(f"two {impl} engines of one config do not "
                                 f"share their weights")
    twice = ["cuda:0", "cuda:0"] if dev == "cuda" else [dev, dev]
    dp = CallEngine(CallConfig(device=dev, data_parallel=True),
                    devices=twice)
    if (dp.replicas[0] is not dp.replicas[1]
            or dp.models is not engines["pallas"][0].models):
        raise AssertionError("replicas on one card do not share one set")
    md = os.path.join(td, "cache_models")
    shutil.copytree(default_model_dir(), md)
    cfg = CallConfig(device=dev, model_dir=md)
    prev = CallEngine(cfg)
    for name in ("kmer.txt", "CpG.npz"):
        p = os.path.join(md, name)
        st = os.stat(p)
        if name == "kmer.txt":
            with open(p, "w") as f:
                f.write(f" {prev.kmer}\n")
        else:
            with np.load(p) as z:
                arrays = {k: z[k] for k in z.files}
            with open(p, "wb") as f:
                np.savez(f, **arrays)
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns))
        if os.stat(p).st_size == st.st_size:
            raise AssertionError(f"{name} kept its size")
        eng = CallEngine(cfg)
        if eng.models is prev.models or ptr(eng) == ptr(prev):
            raise AssertionError(f"{name} rewritten to another size with "
                                 f"its mtime put back did not reload")
        prev = eng
    print("[cache] two pallas and two fused engines share weight storage; "
          "[cuda:0, cuda:0] shares one set; kmer.txt and CpG.npz rewritten "
          "to another size with the mtime put back each reload")


def phase_reference_call(dev="cuda"):
    """call_sites (the reference per-site path: one window per site by
    indexing, read bounds masked) against call_sites_group (the pallas
    path's planned call) on the card, same sites and model, within the
    parity contract."""
    import numpy as np
    import torch
    from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine
    from hifimeth_tpu_torch.features.windows import (call_sites,
                                                     call_sites_group,
                                                     featurize_planes_t)
    from hifimeth_tpu_torch.io import native
    from hifimeth_tpu_torch.ops.gather import (BLOCK_LANES, GROUP,
                                               PLAN_EXTENT, check_plan,
                                               plan_groups)

    rng = np.random.default_rng(11)
    kmer = 401
    gap = kmer // 2 + 16
    # reads packed as the engine packs them: a kmer margin, zero-feature
    # gaps (seq 255, kinetics 0) between reads
    planes = np.zeros((5, REF_LANES), np.uint8)
    planes[0] = 255
    bounds = []
    at = kmer
    while True:
        n = int(rng.integers(2000, 15000))
        if at + n > REF_LANES - kmer:
            break
        planes[0, at:at + n] = rng.choice(4, n, p=PLANT)
        planes[1:, at:at + n] = rng.integers(0, 256, (4, n))
        bounds.append((at, at + n))
        at += n + gap
    reads = rng.integers(0, len(bounds), REF_SITES)
    lo = np.array([bounds[r][0] for r in reads], np.int32)
    hi = np.array([bounds[r][1] for r in reads], np.int32)
    centers = (lo + (rng.random(REF_SITES) * (hi - lo)).astype(np.int32))
    centers = np.unique(centers).astype(np.int32)   # sorted, distinct
    order = np.searchsorted(np.array([b[0] for b in bounds]), centers,
                            side="right") - 1
    rstart = np.array([bounds[i][0] for i in order], np.int32)
    rend = np.array([bounds[i][1] for i in order], np.int32)
    strands = rng.integers(0, 2, len(centers)).astype(np.uint8)
    table_t = featurize_planes_t(torch.from_numpy(planes).to(dev))
    model = CallEngine(CallConfig(device=dev)).models.models["CpG"]
    with torch.inference_mode():
        ref = call_sites(model, table_t.T.contiguous(),
                         *(torch.from_numpy(a).to(dev) for a in (
                             centers, strands, rstart, rend))).cpu().numpy()
        got = np.empty(len(centers), np.uint8)
        for rev in (False, True):
            sel = np.flatnonzero(strands == int(rev))
            starts = (centers[sel] - kmer // 2).astype(np.int32)
            # the engine's plan (CallEngine._call_context) and resolve
            fast = native.plan_groups_fast(starts, GROUP, BLOCK_LANES,
                                           PLAN_EXTENT, REF_LANES)
            if fast is not None:
                b128, rels, idx = fast
            else:
                bases, rels, idx = plan_groups(starts, GROUP, BLOCK_LANES,
                                               kmer, REF_LANES,
                                               extent=PLAN_EXTENT)
                b128 = (bases // 128) * 128
                rels = rels + (bases - b128)[:, None]
            check_plan(b128, rels, REF_LANES, kmer)
            probs = call_sites_group(
                model, table_t, torch.from_numpy(b128.astype(np.int32)).to(dev),
                torch.from_numpy(rels.astype(np.int32)).to(dev), rev,
                kmer).cpu().numpy()
            if idx is None:
                got[sel] = probs[:len(sel)]
            else:
                part = np.empty(len(sel), np.uint8)
                part[idx.ravel()] = probs[:idx.size]
                got[sel] = part
    d = np.abs(got.astype(int) - ref.astype(int))
    print(f"[reference call] call_sites vs call_sites_group on the card: "
          f"{len(centers)} CpG-model sites over {len(bounds)} reads, "
          f"{int((d > 0).sum())} u8 off, max |diff| {int(d.max())}")
    if d.max() > 1 or (d > 0).sum() > 0.05 * len(d):
        raise AssertionError("call_sites and call_sites_group differ beyond "
                             "the parity contract")


# -- phase 8: graphs on the card -----------------------------------------------

#: phase 8's paths: label -> (CallConfig fields, the device list, the
#: kernels the run must launch, the run of phase 3 or 5 its records must
#: equal, the turns' graphs settings).  bf16 and the splits run one eager
#: turn: their graph turn is their run of phase 3 (bf16) or phase 5 (the
#: splits), graphs on by default there
GRAPH_RUNS = {
    "pallas": (dict(gather_impl="pallas"), None, PALLAS, "pallas",
               (False, True, True, False)),
    "fused": (dict(gather_impl="fused"), None, ("fused_forward",), "fused",
              (False, True, True, False)),
    "pallas-bf16": (dict(gather_impl="pallas", compute_dtype="bfloat16"),
                    None, PALLAS, "pallas-bf16", (False,)),
    "pallas-split": (dict(gather_impl="pallas", data_parallel=True),
                     ["cuda:0", "cuda:0"], PALLAS, "pallas", (False,)),
    "slice": (dict(gather_impl="slice"), None, CNN, "slice", (False, True)),
    "folded": (dict(gather_impl="folded"), None, CNN, "folded",
               (False, True)),
    "slice-split": (dict(gather_impl="slice", data_parallel=True),
                    ["cuda:0", "cuda:0"], CNN, "slice-split", (False,)),
}
#: each profiled path's wrappers, each with its device_profile class and
#: the names of the device kernels one launch of it runs (each once)
PROFILED = {
    "pallas": (("group_windows_t", "gather kernel", ("group_windows_kernel",)),
               ("conv1d_relu", "convolution", ("conv1d_relu_kernel",))),
    "fused": (("fused_forward", "fused kernel",
               ("fused_head_kernel", "fused_mid_kernel",
                "fused_tail_kernel")),),
}


def print_graph_turn(name, run, note):
    print(f"[graphs {name}] {note}; sites/s {run['sites_per_s']:.1f}, "
          f"capture {run['timers']['capture']:.4f} s (inside the run's "
          f"wall), peak device memory {run['peak_mib'][0]:.1f} MiB "
          f"allocated, {run['peak_mib'][1]:.1f} MiB reserved")


def phase_graphs(big, td, runs):
    """Phase 8 (see the module notes); `runs` holds phase 3's and phase
    5's stats."""
    import torch
    from profile_torch_call import device_profile

    from hifimeth_tpu_torch.engine.call import CallConfig, run_call
    t_phase = time.perf_counter()
    for label, (fields, devices, wanted, ref, turns) in GRAPH_RUNS.items():
        want = record_bytes(os.path.join(td, f"big.{ref}.bam"))
        phase = 5 if ref.endswith("-split") else 3
        counts = set()
        if len(turns) == 1:
            graph_run = runs[label]
            counts.add(tuple(graph_run["launches"][k] for k in wanted))
            print_graph_turn(f"{label}-graphs", graph_run,
                             f"phase {5 if devices else 3}'s run")
        for turn, graphs in enumerate(turns):
            name = f"{label}-{'graphs' if graphs else 'eager'}-{turn}"
            path = os.path.join(td, f"big.{name}.bam")
            got, run = run_main(big, path, name, dict(fields, graphs=graphs),
                                td, devices=devices)
            check_launches(name, got, wanted)
            counts.add(tuple(got[k] for k in wanted))
            if record_bytes(path) != want:
                raise AssertionError(f"{name}: records not byte-equal to "
                                     f"phase {phase}'s {ref} run")
            print_graph_turn(name, run, f"{len(want)} records byte-equal to "
                             f"phase {phase}'s {ref} run")
            os.remove(path)
        if len(counts) != 1:
            raise AssertionError(f"{label}: launch counts {sorted(counts)} "
                                 f"differ between graph and eager runs")
    for impl, profiled in PROFILED.items():
        out = os.path.join(td, f"big.{impl}-profiled.bam")
        reset_launches()
        prof = device_profile(lambda: run_call(
            big, out, CallConfig(device="cuda", gather_impl=impl)))
        got = read_launches()
        check_launches(f"{impl}-profiled", got, [k for k, _, _ in profiled])
        same_records(out, os.path.join(td, f"big.{impl}.bam"),
                     f"{impl}-profiled-vs-{impl}")
        print(f"[graphs {impl}-profiled] default async run with graphs "
              f"under torch.profiler: wall {prof['wall_s']:.3f} s, device "
              f"busy {prof['busy_s']:.3f} s, idle share "
              f"{prof['idle_share']:.4f}; device ms by class " + ", ".join(
                  f"{c} {ms:.1f}" for c, ms in sorted(
                      prof["ms_by_class"].items(), key=lambda kv: -kv[1])))
        for kernel, cls, names in profiled:
            check_profiled(impl, prof, got, kernel, cls, names)
    print(f"[phase 8] graphs against eager in "
          f"{time.perf_counter() - t_phase:.3f} s wall")


def check_profiled(impl, prof, got, kernel, cls, names):
    """Phase 8: the profiled run's device time holds the wrapper's class,
    and its device kernels of each name number the wrapper's launches
    plus the programs' warm-ups."""
    from hifimeth_tpu_torch.engine import programs
    warm = programs.warmup_launches.get(kernel_wrappers()[kernel], 0)
    if prof["ms_by_class"].get(cls, 0.0) <= 0:
        raise AssertionError(f"the profiler saw no {cls} in the {impl} "
                             f"run's graphs")
    # the launch count is a measurement: the profiler's kernels of each
    # name are the replays' launches plus the warm-ups'
    for part in names:
        seen = sum(n for k, n in prof["n_by_kernel"].items() if part in k)
        print(f"[graphs {impl}-profiled] {part}: {seen} device kernels = "
              f"{got[kernel]} launches + {warm} warm-ups")
        if seen != got[kernel] + warm:
            raise AssertionError(
                f"{impl}-profiled: the profiler saw {seen} {part} kernels, "
                f"the counts say {got[kernel]} launches + {warm} warm-ups: "
                + str({k: n for k, n in prof["n_by_kernel"].items()
                       if "kernel" in k}))


def phase_surface(big, td, runs):
    """Phase 7 (see the module notes)."""
    t_phase = time.perf_counter()
    phase_trace(big, td, runs)
    phase_cache(td)
    phase_reference_call()
    print(f"[phase 7] trace, cache and reference call in "
          f"{time.perf_counter() - t_phase:.3f} s wall")


def phase_cards(big, td, runs):
    """Phase 9 (see the module notes); `runs` holds phase 3's stats."""
    import torch
    n_cards = torch.cuda.device_count()
    if n_cards < len(CARDS):
        print(f"[phase 9] {n_cards} card(s): the split over four distinct "
              f"cards needs {len(CARDS)}, skipped")
        return
    t_phase = time.perf_counter()

    def out(name):
        return os.path.join(td, f"big.{name}.bam")

    for label, impl, kernels, devices in (
            ("pallas-4cards", "pallas", PALLAS, CARDS),
            ("pallas-4x-cuda0", "pallas", PALLAS, ["cuda:0"] * 4),
            ("slice-4cards", "slice", CNN, CARDS)):
        got, run = run_main(big, out(label), label, dict(
            gather_impl=impl, data_parallel=True), td, devices=devices)
        check_launches(label, got, kernels)
        if run["config"]["devices"] != devices:
            raise AssertionError(f"{label} ran over "
                                 f"{run['config']['devices']}")
        t = run["timers"]
        peer, ship = t.get("peer_bytes"), t.get("ship_bytes")
        print(f"[cards {label}] sites/s {run['sites_per_s']:.1f} (one card "
              f"{runs[impl]['sites_per_s']:.1f}); to_primary "
              f"{t.get('to_primary')} s, peer_bytes {peer}, ship_bytes "
              f"{ship}, slots {t['slots']}")
        if "to_primary" not in t or not ship:
            raise AssertionError(f"{label}: no exchange span or no plane "
                                 f"bytes shipped: {t}")
        want = 3 * t["slots"] // 4 if devices == CARDS else 0
        if peer != want:
            raise AssertionError(f"{label}: peer_bytes {peer}, expected "
                                 f"{want} (the cross-card branch of "
                                 f"_to_primary)")
        if impl == "pallas":
            same_records(out(label), out("pallas"), f"{label}-vs-pallas")
        else:
            compare(out(label), out("slice"), f"{label}-vs-slice")
    print(f"[phase 9] four cards in {time.perf_counter() - t_phase:.3f} s "
          f"wall")


def main() -> int:
    t_smoke = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: torch.cuda.is_available() is False")
    if not os.path.isdir(os.path.join(ROOT, "hifimeth_tpu_torch")):
        return fail("hifimeth_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import probe_window_rows
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call
    from hifimeth_tpu_torch.ops import build

    # -- phase 1: card, versions, builds ---------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        return fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(card, flush=True)
    print(f"[versions] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels = build.KERNELS
    with ThreadPoolExecutor(len(kernels) + 3) as pool:
        k_futs = {k: pool.submit(build.kernel_library, k) for k in kernels}
        b_fut = pool.submit(build.bamcore_library)
        m_fut = pool.submit(build.mmbuild_library)
        p_fut = pool.submit(probe_window_rows.build)
        libs = {k: f.result() for k, f in k_futs.items()}
        bamcore_lib = b_fut.result()
        mmbuild_lib = m_fut.result()
        p_fut.result()
    if bamcore_lib is None:
        return fail("libbamcore did not build")
    if mmbuild_lib is None:
        return fail("libmmbuild did not build")
    print(f"[build] {len(kernels)} kernel libraries + libbamcore + "
          f"libmmbuild + the DRAM probe in "
          f"{time.perf_counter() - t0:.2f} s")
    for k, lib in libs.items():
        print(f"[build {k}] " + f"\n[build {k}] ".join(
            l.strip() for l in build.build_log(lib).splitlines()
            if "ptxas" in l or "spill" in l))

    # -- phase 2: kernels against their plain versions -------------------
    rows = [phase_gather(), phase_fused(), phase_conv(),
            *phase_row_windows()]

    with tempfile.TemporaryDirectory() as td:
        small, big = os.path.join(td, "small.bam"), os.path.join(td, "big.bam")
        make_bam(small, 4, 4000, seed=1)
        make_bam(big, 200, 15000, seed=0)
        # warm-up + the card side of phase 4 (cuDNN picks its algorithms)
        small_runs = {impl: dict(gather_impl=impl) for impl in GATHER_IMPLS}
        small_runs["pallas-bf16"] = dict(gather_impl="pallas",
                                         compute_dtype="bfloat16")
        for label, fields in small_runs.items():
            run_call(small, os.path.join(td, f"small.{label}.cuda.bam"),
                     CallConfig(device="cuda", **fields))

        # -- phase 3: the main paths -------------------------------------
        launches = {}
        runs = {}
        for label, (fields, want) in MAIN_RUNS.items():
            got, runs[label] = run_main(
                big, os.path.join(td, f"big.{label}.bam"), label, fields, td)
            for kernel in want:
                if got[kernel] <= 0:
                    return fail(f"the {label} run launched {kernel} no time")
                if label in GATHER_IMPLS:
                    launches.setdefault(kernel, (
                        got[kernel], f"call --gather-impl {label}"))
            other = {k: v for k, v in got.items() if k not in want and v}
            if other:
                return fail(f"the {label} run launched another kernel "
                            f"({other})")
        sched = runs["pallas-forced"]["schedule"]
        if not (sched["buffers"] > 1 and sched["carried_reads"] > 0
                and sched["flushes"] > sched["buffers"]):
            return fail(f"the forced schedule did not roll buffers over, "
                        f"cut flushes and carry reads: {sched}")
        made = runs["pallas-forced"]["timers"]["pinned_new"]
        if made >= sched["flushes"]:
            return fail(f"the forced schedule made {made} page-locked buffers "
                        f"over {sched['flushes']} flushes: the pool does not "
                        f"reuse them")
        if runs["pallas-bf16"]["config"]["compute_dtype"] != "bfloat16":
            return fail("the bf16 run did not compute in bf16")
        print("[main summary] sites/s: " + ", ".join(
            f"{label} {run['sites_per_s']:.1f}" for label, run in runs.items()))
        got = run_microbench()
        for kernel in ("group_windows", "window_slices", "group_windows_t"):
            if got[kernel] <= 0:
                return fail(f"the microbenchmark launched {kernel} no time")
        for kernel in ("group_windows", "window_slices"):
            launches[kernel] = (got[kernel], "scripts/microbench_torch_gather.py"
                                " (every variant, --nb 2)")

        # -- phase 4: parity ---------------------------------------------
        for a, b, mode in (("fused", "pallas", "contract"),
                           ("slice", "pallas", "contract"),
                           ("folded", "slice", "contract"),
                           ("pallas", "pallas-sync", "equal"),
                           ("fused", "fused-sync", "equal"),
                           ("pallas-forced", "pallas", "equal"),
                           ("pallas-im2col", "pallas", "contract"),
                           ("slice-auto", "slice", "contract"),
                           ("pallas-bf16", "pallas", "bf16-gate")):
            compare(os.path.join(td, f"big.{a}.bam"),
                    os.path.join(td, f"big.{b}.bam"), f"{a}-vs-{b}", mode)
        check_conv_impl(runs)
        # bf16 against f32 on the input of the JAX package's band
        check = os.path.join(td, "selfcheck.bam")
        make_bam(check, 20, 5000, seed=7, composition=UNIFORM)
        for dt in ("float32", "bfloat16"):
            run_call(check, os.path.join(td, f"selfcheck.{dt}.bam"),
                     CallConfig(device="cuda", site_batch=16384,
                                gather_impl="pallas", compute_dtype=dt))
        compare(os.path.join(td, "selfcheck.bfloat16.bam"),
                os.path.join(td, "selfcheck.float32.bam"),
                "pallas-bf16-vs-pallas on the self-check input", "bf16")
        for label, fields in small_runs.items():
            run_call(small, os.path.join(td, f"small.{label}.cpu.bam"),
                     CallConfig(device="cpu", site_batch=512, **fields))
            compare(os.path.join(td, f"small.{label}.cuda.bam"),
                    os.path.join(td, f"small.{label}.cpu.bam"),
                    f"cuda-vs-cpu {label}",
                    "bf16-device" if "bf16" in label else "contract")

        # -- phase 5: scale-out and quantification -----------------------
        phase_scale_out(big, td, runs)

        # -- phase 6: the model lifecycle ------------------------------------
        phase_lifecycle(td, card)

        # -- phase 7: trace, cache, reference per-site call ----------------
        phase_surface(big, td, runs)

        # -- phase 8: graphs against eager ---------------------------------
        phase_graphs(big, td, runs)

        # -- phase 9: four cards -------------------------------------------
        phase_cards(big, td, runs)

    for row in rows:
        if row["name"] in launches:
            row["launches"], row["path"] = launches[row["name"]]
    if any(row["launches"] <= 0 for row in rows):
        return fail(f"a kernel was launched no time: {rows}")
    print(f"[smoke] phases 1-9 in {time.perf_counter() - t_smoke:.3f} s "
          f"wall")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:          # any phase's failure: no result line
        import traceback
        traceback.print_exc()
        sys.exit(fail(f"{type(e).__name__}: {e}"))
