"""Command-line interface of the PyTorch/CUDA port.

The reference's subcommands (main.cpp:35-46) and the JAX package's shard
merges, with the reference's short flags (mod_options.cpp, pileup.cpp).
`call` and `train` keep the JAX package's options and add `--device
{cuda,cpu}`; `pileup` takes `--device` for its collectives when it runs as
several processes.
"""
from __future__ import annotations

import os
import sys

from . import __version__
from .utils.logging import log, program_banner, program_info

PROG = "hifimeth-tpu-torch"

GATHER_IMPLS = ("auto", "slice", "folded", "pallas", "fused")
#: --dtype spellings (the JAX CLI's) -> CallConfig.compute_dtype
DTYPES = {"f32": "float32", "float32": "float32", "bf16": "bfloat16",
          "bfloat16": "bfloat16"}
FEAT_CHANNELS = (8, 32, 128)


def _usage() -> int:
    print(f"""USAGE:
  {PROG} <command> [OPTIONS]

COMMANDS:
  call             Detect single-molecule 5mC (CpG/CHG/CHH) in BAM reads
  pileup           Genome-wide methylation frequency from an aligned mod-BAM
  corr             Pearson correlation between two methylation BED files
  cov2bed          Convert 1-based Bismark .cov to 0-based BED
  sample           Randomly subsample an unmapped kinetics BAM to a coverage
  eval             Extract read-level evaluation samples vs BS-seq labels
  read-level-eval  Score eval output files (accuracy/precision/.../AUC/AP)
  import-model     Convert reference ONNX models to native .npz
  export-model     Convert a native .npz model back to ONNX
  extract-features Build training feature blobs from BAM + BS-seq labels
  train            Train a per-context model on extracted features
  merge-shards     Interleave per-process shard BAMs into global read order
  merge-pileup-shards  Interleave per-process pileup BED shards
  version          Print version

VERSION:
  {__version__}""", file=sys.stderr)
    return 1


_CALL_USAGE = f"""USAGE:
  {PROG} call [OPTIONS] BAM MOD-BAM

OPTIONS:
  -m DIR   model directory (default: <repo>/models)
  -l INT   minimum read length (default 1000)
  -s INT   sites per CNN batch, a multiple of 32 (default 8192)
  -b INT   reads per progress batch (default 10000)
  -k       keep kinetics tags in output
  -c STR   contexts, comma separated (default cpg,chg,chh)
  -t INT   IO threads (default 8)
  --buffer-bases INT   packed plane-buffer capacity (default 2097152)
  --flush-bases INT    dispatch granularity in bases (0 = capacity)
  --stats-json PATH    write run stats as JSON
  --dtype {{f32,bf16}}   compute dtype of the CNN's convs and FCs (default
                       f32; fused ignores bf16)
  --sync-emit          dispatch, resolve and write on the main thread, one
                       flush in flight (default: worker threads)
  --decode-workers INT decode/site-scan prefetch threads
                       (-1 auto = cores-1 capped at 4, default; 0 = inline)
  --device {{cuda,cpu}}  where the model runs (default cuda)
  --gather-impl {{auto,slice,folded,pallas,fused}}  per-site device path:
                       the window gather kernel + CNN (auto = pallas), one
                       fused kernel for both, or the indexing gathers over
                       an (N, 8) table (slice) or its 16-position fold
                       (folded) + CNN (default auto)
  --data-parallel      split each batch over every local card (pallas,
                       slice, folded; one card runs the single-device path)
  --feat-channels {{8,32,128}}  taken for the JAX CLI's command lines
                       (CallConfig.feat_channels); the engine warns when it
                       is not 8 and keeps the 8-channel table on every path
  --shard I/N          call only the blocks of 10,000 reads I, I+N, ... and
                       write MOD-BAM.shardIIII (merge with merge-shards);
                       under torchrun (WORLD_SIZE set) the rank and world
                       size give it

HIFIMETH_TRACE=1 prints one line per flush of the asynchronous pipeline,
  [trace flush N] flush@t dispatch0@t dispatch1@t resolve0@t resolve1@t
  emit0@t emit1@t (seconds from the first event), as the JAX package does;
  the --stats-json timers then also hold each stage's thread CPU seconds
  (<stage>_cpu) and the file a list `spans`: the flush-level spans and
  waits (name, flush, thread, start, end, cpu, parent, wait), start and
  end on Python's perf_counter clock"""


def _parse_call(argv):
    from .engine.call import CallConfig
    kw = {}
    pos = []
    shard = None
    ints = {"-l": "min_read_size", "--min-read-size": "min_read_size",
            "-s": "site_batch", "--site-batch": "site_batch",
            "-b": "read_batch_size", "--read-batch-size": "read_batch_size",
            "-t": "io_threads", "--threads": "io_threads",
            "--buffer-bases": "buffer_bases", "--flush-bases": "flush_bases",
            "--decode-workers": "decode_workers"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            pos = []
            break
        if a in ("-v", "--version"):
            print(__version__)
            raise SystemExit(0)
        if a in ("-k", "--keep-kinetics"):
            kw["keep_kinetics"] = True
            i += 1
            continue
        if a == "--sync-emit":
            kw["async_emit"] = False
            i += 1
            continue
        if a == "--data-parallel":
            kw["data_parallel"] = True
            i += 1
            continue
        if a.startswith("-") and len(a) > 1 and i + 1 >= len(argv):
            raise SystemExit(f"ERROR: option {a} needs a value")
        if a in ints:
            try:
                kw[ints[a]] = int(argv[i + 1])
            except ValueError:
                raise SystemExit(f"Illegal argument to option '{a}': {argv[i + 1]}")
        elif a in ("-m", "--model-dir"):
            kw["model_dir"] = argv[i + 1]
        elif a in ("-c", "--contexts"):
            sel = [c.strip().upper() for c in argv[i + 1].split(",") if c.strip()]
            name_map = {"CPG": "CpG", "CHG": "CHG", "CHH": "CHH"}
            if not sel or any(c not in name_map for c in sel):
                raise SystemExit(f"Illegal argument to option '-c': {argv[i + 1]}")
            kw["contexts"] = tuple(name_map[c] for c in sel)
        elif a == "--dtype":
            if argv[i + 1] not in DTYPES:
                raise SystemExit(f"Illegal argument to option '--dtype': "
                                 f"{argv[i + 1]} (expected f32|bf16)")
            kw["compute_dtype"] = DTYPES[argv[i + 1]]
        elif a == "--stats-json":
            kw["stats_json"] = argv[i + 1]
        elif a == "--device":
            if argv[i + 1] not in ("cuda", "cpu"):
                raise SystemExit(f"Illegal argument to option '--device': "
                                 f"{argv[i + 1]} (expected cuda|cpu)")
            kw["device"] = argv[i + 1]
        elif a == "--feat-channels":
            if argv[i + 1] not in tuple(map(str, FEAT_CHANNELS)):
                raise SystemExit(f"Illegal argument to option "
                                 f"'--feat-channels': {argv[i + 1]} "
                                 f"(expected 8|32|128)")
            # CallConfig.feat_channels: the engine warns when it is not 8
            # and runs the 8-channel table
            kw["feat_channels"] = int(argv[i + 1])
        elif a == "--shard":
            shard = _parse_shard(argv[i + 1])
        elif a == "--gather-impl":
            if argv[i + 1] not in GATHER_IMPLS:
                raise SystemExit(f"Illegal argument to option '--gather-impl'"
                                 f": {argv[i + 1]} (expected "
                                 f"{'|'.join(GATHER_IMPLS)})")
            kw["gather_impl"] = argv[i + 1]
        elif a.startswith("-") and len(a) > 1:
            raise SystemExit(f"ERROR: unrecognised option {a}")
        else:
            pos.append(a)
            i += 1
            continue
        i += 2
    if len(pos) != 2:
        print(_CALL_USAGE, file=sys.stderr)
        raise SystemExit(1)
    # the JAX engine's switch, so one command line traces both packages
    kw["trace"] = bool(os.environ.get("HIFIMETH_TRACE"))
    return CallConfig(**kw), pos, shard


def _parse_shard(text: str):
    """`I/N` -> ShardSpec(I, N)."""
    from .parallel.dist import ShardSpec
    try:
        pid, nproc = (int(x) for x in text.split("/"))
    except ValueError:
        raise SystemExit(f"Illegal argument to option '--shard': {text} "
                         f"(expected I/N)") from None
    if not 0 <= pid < nproc:
        raise SystemExit(f"Illegal argument to option '--shard': {text} "
                         f"(expected 0 <= I < N)")
    return ShardSpec(process_id=pid, num_processes=nproc)


def _split_opts(argv, flags: dict, usage: str):
    """Generic option parser: `flags` maps an option to (key, type); returns
    ({key: value}, positionals).  -h/--help prints `usage` and exits 1."""
    opts, pos = {}, []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(usage, file=sys.stderr)
            raise SystemExit(1)
        if a in flags:
            key, typ = flags[a]
            if i + 1 >= len(argv):
                raise SystemExit(f"ERROR: option {a} needs a value")
            try:
                opts[key] = typ(argv[i + 1])
            except ValueError:
                raise SystemExit(f"Illegal argument to option '{a}': "
                                 f"{argv[i + 1]}") from None
            i += 2
        elif a.startswith("-") and len(a) > 1:
            raise SystemExit(f"ERROR: unrecognised option {a}")
        else:
            pos.append(a)
            i += 1
    return opts, pos


def _device_arg(text: str) -> str:
    if text not in ("cuda", "cpu"):
        raise ValueError(text)
    return text


def _call(argv, rest) -> int:
    from .device import resolve_device
    from .engine.call import run_call
    from .parallel.dist import init_distributed, shutdown_distributed
    from .utils.system import dump_parameters
    cfg, pos, shard = _parse_call(rest)
    # torchrun's rank and world size shard the reads, --shard overrides them
    dist_shard = init_distributed(cfg.device)
    try:
        shard = shard or dist_shard
        program_banner(PROG, __version__, resolve_device(cfg.device))
        dump_parameters("call", {
            "model_dir": cfg.resolve_model_dir(),
            "min_read_size": cfg.min_read_size,
            "site_batch": cfg.site_batch,
            "read_batch_size": cfg.read_batch_size,
            "keep_kinetics": int(cfg.keep_kinetics),
            "contexts": ",".join(cfg.contexts),
            "io_threads": cfg.io_threads,
            "device": cfg.device,
            "gather_impl": cfg.gather_impl,
            "compute_dtype": cfg.compute_dtype,
            "async_emit": int(cfg.async_emit),
            "decode_workers": cfg.decode_workers,
            "data_parallel": int(cfg.data_parallel),
            "shard": f"{shard.process_id}/{shard.num_processes}",
            "input": pos[0],
            "output": pos[1],
        })
        with program_info(PROG):
            run_call(pos[0], pos[1], cfg, cmdline=" ".join([PROG] + argv),
                     shard=shard)
    finally:
        shutdown_distributed()
    return 0


def _pileup(rest) -> int:
    from .parallel.dist import init_distributed, shutdown_distributed
    from .quant.pileup import (PileupConfig, run_pileup_multihost,
                               run_pileup_parallel)
    from .utils.system import dump_parameters
    usage = (f"USAGE:\n  {PROG} pileup [-q mapQ] [-f identity] [-t threads] "
             "[--device cuda|cpu] reference mod-bam output-prefix\n\n"
             "Under torchrun (WORLD_SIZE > 1) every process quantifies its "
             "read blocks and\nwrites output-prefix.<ctx>.cov.bed.shardIIII; "
             "join them with merge-pileup-shards.\n--device picks the "
             "collectives' backend: nccl on cuda (default), gloo on cpu.")
    opts, pos = _split_opts(rest, {
        "-q": ("min_mapq", int), "--min-mapq": ("min_mapq", int),
        "-f": ("min_identity", float), "--min-identity": ("min_identity", float),
        "-t": ("io_threads", int), "--threads": ("io_threads", int),
        "--device": ("device", _device_arg)}, usage)
    if len(pos) != 3:
        print(usage, file=sys.stderr)
        return 1
    device = opts.pop("device", "cuda")
    cfg = PileupConfig(**opts)
    dump_parameters("pileup", {
        "min_mapq": cfg.min_mapq,
        "min_identity": cfg.min_identity,
        "threads": cfg.io_threads,
        "reference": pos[0],
        "input": pos[1],
        "output_prefix": pos[2],
    })
    shard = init_distributed(device)
    try:
        with program_info(PROG):
            if shard.num_processes > 1:
                run_pileup_multihost(pos[0], pos[1], pos[2], shard, cfg)
            else:
                run_pileup_parallel(pos[0], pos[1], pos[2], cfg,
                                    workers=cfg.io_threads)
    finally:
        shutdown_distributed()
    return 0


def _host_command(cmd: str, rest) -> int:
    """The host-only subcommands (no device)."""
    if cmd == "merge-shards":
        from .parallel.dist import merge_shard_bams
        usage = (f"USAGE:\n  {PROG} merge-shards [-b batch] out.bam "
                 "shard0.bam shard1.bam ...")
        opts, pos = _split_opts(rest, {"-b": ("batch", int),
                                       "--batch-size": ("batch", int)}, usage)
        if len(pos) < 2:
            print(usage, file=sys.stderr)
            return 1
        n = merge_shard_bams(pos[0], pos[1:],
                             batch_size=opts.get("batch", 10000))
        log("merged %d records into %s", n, pos[0])
        return 0
    if cmd == "merge-pileup-shards":
        from .quant.pileup import merge_pileup_shards
        if len(rest) != 2:
            print(f"USAGE:\n  {PROG} merge-pileup-shards output-prefix "
                  "n-shards", file=sys.stderr)
            return 1
        merge_pileup_shards(rest[0], int(rest[1]))
        return 0
    if cmd == "corr":
        from .tools.corr import run_corr
        usage = f"USAGE:\n  {PROG} corr [-c min-cov] bed1 bed2"
        opts, pos = _split_opts(rest, {"-c": ("min_cov", int),
                                       "--min-cov": ("min_cov", int)}, usage)
        if len(pos) != 2:
            print(usage, file=sys.stderr)
            return 1
        run_corr(pos[0], pos[1], opts.get("min_cov", 5))
        return 0
    if cmd == "cov2bed":
        from .tools.cov2bed import run_cov2bed
        if len(rest) != 4:
            print(f"USAGE:\n  {PROG} cov2bed reference context bismark-cov "
                  "bed", file=sys.stderr)
            return 1
        run_cov2bed(*rest)
        return 0
    if cmd == "sample":
        from .tools.sample import run_sample
        if len(rest) != 4:
            print(f"USAGE:\n  {PROG} sample reference input-bam coverage "
                  "output-bam", file=sys.stderr)
            return 1
        with program_info(PROG):
            run_sample(rest[0], rest[1], int(rest[2]), rest[3])
        return 0
    if cmd == "eval":
        from .tools.evaltool import run_eval
        usage = (f"USAGE:\n  {PROG} eval [-t workers] reference "
                 "bismark-bed mod-bam output-prefix")
        opts, pos = _split_opts(rest, {"-t": ("workers", int),
                                       "--workers": ("workers", int)}, usage)
        if len(pos) != 4:
            print(usage, file=sys.stderr)
            return 1
        with program_info(PROG):
            run_eval(*pos, workers=opts.get("workers", 1))
        return 0
    if cmd == "read-level-eval":
        from .tools.read_level_metrics import run_read_level_eval
        if len(rest) != 2:
            print(f"USAGE:\n  {PROG} read-level-eval input-prefix "
                  "num-evals", file=sys.stderr)
            return 1
        run_read_level_eval(rest[0], int(rest[1]))
        return 0
    return _model_command(cmd, rest)


def _model_command(cmd: str, rest) -> int:
    """The model lifecycle: import-model, export-model, extract-features,
    train."""
    if cmd == "import-model":
        from .tools.import_model import import_models
        if len(rest) != 2:
            print(f"USAGE:\n  {PROG} import-model <reference-model-dir> "
                  "<output-dir>", file=sys.stderr)
            return 1
        import_models(rest[0], rest[1])
        return 0
    if cmd == "export-model":
        from .model.cnn import load_params_npz
        from .model.onnx_export import export_onnx
        if len(rest) != 2:
            print(f"USAGE:\n  {PROG} export-model model.npz model.onnx",
                  file=sys.stderr)
            return 1
        export_onnx(load_params_npz(rest[0]), rest[1])
        log("exported %s -> %s", rest[0], rest[1])
        return 0
    if cmd == "extract-features":
        from .tools.extract_features import run_extract_features
        if len(rest) != 5:
            print(f"USAGE:\n  {PROG} extract-features reference context "
                  "labels-bed kinetics-bam output-prefix", file=sys.stderr)
            return 1
        with program_info(PROG):
            run_extract_features(*rest)
        return 0
    if cmd == "train":
        from .train.train import main as train_main
        return train_main(rest, f"{PROG} train")
    return _usage()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        return _usage()
    cmd, rest = argv[0], argv[1:]
    if cmd in ("-v", "--version", "version"):
        print(__version__)
        return 0
    if cmd == "call":
        return _call(argv, rest)
    if cmd == "pileup":
        return _pileup(rest)
    return _host_command(cmd, rest)
