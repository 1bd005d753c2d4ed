"""Command-line interface of the PyTorch/CUDA port.

`call` is ported; it keeps the reference's short flags (mod_options.cpp),
the JAX package's `--dtype`, `--sync-emit` and `--decode-workers`, and adds
`--device {cuda,cpu}`.  The JAX package's other subcommands are
listed and answer that they are not ported yet.
"""
from __future__ import annotations

import sys

from . import __version__
from .utils.logging import program_banner, program_info

PROG = "hifimeth-tpu-torch"

GATHER_IMPLS = ("auto", "slice", "folded", "pallas", "fused")
#: --dtype spellings (the JAX CLI's) -> CallConfig.compute_dtype
DTYPES = {"f32": "float32", "float32": "float32", "bf16": "bfloat16",
          "bfloat16": "bfloat16"}
NOT_YET_PORTED = ("pileup", "corr", "cov2bed", "sample", "eval",
                  "read-level-eval", "merge-shards", "merge-pileup-shards",
                  "import-model", "export-model", "extract-features", "train")


def _usage() -> int:
    print(f"""USAGE:
  {PROG} <command> [OPTIONS]

COMMANDS:
  call             Detect single-molecule 5mC (CpG/CHG/CHH) in BAM reads
  version          Print version

NOT YET PORTED (use hifimeth-tpu):
  {' '.join(NOT_YET_PORTED)}

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
                       (folded) + CNN (default auto)"""


def _parse_call(argv):
    from .engine.call import CallConfig
    kw = {}
    pos = []
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
    return CallConfig(**kw), pos


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        return _usage()
    cmd, rest = argv[0], argv[1:]
    if cmd in ("-v", "--version", "version"):
        print(__version__)
        return 0
    if cmd in NOT_YET_PORTED:
        print(f"{PROG}: '{cmd}' is not yet ported to the PyTorch package; "
              f"use hifimeth-tpu {cmd}", file=sys.stderr)
        return 2
    if cmd != "call":
        return _usage()

    from .device import resolve_device
    from .engine.call import run_call
    from .utils.system import dump_parameters
    cfg, pos = _parse_call(rest)
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
        "input": pos[0],
        "output": pos[1],
    })
    with program_info(PROG):
        run_call(pos[0], pos[1], cfg, cmdline=" ".join([PROG] + argv))
    return 0
