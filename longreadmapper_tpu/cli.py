"""Command-line entry points.

Two subcommands mirroring the reference binaries (SURVEY.md §1 L5/L6):

  index  — accidx equivalent: `... index ref.fa [--hlen N] [--o-ratio N]
           [--n-seed N] [--host-only]` (reference argv: asindex.c:129)
  map    — accaln equivalent: `... map ref.fa reads.fq [batch seed thres]`
           with the same positional-parameter contract and `params`-file
           fallback as the reference (alnmain.c:560-588)

Usage: python -m longreadmapper_tpu.cli <index|map> ...
"""

from __future__ import annotations

import argparse
import sys
import time

from .utils.config import Params, read_params


def main(argv=None) -> int:
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="longreadmapper_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ia = sub.add_parser("index", help="build the reference index (accidx)")
    ia.add_argument("fasta")
    ia.add_argument("--hlen", type=int, default=0,
                    help="lchash k-mer length; 0 = auto (14 for any "
                         "genome >= 1 Mb, 12 for toy fixtures — "
                         "utils/config.auto_hlen, docs/TUNING.md). The "
                         "reference hard-codes 12 (asindex.c:142)")
    ia.add_argument("--o-ratio", type=int, default=32)
    ia.add_argument("--n-seed", type=int, default=0)
    ia.add_argument("--host-only", action="store_true",
                    help="build lchash on host instead of the accelerator")
    ia.add_argument("--ram-gb", type=float, default=0,
                    help="bound the SA construction working set (GB): "
                         "texts whose in-RAM SA-IS footprint exceeds it "
                         "build via the blocked external-memory path "
                         "(byte-identical .sa5). 0 = in-RAM (default)")
    ia.add_argument("--no-devidx", action="store_true",
                    help="skip persisting the device-layout cache "
                         "(<ref>.cat.devidx/); the first map will then "
                         "derive and cache it instead")
    ia.add_argument("--quiet", action="store_true")

    ma = sub.add_parser("map", help="map reads, SAM to stdout (accaln)")
    ma.add_argument("fasta")
    ma.add_argument("reads")
    ma.add_argument("pos", nargs="*", type=int,
                    help="optional: batch_size seed_len thres "
                         "(else ./params file, else defaults 1000/20/300)")
    ma.add_argument("--chunk-b", type=int, default=2048,
                    help="reads per device chunk (default 2048; the "
                         "reference's CHUNK_SIZE=500 is a CPU-era default "
                         "— big chunks amortize device-link latency)")
    ma.add_argument("--rg-id", type=int, default=None,
                    help="@RG timestamp id (default: current time, as the "
                         "reference; pass 0 for reproducible output)")
    ma.add_argument("--slim-index", action="store_true",
                    help="reduced-memory index layout (SA-only sa_ctx + "
                         "per-vote text-window recompute) for genomes "
                         "near the device memory ceiling")
    ma.add_argument("--quiet", action="store_true")

    md = sub.add_parser("mapdist",
                        help="mapping over every device of one or more "
                             "hosts (one process per host; SAM stripes to "
                             "--out-prefix.part<k>)")
    md.add_argument("fasta")
    md.add_argument("reads")
    md.add_argument("pos", nargs="*", type=int)
    md.add_argument("--out-prefix", default="out.sam")
    md.add_argument("--chunk-b", type=int, default=0)
    md.add_argument("--rg-id", type=int, default=0)
    md.add_argument("--shard-index", action="store_true",
                    help="row-shard the big index tables over a 'model' "
                         "mesh axis instead of replicating")
    md.add_argument("--slim-index", action="store_true",
                    help="reduced-memory index layout (SA-only sa_ctx + "
                         "text-pair verify windows); composes with "
                         "--shard-index for the biggest sharded genomes")
    md.add_argument("--model-shards", type=int, default=0,
                    help="'model' axis size with --shard-index "
                         "(default: all devices)")
    md.add_argument("--quiet", action="store_true")

    wa = sub.add_parser("warmup",
                        help="precompile map steps for the given read-"
                             "length buckets into the persistent compile "
                             "cache (cold-start mitigation; the cache is "
                             "JAX_COMPILATION_CACHE_DIR, else "
                             "<checkout>/.jax_cache)")
    wa.add_argument("fasta")
    wa.add_argument("--lengths", default="256,1024",
                    help="comma-separated read lengths (default 256,1024)")
    wa.add_argument("--chunk-b", type=int, default=2048)
    wa.add_argument("--slim-index", action="store_true",
                    help="warm the reduced-HBM layout's steps (must match "
                         "the --slim-index you will map with — the slim "
                         "step is a different compiled program)")
    wa.add_argument("--quiet", action="store_true")

    args = ap.parse_args(argv)

    if args.cmd == "index":
        import os

        from .runtime.accidx import build_index
        from .utils.config import auto_hlen
        hlen = args.hlen
        if hlen == 0:
            # the .cat is 2*genome+1; approximate from the FASTA size
            # (headers/newlines inflate it slightly — irrelevant at the
            # 2 Mb rule threshold)
            hlen = auto_hlen(2 * os.path.getsize(args.fasta))
            if not args.quiet:
                print(f"[index] auto hlen = {hlen} (docs/TUNING.md)",
                      file=sys.stderr)
        p = Params(hlen=hlen, o_ratio=args.o_ratio, n_seed=args.n_seed)
        build_index(args.fasta, p, use_device=not args.host_only,
                    verbose=not args.quiet, devidx=not args.no_devidx,
                    ram_use=int(args.ram_gb * (1 << 30)))
        return 0

    if args.cmd == "warmup":
        from .index.device import load_device_index
        from .models.mapper import TPUMapper
        from .utils.log import new_logger
        log = new_logger(verbose=not args.quiet)
        idx, meta, mta = load_device_index(args.fasta,
                                           slim=args.slim_index,
                                           verbose=not args.quiet)
        mapper = TPUMapper(idx, meta, mta, read_params(),
                           chunk_b=args.chunk_b)
        lengths = [int(x) for x in args.lengths.split(",") if x]
        dt = mapper.warmup(lengths)
        log.vlog("warmed %d bucket(s) in %.1fs", len(lengths), dt)
        return 0

    if args.cmd == "map":
        from .runtime.accaln import run_mapping
        if len(args.pos) == 3:
            p = Params(batch_size=args.pos[0], seed_len=args.pos[1],
                       thres=args.pos[2])
        elif len(args.pos) == 0:
            p = read_params("params")
        else:
            ap.error("map takes either 0 or 3 positional parameters "
                     "(batch_size seed_len thres)")
        rg_id = args.rg_id if args.rg_id is not None else int(time.time())
        run_mapping(args.fasta, args.reads, p, sys.stdout, rg_id=rg_id,
                    chunk_b=args.chunk_b, verbose=not args.quiet,
                    slim=args.slim_index)
        return 0

    if args.cmd == "mapdist":
        from .runtime.launch import run_distributed
        if len(args.pos) == 3:
            p = Params(batch_size=args.pos[0], seed_len=args.pos[1],
                       thres=args.pos[2])
        else:
            p = read_params("params")
        run_distributed(args.fasta, args.reads, p,
                        out_prefix=args.out_prefix, rg_id=args.rg_id,
                        chunk_b=args.chunk_b,
                        shard_index_tables=args.shard_index,
                        model_shards=args.model_shards,
                        slim=args.slim_index,
                        verbose=not args.quiet)
        return 0

    return 1


def accidx_main() -> int:
    """Drop-in `accidx ref.fa` entry point (asindex.c:129 argv contract)."""
    return main(["index", *sys.argv[1:]])


def accaln_main() -> int:
    """Drop-in `accaln ref.fa reads.fq [batch seed thres]` entry point
    (alnmain.c:560-571 argv contract, `params` file fallback included)."""
    return main(["map", *sys.argv[1:]])


if __name__ == "__main__":
    sys.exit(main())
