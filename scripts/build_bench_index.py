#!/usr/bin/env python
"""Build the genome-scale bench index end-to-end (host-only, no jax).

Generates a deterministic synthetic genome FASTA, builds the full artifact
set (.mta/.cat/.sa5/.mfi/.lch) plus the device-layout cache
(<ref>.cat.devidx/), and logs phase timings.  This is the fixture builder
for the genome-scale bench (the closest single-device approximation
of the reference's hg19 runs, /root/reference/scripts/gen-sbatch-scripts.py:74-111):
at ~11.5 B/position with an hlen=14 seed table, a 500 Mb genome takes
~12 GB of device memory.

hlen default 14 (not the reference's 12): expand-and-verify's gather cost
is linear in the hlen-mer occupancy n/4^hlen, so genome-scale indexes want
a deeper table (4^14 rows = 2.1 GB HBM) to keep per-seed expansion small.
The pipeline semantics are hlen-independent (verified vs the oracle).

Usage: build_bench_index.py --dir /tmp/lrm_big500 --genome-mb 500
                            [--hlen 14] [--seed 2026] [--contigs 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

# host-only build: the lchash table comes from the suffix array
# (lc_build_from_sa), so no device is touched; run with
# JAX_PLATFORMS=cpu to keep the process off the GPU entirely.


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--genome-mb", type=int, default=500)
    ap.add_argument("--hlen", type=int, default=14)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--contigs", type=int, default=8)
    args = ap.parse_args(argv)

    from longreadmapper_tpu.formats.catmeta import (create_meta, load_cat,
                                                    load_mta)
    from longreadmapper_tpu.formats.lch import write_lch
    from longreadmapper_tpu.index.device import (_assemble_host_arrays,
                                                 save_device_cache)
    from longreadmapper_tpu.index.fmi import FMIndex, encode_bytes
    from longreadmapper_tpu.index.lchash import lc_build_from_sa
    from longreadmapper_tpu.index.sa import sa_build
    from gen_big_genome import write_contig

    os.makedirs(args.dir, exist_ok=True)
    fa = os.path.join(args.dir, "ref.fa")
    size = args.genome_mb * 1_000_000
    if not (os.path.exists(fa) and os.path.getsize(fa) > size):
        t0 = time.time()
        rng = np.random.default_rng(args.seed)
        per = size // args.contigs
        with open(fa, "wb") as fp:
            for i in range(args.contigs):
                m = per if i < args.contigs - 1 else size - per * (args.contigs - 1)
                write_contig(fp, f"chr{i + 1}", m, rng, 80)
        log(f"genome: {size} bases, {args.contigs} contigs "
            f"in {time.time() - t0:.0f}s")

    t0 = time.time()
    mta = create_meta(fa, n_seed=0)
    prefix = fa + ".cat"
    log(f"create_meta: {time.time() - t0:.0f}s "
        f"(.cat = {os.path.getsize(prefix)} bytes)")

    # Each stage below resumes from a completed on-disk artifact: a
    # ~500 Mb build takes several 1-core hours end-to-end and sessions
    # have wall clocks — an interrupted build must not redo the SA.
    n_cat = os.path.getsize(prefix)
    t0 = time.time()
    if os.path.exists(prefix + ".sa5") and \
            os.path.getsize(prefix + ".sa5") == 5 * n_cat:
        from longreadmapper_tpu.index.sa import sa_load
        sa = sa_load(prefix)
        log(f"sa_load (resume): {time.time() - t0:.0f}s (n = {sa.shape[0]})")
    else:
        sa = sa_build(prefix)
        log(f"sa_build: {time.time() - t0:.0f}s (n = {sa.shape[0]})")

    t0 = time.time()
    if os.path.exists(prefix + ".mfi"):
        fmi = FMIndex.read(prefix, with_sa=False)
        fmi.sa = sa
        log(f"fmi_read (resume): {time.time() - t0:.0f}s")
    else:
        fmi = FMIndex.build(prefix, sa=sa)
        fmi.write(prefix)
        log(f"fmi_build+write: {time.time() - t0:.0f}s")

    t0 = time.time()
    cat = load_cat(prefix)
    if os.path.exists(prefix + ".lch"):
        from longreadmapper_tpu.formats.lch import read_lch
        got_hlen, kl = read_lch(prefix + ".lch")
        assert got_hlen == args.hlen, (got_hlen, args.hlen)
        log(f"lch read (resume): {time.time() - t0:.0f}s")
    else:
        kl = lc_build_from_sa(sa, encode_bytes(cat), args.hlen)
        write_lch(prefix + ".lch", args.hlen, kl)
        log(f"lc_build_from_sa(hlen={args.hlen}): {time.time() - t0:.0f}s")

    t0 = time.time()
    arrays, meta = _assemble_host_arrays(fmi, kl, args.hlen, cat, mta)
    save_device_cache(fa, arrays, meta)
    log(f"device-layout cache: {time.time() - t0:.0f}s -> {fa}.cat.devidx/")
    hbm = sum(0 if a is None else np.asarray(a).nbytes
              for a in arrays.values())
    log(f"device index HBM footprint: {hbm / 1e9:.2f} GB "
        f"(pos_dtype={meta.pos_dtype})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
