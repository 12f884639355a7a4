#!/usr/bin/env python
"""Genome-scale single-chip mapping bench (VERDICT r2 next #3).

Loads a prebuilt big index (scripts/build_bench_index.py output — the
devidx cache makes this I/O-bound), samples reads from the .cat text
itself, maps them through the full streaming pipeline, and reports
reads/s + sensitivity + device HBM use.  This is the closest single-chip
approximation of the reference's hg19 experiment
(/root/reference/scripts/gen-sbatch-scripts.py:74-111).

Usage: bench_big.py --dir /tmp/lrm_big500 [--n-reads 100000] [--rlen 1000]
                    [--err 0.03] [--chunk-b 2048] [--slim] [--passes 2]
Prints one JSON line on stdout (bench.py convention).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from longreadmapper_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, file=sys.stderr, flush=True)


def sample_reads_from_cat(cat: np.ndarray, mta, n_reads, rlen, err, seed):
    """Reads drawn from forward-strand contig spans of the .cat (which
    holds fwd + revcomp per contig), with substitution errors."""
    rng = np.random.default_rng(seed)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    reads = []
    spans = [(m.offset, m.seq_len) for m in mta]
    for i in range(n_reads):
        off, slen = spans[int(rng.integers(0, len(spans)))]
        p = int(rng.integers(0, slen - rlen))
        chars = np.asarray(cat[off + p:off + p + rlen]).copy()
        if rng.random() < 0.5:
            chars = comp[chars[::-1]]
        mask = rng.random(rlen) < err
        chars[mask] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(mask.sum()))]
        reads.append((f"r{i}", chars.tobytes().decode(), None))
    return reads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--n-reads", type=int, default=100_000)
    ap.add_argument("--rlen", type=int, default=1000)
    ap.add_argument("--err", type=float, default=0.03)
    ap.add_argument("--chunk-b", type=int, default=2048)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--slim", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from longreadmapper_tpu.formats.catmeta import load_cat
    from longreadmapper_tpu.index.device import load_device_index
    from longreadmapper_tpu.models.mapper import TPUMapper
    from longreadmapper_tpu.utils.config import Params

    fa = os.path.join(args.dir, "ref.fa")
    log("devices:", jax.devices())
    t0 = time.time()
    idx, meta, mta = load_device_index(fa, slim=args.slim)
    hbm = sum(0 if a is None else np.prod(a.shape) * a.dtype.itemsize
              for a in idx if a is not None)
    log(f"index load: {time.time() - t0:.0f}s  n={meta.n} hlen={meta.hlen} "
        f"slim={meta.slim} device tables ~{hbm / 1e9:.2f} GB")

    t0 = time.time()
    cat = load_cat(fa + ".cat")
    reads = sample_reads_from_cat(cat, mta, args.n_reads, args.rlen,
                                  args.err, args.seed)
    del cat
    log(f"reads: {args.n_reads} x {args.rlen} bp @{args.err} "
        f"in {time.time() - t0:.0f}s")

    params = Params(hlen=meta.hlen)
    mapper = TPUMapper(idx, meta, mta, params, chunk_b=args.chunk_b)
    log(f"warmup: {mapper.warmup([args.rlen]):.1f}s")

    best_dt = None
    for p in range(args.passes):
        for k in mapper.phase_s:
            mapper.phase_s[k] = 0.0
        t0 = time.time()
        total = valid = 0
        it = (reads[s:s + args.chunk_b]
              for s in range(0, len(reads), args.chunk_b))
        for recs in mapper.map_stream(it):
            valid += sum(r.valid for r in recs)
            total += len(recs)
        dt = time.time() - t0
        ph = " ".join(f"{k}={v:.2f}s" for k, v in mapper.phase_s.items())
        log(f"pass {p}: {dt:.2f}s ({total / dt:.0f} reads/s) "
            f"sens {valid}/{total}  phases: {ph}")
        best_dt = dt if best_dt is None else min(best_dt, dt)

    rps = args.n_reads / best_dt
    print(json.dumps({
        "metric": "genome_scale_reads_per_s_per_chip", "value": round(rps, 1),
        "unit": "reads/s", "genome_positions": meta.n, "slim": meta.slim,
        "sensitivity": valid / total,
        "overflow_reads": mapper.overflow_reads,
        "retried_reads": mapper.retried_reads,
        "device_tables_gb": round(hbm / 1e9, 2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
