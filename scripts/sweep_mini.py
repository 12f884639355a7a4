#!/usr/bin/env python
"""The reference's parameter-sweep experiment in miniature: a
seed_len x thres sensitivity grid on the 45%-repeat genome.

The reference explored this surface with 210 SLURM jobs against hg19
(/root/reference/scripts/gen-sbatch-scripts.py:74-111), one process per
point, sensitivity logged at exit (alnmain.c:541-542).  Here the index
is built once and every point reuses it in-process; it runs on the
default JAX device, and JAX_PLATFORMS=cpu suffices because sensitivity
is backend-independent (the device step is bit-identical across
backends — tests/test_e2e.py).

Writes one JSON line per point to --out (default sweep.jsonl) and a
markdown table to stdout.

Usage: python scripts/sweep_mini.py [--mb 4] [--n-reads 2000] [--hlen 12]
         [--seed-lens 16,20,24,28] [--thres 100,300,1000] [--err 0.03]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from longreadmapper_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=4)
    ap.add_argument("--n-reads", type=int, default=2000)
    ap.add_argument("--rlen", type=int, default=1000)
    ap.add_argument("--err", type=float, default=0.03)
    ap.add_argument("--hlen", type=int, default=12)
    ap.add_argument("--seed-lens", default="16,20,24,28")
    ap.add_argument("--thres", default="100,300,1000")
    ap.add_argument("--chunk-b", type=int, default=512)
    ap.add_argument("--cache", default=os.path.join(
        tempfile.gettempdir(), "lrm_sweep_cache"))
    ap.add_argument("--out", default="sweep.jsonl")
    a = ap.parse_args()

    from gen_repeat_genome import build_repeat_genome
    from longreadmapper_tpu.formats.catmeta import (create_meta, load_cat,
                                                    load_mta)
    from longreadmapper_tpu.index.device import (build_device_index,
                                                 load_device_index)
    from longreadmapper_tpu.index.fmi import FMIndex, encode_bytes
    from longreadmapper_tpu.index.lchash import lc_build_from_sa
    from longreadmapper_tpu.index.sa import sa_build
    from longreadmapper_tpu.formats.lch import write_lch
    from longreadmapper_tpu.models.mapper import TPUMapper
    from longreadmapper_tpu.utils.config import Params

    rng = np.random.default_rng(2026)
    genome = build_repeat_genome(rng, a.mb * 1_000_000)
    os.makedirs(a.cache, exist_ok=True)
    fa = os.path.join(a.cache, f"rep{a.mb}_h{a.hlen}.fa")
    prefix = fa + ".cat"
    if not os.path.exists(prefix + ".lch"):
        t0 = time.time()
        with open(fa, "w") as f:
            f.write(">r1\n")
            for i in range(0, len(genome), 1 << 16):
                f.write(genome[i:i + (1 << 16)] + "\n")
        create_meta(fa, n_seed=0)
        sa = sa_build(prefix)
        fmi = FMIndex.build(prefix, sa=sa)
        fmi.write(prefix)
        kl = lc_build_from_sa(sa, encode_bytes(load_cat(prefix)), a.hlen)
        write_lch(prefix + ".lch", a.hlen, kl)
        log(f"index built in {time.time() - t0:.0f}s -> {a.cache}")
    idx, meta, mta = load_device_index(fa)
    log(f"index loaded (hlen={meta.hlen}, n={meta.n})")

    # reads with planted truth: sensitivity here = mapper 'valid' exactly
    # as the reference logs it (valid/total)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(a.n_reads):
        p = int(rng.integers(0, len(genome) - a.rlen))
        s = genome[p:p + a.rlen]
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        ch = np.frombuffer(s.encode(), np.uint8).copy()
        m = rng.random(a.rlen) < a.err
        ch[m] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(m.sum()))]
        reads.append((f"r{i}", ch.tobytes().decode(), None))

    seed_lens = [int(x) for x in a.seed_lens.split(",")]
    thres_list = [int(x) for x in a.thres.split(",")]
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    rows = {}
    with open(a.out, "a") as outf:
        for sl in seed_lens:
            for th in thres_list:
                params = Params(hlen=a.hlen, seed_len=sl, thres=th)
                mapper = TPUMapper(idx, meta, mta, params,
                                   chunk_b=a.chunk_b)
                t0 = time.time()
                valid = total = 0
                chunks = (reads[s:s + a.chunk_b]
                          for s in range(0, len(reads), a.chunk_b))
                for recs in mapper.map_stream(chunks):
                    valid += sum(r.valid for r in recs)
                    total += len(recs)
                row = dict(seed_len=sl, thres=th, hlen=a.hlen,
                           sensitivity=round(valid / total, 4),
                           valid=valid, total=total,
                           retried=mapper.retried_reads,
                           overflow=mapper.overflow_reads,
                           wall_s=round(time.time() - t0, 1))
                outf.write(json.dumps(row) + "\n")
                outf.flush()
                rows[(sl, th)] = row
                log(f"sl={sl} th={th}: {valid}/{total} "
                    f"({time.time() - t0:.0f}s, retried "
                    f"{mapper.retried_reads})")

    # markdown surface
    print(f"\n| seed_len \\ thres | " +
          " | ".join(str(t) for t in thres_list) + " |")
    print("|---" * (len(thres_list) + 1) + "|")
    for sl in seed_lens:
        cells = " | ".join(f"{rows[(sl, t)]['sensitivity']:.4f}"
                           for t in thres_list)
        print(f"| {sl} | {cells} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
