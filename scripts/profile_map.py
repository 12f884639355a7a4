"""Per-stage timing of the device map step on the real chip (dev tool)."""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from longreadmapper_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from longreadmapper_tpu.formats.catmeta import create_meta, load_cat, load_mta
from longreadmapper_tpu.formats.fastx import encode_seq
from longreadmapper_tpu.index.device import build_device_index
from longreadmapper_tpu.index.fmi import FMIndex
from longreadmapper_tpu.index.fmi import encode_bytes
from longreadmapper_tpu.index.lchash import lc_build_from_sa
from longreadmapper_tpu.index.sa import sa_build
from longreadmapper_tpu.mapping.pipeline import (MapperConfig, _seed_vote,
                                                 make_map_step)
from longreadmapper_tpu.ops.traceback import device_traceback_v
from longreadmapper_tpu.ops.wavefront import banded_nw_dirs_v
from longreadmapper_tpu.utils.config import Params

GENOME_MB = int(os.environ.get("GMB", 4))
B = int(os.environ.get("B", 128))
RL = int(os.environ.get("RL", 1000))
HLEN = int(os.environ.get("HLEN", 12))
# PROF_CACHE=/tmp/lrm_bench_cache_g4_h14: load the bench.py BENCH_CACHE=1
# index via load_device_index instead of rebuilding (the hlen-14 lchash
# host build alone is ~200 s); the bench genome is seeded (2026) so the
# text regenerates identically for read/target sampling.
PROF_CACHE = os.environ.get("PROF_CACHE", "")


def timeit(fn, *a, n=5):
    fn(*a)  # compile
    jax.block_until_ready(fn(*a))
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*a)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n


def main():
    n = GENOME_MB * 1_000_000
    if PROF_CACHE:
        from longreadmapper_tpu.index.device import load_device_index
        rng = np.random.default_rng(2026)          # bench.py's genome seed
        genome = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
        fa = os.path.join(PROF_CACHE, "ref.fa")
        t0 = time.time()
        idx, meta, _ = load_device_index(fa)
        assert meta.hlen == HLEN, (meta.hlen, HLEN)
        print(f"index load (cache): {time.time()-t0:.1f}s", flush=True)
        rng = np.random.default_rng(7)             # read sampling as below
    else:
        tmp = tempfile.mkdtemp(prefix="lrm_prof_")
        rng = np.random.default_rng(7)
        genome = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
        fa = os.path.join(tmp, "ref.fa")
        with open(fa, "w") as f:
            f.write(">chr1\n")
            for i in range(0, n, 1 << 16):
                f.write(genome[i:i + (1 << 16)] + "\n")
        t0 = time.time()
        mta = create_meta(fa, n_seed=0)
        prefix = fa + ".cat"
        sa = sa_build(prefix)
        fmi = FMIndex.build(prefix, sa=sa)
        print(f"SA+FMI: {time.time()-t0:.1f}s", flush=True)
        t0 = time.time()
        kl = lc_build_from_sa(fmi.sa, encode_bytes(load_cat(prefix)), HLEN)
        print(f"lchash from SA: {time.time()-t0:.1f}s", flush=True)
        idx, meta = build_device_index(fmi, kl, HLEN, load_cat(prefix),
                                       load_mta(fa + ".mta"))

    params = Params(hlen=HLEN)
    L = 1024
    cfg = MapperConfig.from_params(params, meta, B=B, L=L)
    print(f"cfg: phases={cfg.phases} max_seeds={cfg.max_seeds} "
          f"vote_slots={cfg.vote_slots} W={cfg.W} band={cfg.band}", flush=True)

    comp = str.maketrans("ACGT", "TGCA")
    codes = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    pos = np.zeros(B, dtype=np.int64)
    for i in range(B):
        p = int(rng.integers(0, n - RL))
        pos[i] = p
        s = genome[p:p + RL]
        if i % 2:
            s = s.translate(comp)[::-1]
        ch = np.frombuffer(s.encode(), np.uint8).copy()
        mask = rng.random(RL) < 0.03
        ch[mask] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(mask.sum()))]
        codes[i, :RL] = encode_seq(ch.tobytes().decode())
        lens[i] = RL
    limits = ((params.error_rate * lens.astype(np.float64)) * 2).astype(np.int32)
    comp_codes = np.where(codes < 4, 3 - codes, codes)[:, ::-1]
    codes_rc = np.full((B, L), 4, dtype=np.int8)
    for i in range(B):
        n_i = int(lens[i])
        codes_rc[i, :n_i] = comp_codes[i, L - n_i:]
    codes, codes_rc, lens, limits = map(
        jnp.asarray, (codes, codes_rc, lens, limits))

    step = make_map_step(cfg)
    t_full = timeit(lambda: step(idx, codes, codes_rc, lens, limits))
    print(f"full step: {t_full*1e3:.1f} ms -> {B/t_full:.0f} reads/s", flush=True)

    # NB: every jitted stage closure must take its arrays as ARGUMENTS —
    # a zero-arg lambda captures the multi-GB device index as HLO
    # constants (a multi-GB program to compile and ship).
    sv = jax.jit(lambda i, c, ln: _seed_vote(cfg, i, c, ln))
    t_sv = timeit(sv, idx, codes, lens)
    print(f"seed+vote: {t_sv*1e3:.1f} ms", flush=True)

    # align-only on dummy targets (the production short-read path:
    # vertically-packed direction words + run-consuming walk)
    # rebuild a byte view of the text from the packed words (the device
    # index no longer carries the raw byte text)
    tp = np.asarray(idx.text_packed).view(np.uint32)
    tbytes = ((tp[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
              ).reshape(-1)[:meta.n].astype(np.int8)
    tbytes[meta.n - 1] = 5                       # '$' never matches
    # REALISTIC targets: each read's true window (reverse-strand reads
    # align their RC against the forward window, like the step does).  A
    # fixed garbage window makes every path worst-case (max edits) and
    # the run-consuming walks then measure their iteration BOUND, not
    # their real cost.
    t_host = tbytes[np.clip(np.arange(L)[None, :] + pos[:, None],
                            0, meta.n - 1)]
    t_arr = jnp.asarray(t_host)
    q_aln = jnp.asarray(np.where((np.arange(B) % 2)[:, None],
                                 np.asarray(codes_rc), np.asarray(codes)))
    aln = jax.jit(lambda q, t: banded_nw_dirs_v(q, t, cfg.W, cfg.band))
    t_al = timeit(aln, q_aln, t_arr)
    cells = B * L * cfg.band
    print(f"align (banded_nw_dirs_v): {t_al*1e3:.1f} ms -> {cells/t_al/1e9:.1f} Gcells/s", flush=True)

    vdirs, _ = aln(q_aln, t_arr)
    tb = jax.jit(lambda v, ln: device_traceback_v(v, ln, L, cfg.W))
    t_tb = timeit(tb, vdirs, lens)
    print(f"traceback (v-walk): {t_tb*1e3:.1f} ms", flush=True)

    from longreadmapper_tpu.ops.traceback import device_traceback_c
    tbc = jax.jit(lambda v, ln: device_traceback_c(v, ln, L, cfg.W))
    t_tbc = timeit(tbc, vdirs, lens)
    print(f"traceback (c-walk, post-hoc bitmap): {t_tbc*1e3:.1f} ms",
          flush=True)
    alnm = jax.jit(lambda q, t: banded_nw_dirs_v(q, t, cfg.W, cfg.band,
                                                 with_nm=True))
    t_alnm = timeit(alnm, q_aln, t_arr)
    _, _, nm_arr = alnm(q_aln, t_arr)
    tbc2 = jax.jit(lambda v, ln, nm_a: device_traceback_c(v, ln, L, cfg.W,
                                                          nm=nm_a))
    t_tbc2 = timeit(tbc2, vdirs, lens, nm_arr)
    print(f"align with_nm: {t_alnm*1e3:.1f} ms (+{(t_alnm-t_al)*1e3:.1f}); "
          f"c-walk given nm: {t_tbc2*1e3:.1f} ms", flush=True)


if __name__ == "__main__":
    main()
