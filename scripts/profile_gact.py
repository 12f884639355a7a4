"""Per-stage timing of the LONG-READ (gact) device path on the real chip.

Realistic (read, window) pairs: targets are each read's TRUE genome
window — the ledger's round-4 lesson is that garbage windows drive every
walk to its iteration BOUND and the standalone numbers lie (CLAUDE.md).

Stages timed: gact_forward (checkpointed DP), gact_traceback_c (per-indel
column walk, production default), gact_traceback_v (per-word run walk,
LRM_TB_COLWALK=0 fallback), and the full map step.

Usage:  B=256 RL=10000 HLEN=14 PROF_CACHE=/tmp/lrm_bench_cache_g4_h14 \
            python scripts/profile_gact.py
INDEL=0.002 plants small indels in the reads (default subs-only 3%).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from longreadmapper_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

GENOME_MB = int(os.environ.get("GMB", 4))
B = int(os.environ.get("B", 256))
RL = int(os.environ.get("RL", 10000))
HLEN = int(os.environ.get("HLEN", 14))
ERR = float(os.environ.get("ERR", 0.03))
INDEL = float(os.environ.get("INDEL", 0.0))
PROF_CACHE = os.environ.get("PROF_CACHE", "")


def timeit(fn, *a, n=5):
    fn(*a)
    jax.block_until_ready(fn(*a))
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*a)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n


def main():
    from longreadmapper_tpu.index.device import load_device_index
    from longreadmapper_tpu.mapping.pipeline import MapperConfig, make_map_step
    from longreadmapper_tpu.models.mapper import _bucket_len
    from longreadmapper_tpu.ops.gact import (gact_forward, gact_traceback_c,
                                             gact_traceback_v)
    from longreadmapper_tpu.utils.config import Params

    n = GENOME_MB * 1_000_000
    assert PROF_CACHE, "set PROF_CACHE to a bench.py BENCH_CACHE dir"
    rng = np.random.default_rng(2026)              # bench.py genome seed
    genome_codes = rng.integers(0, 4, n).astype(np.int8)
    fa = os.path.join(PROF_CACHE, "ref.fa")
    t0 = time.time()
    idx, meta, _ = load_device_index(fa)
    assert meta.hlen == HLEN, (meta.hlen, HLEN)
    print(f"index load (cache): {time.time()-t0:.1f}s", flush=True)

    L = _bucket_len(RL)
    params = Params(hlen=HLEN)
    cfg = MapperConfig.from_params(params, meta, B=B, L=L)
    if os.environ.get("LRM_HALF_BAND", "1") != "0":
        from dataclasses import replace
        # the production mapper config for long buckets: half band on
        # the gact path AND the resident-dirs path (models/mapper)
        cfg = replace(cfg, half_band=True,
                      short_W_override=max(64, cfg.W // 2))
    T, W, band = cfg.gact_tile, cfg.gact_W, cfg.gact_band
    print(f"cfg: B={B} L={L} T={T} W={W} band={band} "
          f"half_band={cfg.half_band} use_gact={cfg.use_gact} "
          f"(dirs vol {cfg.B * (cfg.L // 16) * cfg.short_band * 4 / 1e6:.0f}"
          f" MB) vote_slots={cfg.vote_slots}", flush=True)

    rng = np.random.default_rng(7)
    q = np.full((B, L), 4, np.int8)
    qrc = np.full((B, L), 4, np.int8)
    t_host = np.full((B, L), 5, np.int8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        p = int(rng.integers(0, n - RL - 100))
        src = genome_codes[p:p + RL].copy()
        # subs
        m = rng.random(RL) < ERR
        src[m] = (src[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if INDEL > 0:
            keep = rng.random(RL) >= INDEL / 2
            src = src[keep]
            ins_at = np.flatnonzero(rng.random(len(src)) < INDEL / 2)
            src = np.insert(src, ins_at,
                            rng.integers(0, 4, len(ins_at)).astype(np.int8))
            src = src[:RL]
        rl = len(src)
        lens[i] = rl
        # all reads forward-strand: stage costs are strand-independent
        # (reverse reads align their RC through the identical kernels)
        q[i, :rl] = src
        qrc[i, :rl] = (3 - src)[::-1]
        # realistic target: the true forward window
        w = genome_codes[p:p + L]
        t_host[i, :len(w)] = w
    limits = ((params.error_rate * lens.astype(np.float64)) * 2
              ).astype(np.int32)

    q_aln = jnp.asarray(q)                    # fwd-strand query vs window
    t_arr = jnp.asarray(t_host)
    lens_j = jnp.asarray(lens)

    fwd = jax.jit(lambda a, b: gact_forward(a, b, T, W, band))
    t_f = timeit(fwd, q_aln, t_arr)
    cells = B * L * band
    flag = ""
    if cells / t_f / 1e9 > 200:
        # a stage rate this high means the timer missed the work; trust
        # the full-step delta instead
        flag = "  [IMPLAUSIBLE timing, ignore]"
    print(f"gact_forward: {t_f*1e3:.1f} ms -> {cells/t_f/1e9:.2f} Gcells/s"
          f"{flag}", flush=True)

    ckpt, wcol = fwd(q_aln, t_arr)
    ed = np.asarray(wcol)[lens, np.arange(B)]
    print(f"ed: mean {ed.mean():.0f} max {ed.max()} (limit {limits.max()})",
          flush=True)

    tbc = jax.jit(lambda a, b, c, ln: gact_traceback_c(a, b, c, ln, T, W,
                                                       band))
    t_c = timeit(tbc, q_aln, t_arr, ckpt, lens_j)
    print(f"gact_traceback_c (per-indel): {t_c*1e3:.1f} ms", flush=True)

    tbv = jax.jit(lambda a, b, c, ln: gact_traceback_v(a, b, c, ln, T, W,
                                                       band))
    t_v = timeit(tbv, q_aln, t_arr, ckpt, lens_j)
    print(f"gact_traceback_v (per-word):  {t_v*1e3:.1f} ms", flush=True)

    # resident-dirs path stages (the production default when the dirs
    # volume fits — MapperConfig.use_gact): single-pass dirs DP + the
    # per-indel walk over the whole resident volume
    from longreadmapper_tpu.ops.traceback import device_traceback_c
    from longreadmapper_tpu.ops.wavefront import banded_nw_dirs_v
    Ws, bands = cfg.short_W, cfg.short_band
    rd = jax.jit(lambda a, b: banded_nw_dirs_v(a, b, Ws, bands,
                                               with_nm=True))
    t_rd = timeit(rd, q_aln, t_arr)
    print(f"resident dirs DP (with_nm): {t_rd*1e3:.1f} ms -> "
          f"{B * L * bands / t_rd / 1e9:.2f} Gcells/s", flush=True)
    vdirs_r, _, nm_r = rd(q_aln, t_arr)
    edt = jnp.int32
    rw = jax.jit(lambda v, ln, nm_a: device_traceback_c(
        v, ln, L, Ws, nm=nm_a,
        entry_dtype=edt if max(L, bands - Ws) >= 8192 else jnp.int16))
    t_rw = timeit(rw, vdirs_r, lens_j, nm_r)
    print(f"resident per-indel walk: {t_rw*1e3:.1f} ms "
          f"(vs gact fwd+walk_c {(t_f + t_c)*1e3:.1f})", flush=True)

    step = make_map_step(cfg)
    dq, dqrc, dl, dlim = map(jnp.asarray, (q, qrc, lens, limits))
    t_s = timeit(lambda: step(idx, dq, dqrc, dl, dlim), n=3)
    path = "gact" if cfg.use_gact else "resident"
    print(f"full step ({path}): {t_s*1e3:.1f} ms -> {B/t_s:.0f} reads/s "
          f"device-side", flush=True)


if __name__ == "__main__":
    main()
