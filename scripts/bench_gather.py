"""Microbench: sa_ctx gather layouts on the real chip (dev tool).

Question 1: does gathering (R,) int64 rows cost half of (R, 2) int32 rows?
(If gathers cost per ELEMENT, fusing the (sa, ctx) pair into one int64
element halves the seeding pipeline's dominant gather.)

Question 2 (row-width sweep): is the cost per ROW or per ELEMENT?  The
seeding slots of one (read, phase) are CONTIGUOUS sa_ctx rows (an SA
interval), so if (R, 4) int32 rows cost ~the same per row as (R, 2), the
pipeline can fetch TWO adjacent slots per gather row and halve the row
count of its dominant ~5.5M-row gather.  Measured per-width at the bench
row counts.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_ENABLE_X64", "1")   # int64 table variant
from longreadmapper_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *a, n=20):
    jax.block_until_ready(fn(*a))
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*a)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n


def main():
    n = 8_000_000
    rng = np.random.default_rng(0)
    tbl32 = jnp.asarray(rng.integers(0, 1 << 30, (n, 2), dtype=np.int32))
    tbl64 = jnp.asarray(rng.integers(0, 1 << 60, (n,), dtype=np.int64))
    for rows in (2_000_000, 5_500_000):
        idx = jnp.asarray(rng.integers(0, n, rows, dtype=np.int32))

        @jax.jit
        def g32(i):
            r = tbl32[i]
            return r[:, 0] + r[:, 1]

        @jax.jit
        def g64(i):
            r = tbl64[i]
            return (r >> 32).astype(jnp.int32) + r.astype(jnp.int32)

        t32 = timeit(g32, idx)
        t64 = timeit(g64, idx)
        print(f"rows={rows}: (R,2) int32 gather {t32*1e3:.2f} ms | "
              f"(R,) int64 gather {t64*1e3:.2f} ms | ratio {t32/t64:.2f}", flush=True)

    # row-width sweep: same total rows, widths 1/2/4/8 int32 per row
    for rows in (2_000_000, 5_500_000):
        idx = jnp.asarray(rng.integers(0, n // 8, rows, dtype=np.int32))
        line = [f"rows={rows}:"]
        for w in (1, 2, 4, 8):
            tblw = jnp.asarray(
                rng.integers(0, 1 << 30, (n // 8, w), dtype=np.int32))

            @jax.jit
            def gw(i, tblw=tblw):
                return tblw[i].sum(axis=-1)

            tw = timeit(gw, idx)
            line.append(f"w={w} {tw*1e3:.2f}ms ({tw/rows*1e9:.2f}ns/row)")
        print(" | ".join(line), flush=True)

    # the actual fusion candidate: R rows of (R,2) vs R/2 rows of (R,4)
    # over the SAME underlying pair table (adjacent-slot fetch)
    pair = jnp.asarray(rng.integers(0, 1 << 30, (n, 2), dtype=np.int32))
    quad = pair.reshape(n // 2, 4)
    for rows in (2_000_000, 5_500_000):
        base = rng.integers(0, n // 2 - 1, rows // 2, dtype=np.int32)
        i2 = jnp.asarray(np.repeat(base * 2, 2) + np.tile([0, 1], rows // 2))
        i4 = jnp.asarray(base)

        @jax.jit
        def g_pair(i):
            return pair[i].sum(axis=-1)

        @jax.jit
        def g_quad(i):
            return quad[i].sum(axis=-1)

        tp = timeit(g_pair, i2)
        tq = timeit(g_quad, i4)
        print(f"fusion rows={rows}: (R,2)x{rows} {tp*1e3:.2f} ms vs "
              f"(R/2,4)x{rows//2} {tq*1e3:.2f} ms | speedup {tp/tq:.2f}x",
              flush=True)


if __name__ == "__main__":
    main()
