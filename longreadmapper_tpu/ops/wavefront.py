"""Banded global-alignment DP (the GACT compute core).

Observable contract of the reference's GACT aligner (absent submodule; API at
/root/reference/mutils.c:94-105): unit-cost global alignment of a read
against a same-length reference window; score = edit distance; fails (-1)
when the distance exceeds the limit 2*ERROR_RATE*len (alnmain.c:428).

Design (SURVEY.md §7.7): a banded Needleman-Wunsch over rows, the whole
read batch vectorized.  Band coordinate d = j - i + W (W = static half-width,
chosen >= every read's limit so in-limit alignments are exact).  The in-row
insertion dependency H(i,j-1)+1 is resolved with a min-plus prefix scan, so
each row is a handful of whole-row vector ops — no scalar loops.

The full banded score matrix H is emitted ((B, L+1, band) int16) for host
traceback (longreadmapper_tpu/native/align.cpp) — the CIGAR walk is the one
sequential part of GACT.  Padding conventions: query padding code 4 never
matches target padding code 5; '$'/out-of-range target positions also map to
5; cells outside the band or the DP domain hold INF (0x3FFF).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

INF = 0x3FFF

SCAN_LOWERINGS = ("cummin", "doubling")
# The one lowering rule of the band DPs' scans: cummin on every backend.
# On the CPU it is one fused pass against log2(band) full-row passes; on
# an H100 80GB HBM3 (700 W) banded_nw_dirs_v took 10.33 vs 12.86 ms at
# (B 2048, L 1024, band 256) and 99.62 vs 119.60 ms at (B 200, L 10240,
# band 1152) with cummin vs doubling (chip_smoke.py phase 7, PERF.md).
SCAN_LOWERING = "cummin"


def _minplus_scan(x, band: int, slope: int = 1, lowering: str | None = None):
    """Inclusive min-plus scan: out[d] = min_{e<=d} x[e] + slope*(d - e).

    Two lowerings with equal outputs: the slope transform
    out = slope*d + cummin(x - slope*d), and a doubling scan of log2(band)
    shifted minima.  `lowering` None takes SCAN_LOWERING.  Entries of x
    must not exceed INF (the doubling scan's fill value)."""
    if (lowering or SCAN_LOWERING) == "cummin":
        d_idx = slope * jnp.arange(band, dtype=x.dtype)
        return d_idx + lax.cummin(x - d_idx, axis=x.ndim - 1)
    s = 1
    while s < band:
        shifted = jnp.concatenate(
            [jnp.full(x.shape[:-1] + (s,), INF, x.dtype), x[..., :-s]],
            axis=-1)
        x = jnp.minimum(x, shifted + slope * s)
        s *= 2
    return x


@partial(jax.jit, static_argnames=("W", "band"))
def banded_nw_scores(q, t, W: int, band: int):
    """Banded NW score matrix for a batch.

    q: (B, L) query codes (0..3, 4=N), padded with 4.
    t: (B, L) target codes with '$'/N/padding remapped to 5 by the caller.
    W: static half band width; band: static total width (>= 2W+1, typically
       padded to a lane multiple).
    Returns H: (L+1, B, band) int16 — row-major layout, rows leading (the
    natural scan-stacking order).
    """
    B, L = q.shape
    dt = jnp.int32

    # row 0: H(0, j) = j for 0 <= j <= L within band
    d_idx = jnp.arange(band, dtype=dt)
    j0 = d_idx - W
    row0 = jnp.where((j0 >= 0) & (j0 <= L), jnp.abs(j0), INF).astype(dt)
    # add varying zeros from q so the scan carry has a consistent
    # device-varying type under shard_map
    row0 = row0[None, :] + q[:, :1].astype(dt) * 0

    # target padded so tw[d] = t[i + d - W - 1] = tpad[i + d]
    tpad = jnp.pad(t.astype(jnp.int8), ((0, 0), (W + 1, band)),
                   constant_values=5)

    def step(hprev, i):
        tw = lax.dynamic_slice(tpad, (jnp.int32(0), i), (B, band)).astype(dt)
        qc = lax.dynamic_slice(q, (jnp.int32(0), i - 1), (B, 1)).astype(dt)
        sub = (qc != tw).astype(dt)
        up = jnp.concatenate(
            [hprev[:, 1:], jnp.full((B, 1), INF, dt)], axis=1)
        cand = jnp.minimum(hprev + sub, up + 1)
        row = _minplus_scan(cand, band)
        # mask outside DP domain: j = i + d - W must be in [0, L]
        j = i + d_idx[None, :] - W
        row = jnp.where((j >= 0) & (j <= L), row, INF)
        row = jnp.minimum(row, INF)
        return row, row.astype(jnp.int16)

    _, rows = lax.scan(step, row0, jnp.arange(1, L + 1, dtype=jnp.int32))
    return jnp.concatenate([row0.astype(jnp.int16)[None], rows], axis=0)


@partial(jax.jit, static_argnames=("W", "band"))
def banded_nw_ed(q, t, lens, W: int, band: int):
    """Edit distances only: returns (ed (B,), H).  ed = H[len_b, b, W]."""
    H = banded_nw_scores(q, t, W, band)
    B = q.shape[0]
    ed = H[lens, jnp.arange(B), W].astype(jnp.int32)
    return ed, H


@partial(jax.jit, static_argnames=("W", "band"))
def banded_nw_dirs(q, t, W: int, band: int):
    """Banded NW emitting only what downstream needs instead of the full
    H matrix (the production short-read path uses banded_nw_dirs_v below;
    this row-packed variant drives the gact long-read tiles).

    Returns:
      dirs  (L+1, B, band//16) int32 — per-cell traceback direction packed
            2 bits/cell (0=M diag, 1=I up, 2=D left), same tie-break order
            as native/align.cpp `lrm_traceback` (M > I > D, with the
            predecessor-< INF guard on the diagonal)
      wcol  (L+1, B) int16 — H[:, :, W], the global-alignment end column
            (ed of read b = wcol[len_b, b])
    """
    B, L = q.shape
    dt = jnp.int32
    assert band % 16 == 0

    d_idx = jnp.arange(band, dtype=dt)
    j0 = d_idx - W
    row0 = jnp.where((j0 >= 0) & (j0 <= L), jnp.maximum(j0, 0), INF).astype(dt)
    row0 = row0[None, :] + q[:, :1].astype(dt) * 0
    tpad = jnp.pad(t.astype(jnp.int8), ((0, 0), (W + 1, band)),
                   constant_values=5)
    shifts = (2 * jnp.arange(16, dtype=dt))[None, None, :]

    def pack(dirs):
        return jnp.sum(dirs.reshape(B, band // 16, 16) << shifts,
                       axis=-1).astype(jnp.int32)

    def step(hprev, i):
        tw = lax.dynamic_slice(tpad, (jnp.int32(0), i), (B, band)).astype(dt)
        qc = lax.dynamic_slice(q, (jnp.int32(0), i - 1), (B, 1)).astype(dt)
        sub = (qc != tw).astype(dt)
        up = jnp.concatenate(
            [hprev[:, 1:], jnp.full((B, 1), INF, dt)], axis=1)
        cand = jnp.minimum(hprev + sub, up + 1)
        row = _minplus_scan(cand, band)
        j = i + d_idx[None, :] - W
        row = jnp.where((j >= 0) & (j <= L), jnp.minimum(row, INF), INF)
        diag_ok = (hprev < INF) & (hprev + sub == row)
        up_ok = up + 1 == row
        dirs = jnp.where(diag_ok, 0, jnp.where(up_ok, 1, 2))
        return row, (pack(dirs), row[:, W].astype(jnp.int16))

    _, (dirs, wcol) = lax.scan(step, row0, jnp.arange(1, L + 1, dtype=jnp.int32))
    dirs0 = pack(jnp.full((B, band), 2, dt))[None]   # row 0: all D (left)
    wcol0 = row0[:, W].astype(jnp.int16)[None]
    return (jnp.concatenate([dirs0, dirs], axis=0),
            jnp.concatenate([wcol0, wcol], axis=0))


@partial(jax.jit, static_argnames=("W", "band", "with_nm"))
def banded_nw_dirs_v(q, t, W: int, band: int, with_nm: bool = False):
    """banded_nw_dirs with VERTICALLY packed direction words, sized for the
    run-consuming walk (ops/traceback.device_traceback_v).

    Word v[g, b, d] packs dirs for rows g*16+1 .. g*16+16 at band column d
    (2 bits per row; row i at bit-pair (i-1) & 15).  An M-run descends rows
    at a FIXED d, so it lives inside ONE word — the walk consumes a whole
    run per gather instead of one cell.  Requires L % 16 == 0.

    with_nm additionally returns the GROUP BITMAP for the column-consuming
    walk (ops/traceback.device_traceback_c): nm (ceil(G/32), B, band)
    uint32, bit (g & 31) of word g >> 5 set iff vdirs[g, b, d] has any
    non-M pair.  Accumulated in the scan CARRY while each word is still in
    registers — a post-hoc pass costs a full extra read of the ~134 MB
    dirs volume (measured ~5 ms at (2048, 1024, 256)); this is ~free.

    Returns (vdirs (L//16, B, band) int32, wcol (L+1, B) int16[, nm]).
    """
    B, L = q.shape
    assert L % 16 == 0
    dt = jnp.int32
    G = L // 16
    nbm = -(-G // 32)

    d_idx = jnp.arange(band, dtype=dt)
    j0 = d_idx - W
    row0 = jnp.where((j0 >= 0) & (j0 <= L), jnp.maximum(j0, 0), INF).astype(dt)
    row0 = row0[None, :] + q[:, :1].astype(dt) * 0
    tpad = jnp.pad(t.astype(jnp.int8), ((0, 0), (W + 1, band)),
                   constant_values=5)

    def group(carry, g):
        hprev, nm = carry
        word = jnp.zeros((B, band), dt)
        wcols = []
        for r in range(16):
            i = g * 16 + 1 + r
            tw = lax.dynamic_slice(tpad, (jnp.int32(0), i), (B, band)).astype(dt)
            qc = lax.dynamic_slice(q, (jnp.int32(0), i - 1), (B, 1)).astype(dt)
            sub = (qc != tw).astype(dt)
            up = jnp.concatenate(
                [hprev[:, 1:], jnp.full((B, 1), INF, dt)], axis=1)
            cand = jnp.minimum(hprev + sub, up + 1)
            row = _minplus_scan(cand, band)
            j = i + d_idx[None, :] - W
            row = jnp.where((j >= 0) & (j <= L), jnp.minimum(row, INF), INF)
            diag_ok = (hprev < INF) & (hprev + sub == row)
            up_ok = up + 1 == row
            dirs = jnp.where(diag_ok, 0, jnp.where(up_ok, 1, 2))
            word = word | (dirs << (2 * r))
            wcols.append(row[:, W].astype(jnp.int16))
            hprev = row
        if with_nm:
            bit = (word != 0).astype(jnp.uint32) << (g & 31).astype(jnp.uint32)
            nm = tuple(jnp.where((g >> 5) == w, nm[w] | bit, nm[w])
                       for w in range(nbm))
        return (hprev, nm), (word, jnp.stack(wcols, axis=0))

    nm0 = tuple(jnp.zeros((B, band), jnp.uint32) + row0.astype(jnp.uint32) * 0
                for _ in range(nbm)) if with_nm else ()
    (_, nmF), (words, wcols) = lax.scan(
        group, (row0, nm0), jnp.arange(G, dtype=jnp.int32))
    wcol = jnp.concatenate([row0[:, W].astype(jnp.int16)[None],
                            wcols.reshape(L, B)], axis=0)
    if with_nm:
        return words, wcol, jnp.stack(nmF, axis=0)
    return words, wcol
