"""Tiled long-read alignment: blocked banded NW with rematerialized
traceback — the GACT-class aligner for reads too long to keep a full
direction matrix in HBM.

The reference's GACT (absent submodule; Darwin ASPLOS'18 algorithm per
SURVEY.md §2) bounds memory by aligning fixed T x T tiles greedily and
stitching.  This design keeps the alignment EXACT instead:

  forward pass   — the banded DP runs tile-by-tile over query rows
                   (lax.scan of K tiles, T rows each), storing only each
                   tile's ENTRY row (checkpoint) and the band-center score
                   column: O(K * band) memory instead of O(L * band).
  traceback pass — tiles replay in reverse; each tile's 2-bit direction
                   rows are recomputed from its checkpoint (classic
                   rematerialization: 2x DP compute for O(T * band) dirs
                   memory), then the CIGAR walk crosses the tile on
                   device exactly as ops/traceback.py does.

Same contract as banded_nw_dirs + device_traceback (tie-break M > I > D,
query pad 4 never matches target pad 5, INF outside band/domain); tested
equal against the single-tile path.  The walk grants each tile T + W + 1
steps (a tile's walk takes T row-steps plus its share of <= ed <= W
D-steps), so op rows come out (K * (T + W + 1)) wide with pad gaps between
tile segments — the host RLE ignores pads.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .wavefront import INF, _minplus_scan

OP_PAD = 3


def _row0(B: int, L: int, W: int, band: int, q, dt):
    d_idx = jnp.arange(band, dtype=dt)
    j0 = d_idx - W
    row = jnp.where((j0 >= 0) & (j0 <= L), jnp.maximum(j0, 0), INF).astype(dt)
    return row[None, :] + q[:, :1].astype(dt) * 0


def _dp_row_step(q, tpad, L: int, W: int, band: int, with_dirs: bool,
                 vertical: bool = False):
    """Row update shared by both passes (see ops/wavefront.banded_nw_dirs).

    vertical=True: the step consumes a BASE row index i0 and advances 16
    rows, emitting one vertically packed direction word per band column
    (row i0+r at bit-pair r) — the layout the run-consuming walk eats."""
    B = q.shape[0]
    dt = jnp.int32
    d_idx = jnp.arange(band, dtype=dt)
    shifts = (2 * jnp.arange(16, dtype=dt))[None, None, :]

    def one_row(hprev, i):
        tw = lax.dynamic_slice(tpad, (jnp.int32(0), i), (B, band)).astype(dt)
        qc = lax.dynamic_slice(q, (jnp.int32(0), i - 1), (B, 1)).astype(dt)
        sub = (qc != tw).astype(dt)
        up = jnp.concatenate([hprev[:, 1:], jnp.full((B, 1), INF, dt)],
                             axis=1)
        cand = jnp.minimum(hprev + sub, up + 1)
        row = _minplus_scan(cand, band)
        j = i + d_idx[None, :] - W
        row = jnp.where((j >= 0) & (j <= L), jnp.minimum(row, INF), INF)
        if not with_dirs:
            return row, None
        diag_ok = (hprev < INF) & (hprev + sub == row)
        up_ok = up + 1 == row
        dirs = jnp.where(diag_ok, 0, jnp.where(up_ok, 1, 2))
        return row, dirs

    if vertical:
        assert with_dirs

        def step(hprev, i0):
            word = jnp.zeros((B, band), dt)
            for r in range(16):
                hprev, dirs = one_row(hprev, i0 + r)
                word = word | (dirs << (2 * r))
            return hprev, word

        return step

    def step(hprev, i):
        row, dirs = one_row(hprev, i)
        if not with_dirs:
            return row, row[:, W].astype(jnp.int16)
        packed = jnp.sum(dirs.reshape(B, band // 16, 16) << shifts,
                         axis=-1).astype(jnp.int32)
        return row, packed

    return step


@partial(jax.jit, static_argnames=("T", "W", "band"))
def gact_forward(q, t, T: int, W: int, band: int):
    """Forward checkpointed DP.

    q (B, L) query codes (pad 4), t (B, L) target codes (pad/'$' -> 5),
    L divisible by T.  Returns (ckpt (K+1, B, band) int32, wcol (L+1, B)
    int16) — ckpt[k] is H row k*T; wcol[i] = H[i, W] (ed of read b is
    wcol[lens_b, b]).

    Rows advance 16 per scan iteration: every loop iteration pays a
    fixed cost regardless of the work inside, so a one-row-per-iteration
    DP is bound by iteration count rather than arithmetic."""
    B, L = q.shape
    assert L % T == 0 and T % 16 == 0
    K = L // T
    dt = jnp.int32
    tpad = jnp.pad(t.astype(jnp.int8), ((0, 0), (W + 1, band)),
                   constant_values=5)
    row_step = _dp_row_step(q, tpad, L, W, band, with_dirs=False)

    def group(h, g):
        wcs = []
        for r in range(16):
            h, wc = row_step(h, g * 16 + 1 + r)
            wcs.append(wc)
        return h, jnp.stack(wcs, axis=0)                  # (16, B)

    def tile(h, k):
        h2, wc = lax.scan(group, h,
                          k * (T // 16) + jnp.arange(T // 16, dtype=dt))
        return h2, (h, wc)                    # emit ENTRY row + tile wcol

    h0 = _row0(B, L, W, band, q, dt)
    hK, (ckpt, wcols) = lax.scan(tile, h0, jnp.arange(K, dtype=jnp.int32))
    ckpt = jnp.concatenate([ckpt, hK[None]], axis=0)     # (K+1, B, band)
    wcol = jnp.concatenate([h0[:, W].astype(jnp.int16)[None],
                            wcols.reshape(L, B)], axis=0)
    return ckpt, wcol


def gact_runs_cols(L: int, T: int, W: int, scale: int = 1) -> int:
    """Run-byte columns emitted by gact_traceback_v.

    Iterations (one buffer row each) = per-tile max over lanes of
    word-fragments (L/16 total) + that lane's edits in the tile.  A
    single lane's edits sum to <= 2W, but the per-tile max can land on
    different lanes, so budget 4W of edit rows plus per-tile slack; the
    walk clamps its write pointer at this cap (run rows past it would be
    dropped — unreachable for realistic batches, where per-tile edit
    maxima track the error rate).

    `scale` multiplies the edit-row budget — the saturation retry tier
    (models/mapper._retry_saturation) re-runs a flagged chunk through a
    scale-4 step instead of keeping corrupt CIGARs."""
    return 2 * (L // 16 + scale * 4 * W + 4 * (L // T) + 16)


@partial(jax.jit, static_argnames=("T", "W", "band", "scale"))
def gact_traceback_v(q, t, ckpt, lens, T: int, W: int, band: int,
                     scale: int = 1):
    """Run-consuming rematerialized walk (the long-read twin of
    ops/traceback.device_traceback_v).

    Tiles replay newest-first; each recomputes its direction bits from its
    checkpoint row as VERTICALLY packed words ((T/16, B, band) — an M-run
    at fixed band column lives inside one word), then a while_loop walks
    runs with an all-lanes-done-in-tile early exit.  Iterations per tile
    are ~T/16 + this tile's edit count instead of the old per-cell
    T + W + 1 (at 50 kb / W=5000 that bound exploded to ~540k sequential
    steps and ~20 MB of padded per-cell ops D2H; runs are ~40x smaller).

    Returns (runs, saturated): runs (B, gact_runs_cols(L, T, W)) int8 —
    (count << 2) | op bytes in reverse path order with pad gaps (op 3)
    between tiles; same byte format as device_traceback_v, so host RLE
    merging is shared.  `saturated` (scalar bool) is True when the shared
    write pointer hit the last buffer row MORE than once — the second and
    later writes overwrite that row for ALL lanes, so every CIGAR in the
    batch is suspect; callers must OR it into the per-read overflow flag
    (mirroring the seed-vote overflow reporting) instead of silently
    emitting corrupt CIGARs.  Reachable only when several lanes stack
    near-worst-case edit clusters in distinct tiles (see gact_runs_cols).
    """
    B, L = q.shape
    K = L // T
    G = T // 16
    dt = jnp.int32
    tpad = jnp.pad(t.astype(jnp.int8), ((0, 0), (W + 1, band)),
                   constant_values=5)
    row_step = _dp_row_step(q, tpad, L, W, band, with_dirs=True,
                            vertical=True)
    bidx = jnp.arange(B, dtype=dt)
    lens32 = lens.astype(dt)
    n_rows = gact_runs_cols(L, T, W, scale) // 2
    tile_bound = G + 2 * W + 4

    def tile(carry, kk):
        i, j, done, ptr, nsat, buf = carry
        k = K - 1 - kk
        lo = k * T

        def group(h, gg):
            return row_step(h, k * T + 1 + gg * 16)

        _, vdirs = lax.scan(group, ckpt[k],
                            jnp.arange(G, dtype=dt))       # (G, B, band)
        Vf = vdirs.reshape(-1)

        def wstep(state):
            it, i, j, done, ptr, nsat, buf = state
            in_tile = (i > lo) | ((k == 0) & (i == 0))
            active = ~done & in_tile
            d = jnp.clip(j - i + W, 0, band - 1)
            rl = jnp.clip(i - 1 - lo, 0, T - 1)
            g = rl >> 4
            r = rl & 15
            word = jnp.take(Vf, jnp.clip((g * B + bidx) * band + d,
                                         0, G * B * band - 1))
            z = (word.astype(jnp.uint32)
                 << (2 * (15 - r)).astype(jnp.uint32))
            mrun = lax.clz(z.astype(dt)) >> 1
            mrun = jnp.where(active & (i > lo), jnp.minimum(mrun, r + 1), 0)
            i2 = i - mrun
            j2 = j - mrun
            done_mid = (i2 == 0) & (j2 == 0)
            # the edit ending the run, if its row is still in this word;
            # i2 == lo and k > 0 means the tile boundary cut the run
            in_word = mrun <= r
            cell = (word >> (2 * ((i2 - 1 - lo) & 15))) & 3
            op2 = jnp.where(i2 == 0, 2, cell)
            take2 = active & ~done_mid & (
                ((in_word & (i2 > lo)) | ((i2 == 0) & (j2 > 0))))
            i3 = jnp.where(take2 & (op2 == 1), i2 - 1, i2)
            j3 = jnp.where(take2 & (op2 == 2), j2 - 1, j2)
            done3 = done | ((i3 == 0) & (j3 == 0))
            b1 = jnp.where(mrun > 0, (mrun << 2) | 0, jnp.int32(OP_PAD))
            b2 = jnp.where(take2, 4 | op2, jnp.int32(OP_PAD))
            out = jnp.stack([b1, b2], axis=1).astype(jnp.int8)
            buf = lax.dynamic_update_slice(
                buf, out[None], (ptr, jnp.int32(0), jnp.int32(0)))
            # count writes that LAND on the clamped last row: the first is
            # legitimate, every later one clobbers it for all lanes
            nsat = nsat + (ptr == n_rows - 1).astype(dt)
            return (it + 1, i3, j3, done3,
                    jnp.minimum(ptr + 1, n_rows - 1), nsat, buf)

        def wcond(state):
            it, i, j, done, ptr, nsat, buf = state
            alive = ~done & ((i > lo) | ((k == 0) & (j > 0)))
            return (it < tile_bound) & jnp.any(alive)

        _, i, j, done, ptr, nsat, buf = lax.while_loop(
            wcond, wstep, (jnp.int32(0), i, j, done, ptr, nsat, buf))
        return (i, j, done, ptr, nsat, buf), None

    zb8 = (lens32 * 0).astype(jnp.int8)
    buf0 = jnp.full((n_rows, B, 2), OP_PAD, jnp.int8) + zb8[None, :, None]
    nsat0 = jnp.sum(lens32) * 0
    carry0 = (lens32, lens32, lens32 <= 0, jnp.int32(0), nsat0, buf0)
    (_, _, _, _, nsat, buf), _ = lax.scan(tile, carry0,
                                          jnp.arange(K, dtype=dt))
    return jnp.transpose(buf, (1, 0, 2)).reshape(B, -1), nsat >= 2


def gact_runs_cols_c(L: int, T: int, W: int, scale: int = 1) -> int:
    """int16 run-entry columns emitted by gact_traceback_c.

    Iterations (one buffer row each) = per-tile max over lanes of
    (indels in that tile + 1 boundary M-run), summed over tiles.  A
    single lane has <= ed <= W indels total; budget 2W of indel rows
    (the per-tile max can land on different lanes) plus one row per
    tile plus slack, with the shared-pointer saturation flag guarding
    the adversarial tail exactly as gact_runs_cols does; `scale` is the
    saturation retry tier's budget multiplier."""
    return 2 * (scale * 2 * W + 2 * (L // T) + 16)


@partial(jax.jit, static_argnames=("T", "W", "band", "scale"))
def gact_traceback_c(q, t, ckpt, lens, T: int, W: int, band: int,
                     scale: int = 1):
    """Column-consuming rematerialized walk — the long-read twin of
    ops/traceback.device_traceback_c (one iteration per INDEL).

    Tiles replay newest-first like gact_traceback_v; each recomputes its
    vertically packed direction words from its checkpoint, then builds a
    per-(lane, band-column) GROUP BITMAP (bit g set iff word g at that
    column has any non-M pair, one vectorized pass over the tile's
    (T/16, B, band) words — resident from the scan, ~0.1 ms) and walks
    whole M-runs per iteration: an M-run stays at fixed band column
    d = j - i + W, so the bitmap + two 1-element-per-lane gathers find
    the next indel *row* directly.  A substitutions-only lane crosses a
    whole tile in ONE iteration instead of T/16 word-fragments — at
    10 kb / T=512 that is 20 iterations per read instead of 640+, and
    each sequential iteration pays a fixed cost regardless of body.

    Returns (runs, saturated): runs (B, gact_runs_cols_c(L, T, W)) int16
    entries (count << 2 | op) in reverse path order with pad gaps
    between tiles — device_traceback_c's entry16 format, so the host RLE
    is shared.  `saturated` as in gact_traceback_v: True when the shared
    write pointer clobbered the clamped last row; callers OR it into the
    per-read overflow flag (mapping/pipeline.py gact branch).

    Dead lanes (unmapped / over-limit) must be masked to lens 0 by the
    caller — they would otherwise pace every tile's while_loop to its
    W-indel bound.  Counts fit int16: mrun <= T and the row-0 D-run
    < band - W (at row 0, d = j + W < band), both < 2^13 at every
    production shape up to ~130 kb reads; asserted.
    """
    B, L = q.shape
    K = L // T
    G = T // 16
    # (count << 2) must fit int16: counts are mrun <= T and drun < band - W
    assert T <= 8191 and band - W <= 8191, (T, band, W)
    dt = jnp.int32
    tpad = jnp.pad(t.astype(jnp.int8), ((0, 0), (W + 1, band)),
                   constant_values=5)
    row_step = _dp_row_step(q, tpad, L, W, band, with_dirs=True,
                            vertical=True)
    bidx = jnp.arange(B, dtype=dt)
    lens32 = lens.astype(dt)
    n_rows = gact_runs_cols_c(L, T, W, scale) // 2
    tile_bound = W + 4                 # iterations = indels in tile + slack
    nbm = -(-G // 32)                  # bitmap int32 words per (b, d)

    def tile(carry, kk):
        i, j, done, ptr, nsat, buf = carry
        k = K - 1 - kk
        lo = k * T

        def group(h, gg):
            return row_step(h, k * T + 1 + gg * 16)

        _, vdirs = lax.scan(group, ckpt[k],
                            jnp.arange(G, dtype=dt))       # (G, B, band)
        Vf = vdirs.reshape(-1)
        # per-(b, d) bitmap over this tile's G words (device_traceback_c's
        # fallback pass, cheap here: the tile volume is already resident)
        gr = jnp.arange(G, dtype=dt)
        nz = (vdirs != 0).astype(jnp.uint32) << (gr & 31)[:, None, None]
        nmf = [jnp.sum(jnp.where(((gr >> 5) == w)[:, None, None], nz, 0),
                       axis=0).reshape(-1).astype(dt) for w in range(nbm)]

        def _word_at(g, d):
            return jnp.take(Vf, jnp.clip((g * B + bidx) * band + d,
                                         0, G * B * band - 1))

        def wstep(state):
            it, i, j, done, ptr, nsat, buf = state
            in_tile = i > lo
            active = ~done & (in_tile | ((k == 0) & (j > 0)))
            d = jnp.clip(j - i + W, 0, band - 1)
            ii = jnp.clip(i - 1 - lo, 0, T - 1)        # row within tile
            g_cur, r = ii >> 4, ii & 15
            w_cur = _word_at(g_cur, d).astype(jnp.uint32)
            sh = (2 * (15 - r)).astype(jnp.uint32)
            wm_cur = (w_cur << sh) >> sh               # pairs above i off
            in_cur = (wm_cur != 0) & in_tile
            # highest group strictly below g_cur with any non-M
            bmidx = jnp.clip(bidx * band + d, 0, B * band - 1)
            g2 = jnp.full((B,), -1, dt)
            for w in range(nbm - 1, -1, -1):
                bw = jnp.take(nmf[w], bmidx).astype(jnp.uint32)
                lim = jnp.clip(g_cur - (w << 5), 0, 32)
                keep = jnp.where(lim >= 32, jnp.uint32(0xFFFFFFFF),
                                 (jnp.uint32(1) << jnp.minimum(
                                     lim, 31).astype(jnp.uint32)) - 1)
                bwk = bw & keep
                hi = 31 - lax.clz(bwk.astype(dt))
                g2 = jnp.where((g2 < 0) & (bwk != 0), (w << 5) + hi, g2)
            has_below = (g2 >= 0) & in_tile
            any_nm = active & in_tile & (in_cur | has_below)
            gstar = jnp.where(in_cur, g_cur, jnp.maximum(g2, 0))
            w2 = _word_at(gstar, d).astype(jnp.uint32)
            wsel = jnp.where(in_cur, wm_cur, w2)
            pstar = jnp.maximum(15 - (lax.clz(wsel.astype(dt)) >> 1), 0)
            # M-run floor: the indel row, else the tile entry (row 0 in
            # tile 0 — the walk then owes only the synthetic all-D row)
            floor_row = jnp.where(any_nm, lo + gstar * 16 + pstar + 1,
                                  jnp.where(k == 0, 0, lo))
            mrun = jnp.where(active & in_tile, i - floor_row, 0)
            i2 = i - mrun
            j2 = j - mrun
            op = (wsel >> (2 * pstar).astype(jnp.uint32)).astype(dt) & 3
            take_e = any_nm & ~((i2 == 0) & (j2 == 0))
            i3 = jnp.where(take_e & (op == 1), i2 - 1, i2)
            j3 = jnp.where(take_e & (op == 2), j2 - 1, j2)
            drun = jnp.where(active & ~any_nm & (i2 == 0),
                             jnp.maximum(j2, 0), 0)
            j4 = jnp.where(drun > 0, 0, j3)
            done2 = done | ((i3 == 0) & (j4 == 0))
            e1 = jnp.where(mrun > 0, (mrun << 2) | 0, jnp.int32(OP_PAD))
            e2 = jnp.where(take_e, 4 | op,
                           jnp.where(drun > 0, (drun << 2) | 2,
                                     jnp.int32(OP_PAD)))
            out = jnp.stack([e1, e2], axis=1).astype(jnp.int16)
            buf = lax.dynamic_update_slice(
                buf, out[None], (ptr, jnp.int32(0), jnp.int32(0)))
            nsat = nsat + (ptr == n_rows - 1).astype(dt)
            return (it + 1, i3, j4, done2,
                    jnp.minimum(ptr + 1, n_rows - 1), nsat, buf)

        def wcond(state):
            it, i, j, done, ptr, nsat, buf = state
            alive = ~done & ((i > lo) | ((k == 0) & (j > 0)))
            return (it < tile_bound) & jnp.any(alive)

        _, i, j, done, ptr, nsat, buf = lax.while_loop(
            wcond, wstep, (jnp.int32(0), i, j, done, ptr, nsat, buf))
        return (i, j, done, ptr, nsat, buf), None

    zb16 = (lens32 * 0).astype(jnp.int16)
    buf0 = jnp.full((n_rows, B, 2), OP_PAD, jnp.int16) + zb16[None, :, None]
    nsat0 = jnp.sum(lens32) * 0
    carry0 = (lens32, lens32, lens32 <= 0, jnp.int32(0), nsat0, buf0)
    (_, _, _, _, nsat, buf), _ = lax.scan(tile, carry0,
                                          jnp.arange(K, dtype=dt))
    return jnp.transpose(buf, (1, 0, 2)).reshape(B, -1), nsat >= 2


@partial(jax.jit, static_argnames=("T", "W", "band"))
def gact_traceback(q, t, ckpt, lens, T: int, W: int, band: int):
    """Reverse rematerialized CIGAR walk.

    Returns ops (B, K*(T+W+1)) int8 in end-to-start order with pad gaps
    (code 3) between tile segments."""
    B, L = q.shape
    K = L // T
    steps = T + W + 1
    dt = jnp.int32
    tpad = jnp.pad(t.astype(jnp.int8), ((0, 0), (W + 1, band)),
                   constant_values=5)
    row_step = _dp_row_step(q, tpad, L, W, band, with_dirs=True)
    nw = band // 16
    bidx = jnp.arange(B, dtype=dt)
    lens32 = lens.astype(dt)

    def tile(carry, kk):
        i, j, done = carry
        k = K - 1 - kk
        # recompute this tile's packed dirs from its checkpoint row
        def inner(hc, r):
            return row_step(hc, k * T + 1 + r)
        _, dirs = lax.scan(inner, ckpt[k], jnp.arange(T, dtype=jnp.int32))   # (T, B, nw)
        Df = dirs.reshape(-1)
        lo = k * T

        def wstep(state, _):
            i, j, done = state
            # active: walk while inside this tile's rows; tile 0 also
            # finishes row 0 (pure D moves, as banded_nw_dirs row 0)
            in_tile = (i > lo) | (k == 0)
            active = ~done & in_tile
            d = j - i + W
            r = i - lo - 1                              # row within tile
            word = jnp.take(
                Df, jnp.clip((r * B + bidx) * nw + (d >> 4),
                             0, T * B * nw - 1))
            dir_ = jnp.where(i == 0, jnp.int32(2),
                             (word >> (2 * (d & 15))) & 3)
            op = jnp.where(active, dir_, jnp.int32(OP_PAD))
            i2 = jnp.where(active & ((op == 0) | (op == 1)), i - 1, i)
            j2 = jnp.where(active & ((op == 0) | (op == 2)), j - 1, j)
            done2 = done | ((i2 == 0) & (j2 == 0))
            return (i2, j2, done2), op.astype(jnp.int8)

        (i, j, done), ops = lax.scan(wstep, (i, j, done), None,
                                     length=steps)
        return (i, j, done), jnp.transpose(ops)        # (B, steps)

    carry0 = (lens32, lens32, lens32 <= 0)
    _, tiles = lax.scan(tile, carry0, jnp.arange(K, dtype=jnp.int32))    # (K, B, steps)
    return jnp.transpose(tiles, (1, 0, 2)).reshape(B, K * steps)
