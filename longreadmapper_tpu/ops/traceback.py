"""On-device batched CIGAR traceback over packed direction bits.

The DP emits 2-bit per-cell directions (ops/wavefront.banded_nw_dirs) — the
full score matrix is never materialized (HBM-write bound) and nothing big
ever crosses the host link: only the op string ((B, 2L) int8) leaves HBM.

The walk follows the stored directions (tie-break M > I > D baked in at DP
time, identical to native/align.cpp `lrm_traceback` — cross-checked in
tests), run as a lax.scan over path steps with every read in a vector lane.
Per-read path lengths differ; finished lanes emit the pad op 3.

Ops are emitted end-to-start; the host reverses and run-length-encodes
(models/mapper.py).  Op codes: 0=M, 1=I (consumes query), 2=D (consumes
target), 3=pad.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

OP_M, OP_I, OP_D, OP_PAD = 0, 1, 2, 3


def device_traceback(dirs, lens, L: int, W: int):
    """dirs: (L+1, B, band//16) int32, 2-bit packed direction per cell
    (ops/wavefront.banded_nw_dirs); lens: (B,).

    Returns ops (B, L+W+1) int8 in reverse path order, padded with OP_PAD.
    A path takes len + #I steps and #I == #D <= ed; reads the pipeline
    accepts have ed <= limit <= W, so L + W + 1 steps always complete
    their walk.  Over-limit reads may truncate — their CIGAR is discarded
    ('*' in SAM, models/mapper.py) exactly as the reference discards
    failed alignments (alnmain.c:466).
    """
    rows, B, nw = dirs.shape
    Df = dirs.reshape(-1)
    bidx = jnp.arange(B, dtype=jnp.int32)

    def step(carry, _):
        i, j, done = carry
        d = j - i + W
        word = jnp.take(Df, jnp.clip((i * B + bidx) * nw + (d >> 4),
                                     0, rows * B * nw - 1))
        dir_ = (word >> (2 * (d & 15))) & 3
        op = jnp.where(done, OP_PAD, dir_)
        i2 = jnp.where((op == OP_M) | (op == OP_I), i - 1, i)
        j2 = jnp.where((op == OP_M) | (op == OP_D), j - 1, j)
        done2 = done | ((i2 == 0) & (j2 == 0))
        return (i2, j2, done2), op.astype(jnp.int8)

    lens32 = lens.astype(jnp.int32)
    carry0 = (lens32, lens32, lens32 <= 0)
    _, ops = lax.scan(step, carry0, None, length=min(2 * L, L + W + 1))
    return jnp.transpose(ops)  # (B, L+W+1)


def traceback_v_iters(L: int, W: int) -> int:
    """Iteration bound of device_traceback_v (see its docstring)."""
    return -(-L // 16) + 2 * W + 4


def traceback_c_iters(L: int, W: int) -> int:
    """Iteration bound of device_traceback_c: one iteration per INDEL on
    the path (each I/D changes the band column and forces a new column
    fetch) plus the final M-run / row-0 D-run and slack.  An in-limit
    read has at most ed <= W indels; callers MUST mask over-limit /
    unmapped lanes to lens 0 (their CIGAR is discarded anyway) — the
    pipeline does (mapping/pipeline.py `alive`)."""
    return W + 6


def device_traceback_c(vdirs, lens, L: int, W: int, nm=None,
                       entry_dtype=jnp.int16):
    """Column-consuming CIGAR walk: one iteration per INDEL on the path.

    vdirs: (G, B, band) int32 — banded_nw_dirs_v's words, UNtransposed.

    Key fact: an M-run descends rows at a FIXED band column d (M moves
    i-1, j-1 and d = j - i + W stays put), so from cell (i, j) the path
    stays in column d until its first non-M direction below row i — and
    that cell is exactly the next indel on the path.

    Finding that indel without touching all G words per lane (a (B, G)
    wide gather per iteration, or a (B, band, G) transpose of the whole
    volume): a per-(b, d) GROUP BITMAP, built once before the loop with one
    vectorized pass over vdirs (bit g set iff group g's word has any
    non-M pair), tells which group holds the next indel; the loop then
    needs only three 1-element-per-lane gathers — the current group's
    word, the bitmap row, and the target group's word — ~8k gathered
    elements per iteration instead of 131k.

    One iteration consumes an arbitrarily long M-run plus one indel —
    iterations = #indels + 2 instead of device_traceback_v's
    L/16 + 2*edits (substitutions are M in unit-cost edit distance, so a
    3%-substitution 1 kb read batch walks in ~3 iterations, not ~64).

    Returns runs (B, 2 * traceback_c_iters(L, W)) of `entry_dtype` in
    reverse path order, each entry (count << 2) | op, ops 0=M 1=I 2=D,
    pad op 3 / count 0.  Counts reach max(L, band - W): the count field
    is dtype_bits - 2 wide, so callers MUST pass entry_dtype=jnp.int32
    when that exceeds 8191 (mid-length resident-dirs buckets — an int16
    21110M entry silently truncates to 4726M).  The host decode is
    shared with the byte format modulo the dtype
    (models/mapper._rle_groups).  Lanes with lens <= 0 emit nothing:
    callers mask dead reads (ed > limit) to skip their walk entirely.
    """
    G, B, band = vdirs.shape
    # count field = dtype_bits - 2: mrun <= L and the row-0 D-run < band
    assert max(L, band - W) < \
        (1 << (jnp.dtype(entry_dtype).itemsize * 8 - 3)), \
        (L, band, W, entry_dtype)
    Vf = vdirs.reshape(-1)
    bidx = jnp.arange(B, dtype=jnp.int32)
    n_iter = traceback_c_iters(L, W)
    nbm = -(-G // 32)                     # bitmap int32 words per (b, d)

    # group bitmap: bit (g & 31) of word g >> 5 set iff vdirs[g, b, d]
    # has any non-M pair.  Normally produced for free inside the DP scan
    # (ops/wavefront.banded_nw_dirs_v with_nm=True); the fallback pass
    # here re-reads the whole dirs volume (~5 ms at (2048, 1024, 256)).
    if nm is None:
        gr = jnp.arange(G, dtype=jnp.int32)
        nz = (vdirs != 0).astype(jnp.uint32) << (gr & 31)[:, None, None]
        nm = jnp.stack([jnp.sum(jnp.where(((gr >> 5) == w)[:, None, None],
                                          nz, 0), axis=0)
                        for w in range(nbm)], axis=0)    # (nbm, B, band)
    nmf = [nm[w].reshape(-1).astype(jnp.int32) for w in range(nbm)]

    def _word_at(g, d):
        return jnp.take(Vf, jnp.clip((g * B + bidx) * band + d,
                                     0, G * B * band - 1))

    def step(carry):
        i, j, done = carry
        active = ~done
        d = jnp.clip(j - i + W, 0, band - 1)
        ii = jnp.maximum(i - 1, 0)
        g_cur, r = ii >> 4, ii & 15
        # current group's word, pairs above row i masked off
        w_cur = _word_at(g_cur, d).astype(jnp.uint32)
        sh = (2 * (15 - r)).astype(jnp.uint32)
        wm_cur = (w_cur << sh) >> sh
        in_cur = wm_cur != 0
        # bitmap rows: highest group STRICTLY below g_cur with any non-M
        bmidx = jnp.clip(bidx * band + d, 0, B * band - 1)
        g2 = jnp.full((B,), -1, jnp.int32)
        for w in range(nbm - 1, -1, -1):
            bw = jnp.take(nmf[w], bmidx).astype(jnp.uint32)
            # keep bits for groups < g_cur within this bitmap word
            lim = jnp.clip(g_cur - (w << 5), 0, 32)
            # shift clamped to 31 (u32 << 32 is undefined); the lim == 32
            # lanes take the all-ones branch anyway
            keep = jnp.where(lim >= 32, jnp.uint32(0xFFFFFFFF),
                             (jnp.uint32(1) << jnp.minimum(
                                 lim, 31).astype(jnp.uint32)) - 1)
            bwk = bw & keep
            hi = 31 - lax.clz(bwk.astype(jnp.int32))
            g2 = jnp.where((g2 < 0) & (bwk != 0), (w << 5) + hi, g2)
        has_below = g2 >= 0
        any_nm = active & (i > 0) & (in_cur | has_below)
        gstar = jnp.where(in_cur, g_cur, jnp.maximum(g2, 0))
        w2 = _word_at(gstar, d).astype(jnp.uint32)
        wsel = jnp.where(in_cur, wm_cur, w2)
        pstar = 15 - (lax.clz(wsel.astype(jnp.int32)) >> 1)
        re = jnp.where(any_nm, gstar * 16 + pstar + 1, 0)       # indel row
        mrun = jnp.where(active, i - re, 0)                     # M rows re+1..i
        i2 = i - mrun
        j2 = j - mrun
        op = (w2 >> (2 * pstar).astype(jnp.uint32)).astype(jnp.int32) & 3
        op = jnp.where(in_cur,
                       (wm_cur >> (2 * pstar).astype(jnp.uint32)
                        ).astype(jnp.int32) & 3, op)
        take_e = any_nm                   # apply the indel (op is 1 or 2)
        i3 = jnp.where(take_e & (op == 1), i2 - 1, i2)
        j3 = jnp.where(take_e & (op == 2), j2 - 1, j2)
        # row 0 reached with target left: the synthetic all-D row
        drun = jnp.where(active & ~any_nm & (i2 == 0), jnp.maximum(j2, 0), 0)
        j4 = jnp.where(drun > 0, 0, j3)
        done2 = done | ((i3 == 0) & (j4 == 0))
        e1 = jnp.where(mrun > 0, (mrun << 2) | OP_M, OP_PAD)
        e2 = jnp.where(take_e, 4 | op,
                       jnp.where(drun > 0, (drun << 2) | OP_D, OP_PAD))
        out = jnp.stack([e1, e2], axis=1).astype(entry_dtype)
        return (i3, j4, done2), out

    lens32 = lens.astype(jnp.int32)

    def cond(state):
        it, (i, j, done), _ = state
        return (it < n_iter) & jnp.any(~done)

    def body(state):
        it, carry, buf = state
        carry2, out = step(carry)
        buf = lax.dynamic_update_slice(buf, out[None],
                                       (it, jnp.int32(0), jnp.int32(0)))
        return it + 1, carry2, buf

    zb16 = (lens32 * 0).astype(entry_dtype)
    buf0 = jnp.full((n_iter, B, 2), OP_PAD, entry_dtype) + \
        zb16[None, :, None]
    carry0 = (lens32, lens32, lens32 <= 0)
    _, _, runs = lax.while_loop(cond, body, (jnp.int32(0), carry0, buf0))
    return jnp.transpose(runs, (1, 0, 2)).reshape(B, -1)


def device_traceback_v(vdirs, lens, L: int, W: int):
    """Run-consuming CIGAR walk over VERTICALLY packed direction words
    (ops/wavefront.banded_nw_dirs_v, vdirs (G, B, band)).

    One gather fetches the 16-row word at the walk's current (row-group,
    band column); a whole M-run inside it collapses to one emitted
    (op, count) byte via a count-leading-zeros trick, then the following
    I/D (if still in-word) is applied too.  Iterations needed for a read
    with ed <= W edits: every M-run fragment (split only at 16-row word
    boundaries and at edits) plus every edit consumes one iteration, so

        n_iter = L/16 + 2W + 4

    — ~8x fewer gathers than the per-cell walk.

    Returns runs (B, 2*n_iter) int8 in reverse path order, each byte
    (count << 2) | op with op codes 0=M 1=I 2=D; bytes with op 3 or
    count 0 are padding.
    """
    G, B, band = vdirs.shape
    Vf = vdirs.reshape(-1)
    bidx = jnp.arange(B, dtype=jnp.int32)
    n_iter = traceback_v_iters(L, W)

    def step(carry):
        i, j, done = carry
        active = ~done
        d = jnp.clip(j - i + W, 0, band - 1)
        g = jnp.maximum(i - 1, 0) >> 4
        r = jnp.maximum(i - 1, 0) & 15
        flat = (g * B + bidx) * band + d
        word = jnp.take(Vf, jnp.clip(flat, 0, G * B * band - 1))
        # M-run length at bit-pair r going down: shift cell r to the top,
        # count leading zero pairs (M == 0b00)
        z = (word.astype(jnp.uint32) << (2 * (15 - r)).astype(jnp.uint32))
        mrun = lax.clz(z.astype(jnp.int32)) >> 1
        mrun = jnp.where(active & (i > 0), jnp.minimum(mrun, r + 1), 0)
        i2 = i - mrun
        j2 = j - mrun
        done_mid = (i2 == 0) & (j2 == 0)
        # the edit that ended the run, if its row is still in this word
        # (i2 == 0 is the synthetic all-D row 0)
        in_word = mrun <= r
        cell = (word >> (2 * ((i2 - 1) & 15))) & 3
        op2 = jnp.where(i2 == 0, 2, cell)
        take2 = active & ~done_mid & \
            ((in_word & (i2 > 0)) | ((i2 == 0) & (j2 > 0)))
        i3 = jnp.where(take2 & (op2 == 1), i2 - 1, i2)
        j3 = jnp.where(take2 & (op2 == 2), j2 - 1, j2)
        done3 = done | ((i3 == 0) & (j3 == 0))
        b1 = jnp.where(mrun > 0, (mrun << 2) | OP_M, OP_PAD)
        b2 = jnp.where(take2, 4 | op2, OP_PAD)
        out = jnp.stack([b1, b2], axis=1).astype(jnp.int8)
        return (i3, j3, done3), out

    # while_loop with an all-done early exit: the n_iter bound covers a
    # worst-case ed == W read, but a typical batch finishes in
    # ~L/16 + 2*mean(ed) iterations — half or less
    lens32 = lens.astype(jnp.int32)

    def cond(state):
        it, (i, j, done), _ = state
        return (it < n_iter) & jnp.any(~done)

    def body(state):
        it, carry, buf = state
        carry2, out = step(carry)
        buf = lax.dynamic_update_slice(buf, out[None],
                               (it, jnp.int32(0), jnp.int32(0)))
        return it + 1, carry2, buf

    # derive the buffer from `lens` so the while carry has a consistent
    # device-varying type under shard_map (a replicated-constant input
    # becoming data-varying output is rejected)
    zb8 = (lens32 * 0).astype(jnp.int8)
    buf0 = jnp.full((n_iter, B, 2), OP_PAD, jnp.int8) + zb8[None, :, None]
    carry0 = (lens32, lens32, lens32 <= 0)
    _, _, runs = lax.while_loop(cond, body, (jnp.int32(0), carry0, buf0))
    return jnp.transpose(runs, (1, 0, 2)).reshape(B, -1)
