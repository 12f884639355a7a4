"""Batched affine-gap Smith-Waterman on the device — the SSW-equivalent scorer.

The reference vendors Mengyao Zhao's striped Smith-Waterman (SSE2
intrinsics) as a standalone library + test target, not linked into accaln
(/root/reference/ssw/ssw.h:17, ssw/CMakeLists.txt:4-7).  Its wrapper
`compute_cigar` uses a 5x5 DNA matrix with match=+2, mismatch=-2,
gap open 3, gap extend 1, and N scoring 0 against everything
(/root/reference/ssw/ssw_use.c:27-54).

Design: same banded anti-diagonal layout as ops/wavefront.py (band
coordinate d = j - i + W), vectorized over the read batch.
Affine recurrences per row i (oe = open + ext, the cost of a gap's first
base in ssw's convention):

    F(i,j) = max(H(i-1,j) - oe, F(i-1,j) - ext)          (gap in query)
    A(i,j) = max(0, H(i-1,j-1) + s(q_i,t_j), F(i,j))     (non-E part)
    E(i,j) = max_{c<j} A(i,c) - oe - ext*(j-1-c)         (gap in target)
    H(i,j) = max(A, E)

The E unrolling is exact because E never profitably re-enters through a
previous E (oe >= ext); it is computed with one max-plus prefix scan over
the band, the negated min-plus scan of the edit kernel.  Returns the best
local score and its end position — the primary `ssw_align` contract (score1/ref_end1/read_end1, ssw.h:118).  CIGAR for a
chosen pair comes from the host-side native affine traceback
(longreadmapper_tpu/native/affine.cpp) — the `compute_cigar` equivalent.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .wavefront import _minplus_scan

NEG = -(1 << 20)


def _maxplus_scan(x, band: int, ext: int):
    """Inclusive max-plus scan: out[d] = max_{e<=d} x[e] - ext*(d-e).

    The negated min-plus scan of ops/wavefront, so both DPs share one
    lowering rule.  Requires x >= -INF (here x >= 0)."""
    return -_minplus_scan(-x, band, slope=ext)


@partial(jax.jit, static_argnames=("W", "band", "match", "mismatch",
                                   "gap_open", "gap_ext"))
def banded_sw_affine(q, t, W: int, band: int, match: int = 2,
                     mismatch: int = -2, gap_open: int = 3, gap_ext: int = 1):
    """Banded affine-gap local alignment scores for a batch.

    q, t: (B, L) codes 0..3; values >= 4 (N / padding) score 0 against
    anything (the reference's 5th matrix row/col).
    Returns (score (B,), end_i (B,), end_j (B,)): best-cell score and its
    1-based query/target end coordinates, (0, 0, 0) when nothing scores
    positive.  Ties resolve to the smallest (i, then j).
    """
    B, L = q.shape
    dt = jnp.int32
    d_idx = jnp.arange(band, dtype=dt)
    oe = gap_open + gap_ext

    tpad = jnp.pad(t.astype(jnp.int8), ((0, 0), (W + 1, band)),
                   constant_values=5)
    hrow0 = jnp.zeros((B, band), dt) + q[:, :1].astype(dt) * 0
    frow0 = jnp.full((B, band), NEG, dt) + q[:, :1].astype(dt) * 0

    def step(carry, i):
        hprev, fprev, sc, bi, bj = carry
        tw = lax.dynamic_slice(tpad, (jnp.int32(0), i), (B, band)).astype(dt)
        qc = lax.dynamic_slice(q, (jnp.int32(0), i - 1), (B, 1)).astype(dt)
        both_acgt = (qc < 4) & (tw < 4)
        sub = jnp.where(both_acgt,
                        jnp.where(qc == tw, match, mismatch), 0)
        hup = jnp.concatenate([hprev[:, 1:], jnp.full((B, 1), NEG, dt)],
                              axis=1)
        fup = jnp.concatenate([fprev[:, 1:], jnp.full((B, 1), NEG, dt)],
                              axis=1)
        f = jnp.maximum(hup - oe, fup - gap_ext)
        a = jnp.maximum(jnp.maximum(hprev + sub, f), 0)
        j = i + d_idx[None, :] - W
        in_dom = (j >= 1) & (j <= L)
        a = jnp.where(in_dom, a, 0)
        p = _maxplus_scan(a, band, gap_ext)
        e = jnp.concatenate([jnp.full((B, 1), NEG, dt), p[:, :-1]],
                            axis=1) - oe
        h = jnp.maximum(a, e)
        h = jnp.where(in_dom, h, 0)
        f = jnp.where(in_dom, f, NEG)
        rb = jnp.max(h, axis=1)
        rd = jnp.argmax(h, axis=1).astype(dt)
        better = rb > sc
        sc2 = jnp.where(better, rb, sc)
        bi2 = jnp.where(better, i, bi)
        bj2 = jnp.where(better, i + rd - W, bj)
        return (h, f, sc2, bi2, bj2), None

    zb = jnp.zeros((B,), dt) + q[:, 0].astype(dt) * 0
    carry0 = (hrow0, frow0, zb, zb, zb)
    (_, _, sc, bi, bj), _ = lax.scan(step, carry0, jnp.arange(1, L + 1, dtype=jnp.int32))
    none = sc <= 0
    z = jnp.zeros_like(sc)
    return (jnp.where(none, z, sc), jnp.where(none, z, bi),
            jnp.where(none, z, bj))
