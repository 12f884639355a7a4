"""Device FM-index rank (Occ) and backward-search primitives.

The reference's hot loop `_occ_access` (/root/reference/fmidx/fmidx.c:277-293)
rescans up to o_ratio BWT *bytes* per backward-search step.  The device
design stores the BWT 2-bit packed, 16 bases per int32 word, with per-word sampled
counts — one rank query is then exactly two HBM gathers (sample row + packed
word) plus a popcount, fully vectorized over thousands of query lanes:

    packed[i]      int32, bases 16i..16i+15, base b at bits [2b, 2b+1]
    occ_samp[i,c]  count of base c in bwt[0 .. 16i-1]   (exclusive)
    occ(c, loc)    = occ_samp[loc>>4, c] + popcount(matches in word, <= loc)

The single '$' in the BWT is packed as code 0 and corrected via its known
position, so counts match the reference exactly ('$' never counted:
fmidx.c:148).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

_M01 = 0x55555555  # even-bit mask: one bit per 2-bit base slot


# ----------------------------------------------------------------- host side

def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit base codes (values 0..3) into int32 words, 16 per word.

    Code at text position p lives in word p>>4 at bit offset 2*(p&15).
    Values >= 4 (the '$') must be remapped by the caller before packing.
    """
    codes = np.asarray(codes)
    assert codes.max(initial=0) < 4
    n = codes.shape[0]
    nw = (n + 15) // 16
    words = np.empty(nw, dtype=np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    chunk_words = 1 << 24                      # chunked: 4n-byte transients
    for ws in range(0, nw, chunk_words):       # would be 25 GB at hg19 scale
        we = min(ws + chunk_words, nw)
        padded = np.zeros((we - ws) * 16, dtype=np.uint32)
        c = codes[ws * 16:min(we * 16, n)]
        padded[:c.shape[0]] = c
        words[ws:we] = np.bitwise_or.reduce(
            padded.reshape(-1, 16) << shifts, axis=1)
    return words.view(np.int32)


def occ_samples(codes: np.ndarray, dollar_pos: int,
                dtype=None) -> np.ndarray:
    """(nw+1, 4) exclusive per-word base counts; the '$' position not counted.

    Chunked (a one-hot over all n positions would cost 32n bytes — 200 GB
    at hg19 scale).  Samples stay int32 whenever every per-base total fits
    (true for any real genome: the worst base of hg19's ~6.2e9-byte .cat
    counts ~1.9e9 < 2^31); pathological single-letter texts get int64."""
    codes = np.asarray(codes)
    n = codes.shape[0]
    nw = (n + 15) // 16
    per_word = np.zeros((nw, 4), dtype=np.int64)
    chunk_words = 1 << 22                      # 64 Mbase per pass
    for ws in range(0, nw, chunk_words):
        we = min(ws + chunk_words, nw)
        c = codes[ws * 16:we * 16]
        m = c.shape[0]
        oh = np.zeros(((we - ws) * 16, 4), dtype=np.int8)
        pos = np.arange(m)
        valid = c < 4
        oh[pos[valid], c[valid]] = 1
        per_word[ws:we] = oh.reshape(we - ws, 16, 4).sum(
            axis=1, dtype=np.int64)
    if codes[dollar_pos] < 4:
        per_word[dollar_pos >> 4, codes[dollar_pos]] -= 1
    out = np.zeros((nw + 1, 4), dtype=np.int64)
    np.cumsum(per_word, axis=0, out=out[1:])
    if dtype is None:
        dtype = np.int32 if out[-1].max(initial=0) < 2**31 else np.int64
    return out.astype(dtype)


# --------------------------------------------------------------- device side

def occ(packed, occ_samp, dollar_pos, c, loc):
    """Vectorized occ(c, loc) = #occurrences of base c in bwt[0..loc].

    c: int32 base codes in [0, 4) (callers mask N lanes), loc: int >= 0.
    All arguments broadcast; gathers clamp out-of-range lanes (masked upstream).
    """
    c = c.astype(jnp.int32)
    loc = loc.astype(packed.dtype) if packed.dtype == jnp.int64 else loc
    wid = (loc >> 4).astype(jnp.int32)
    off = (loc & 15).astype(jnp.int32)
    word = packed[jnp.clip(wid, 0, packed.shape[0] - 1)]
    pat = word ^ (c * jnp.int32(_M01))
    hit = (~pat) & (~(pat >> 1)) & jnp.int32(_M01)
    keep = jnp.int32(_M01) >> (2 * (15 - off))
    cnt = lax.population_count(hit & keep)
    # '$' is packed as code 0; subtract its spurious 'A' when in range.
    d_wid = jnp.int32(dollar_pos >> 4)
    d_off = jnp.int32(dollar_pos & 15)
    cnt = cnt - ((c == 0) & (wid == d_wid) & (d_off <= off)).astype(jnp.int32)
    samp = occ_samp[jnp.clip(wid, 0, occ_samp.shape[0] - 1), c]
    return samp + cnt.astype(occ_samp.dtype)


def backward_step(c4, packed, occ_samp, dollar_pos, k, l, c, active):
    """One LF backward-search step (fmidx.c:306-308), masked.

    k_new = C[c] + occ(c, k-1) + 1 ; l_new = C[c] + occ(c, l).
    `active` lanes update; inactive lanes (already empty interval, absent
    lchash entry, done early) pass (k, l) through unchanged.  Lanes whose
    next character is N (c == 4) become the empty interval (1, 0) — the
    reference behavior there is UB on uninitialized mapper entries
    (fmidx.c:297-301); this is our defined replacement.
    """
    is_n = c >= 4
    cc = jnp.minimum(c, 3).astype(jnp.int32)
    safe_k = jnp.maximum(k, 1)
    safe_l = jnp.clip(l, 0, occ_samp.shape[0] * 16 - 1)
    cbase = c4[cc]
    k_new = cbase + occ(packed, occ_samp, dollar_pos, cc, safe_k - 1) + 1
    l_new = cbase + occ(packed, occ_samp, dollar_pos, cc, safe_l)
    k_new = jnp.where(is_n, jnp.ones_like(k_new), k_new)
    l_new = jnp.where(is_n, jnp.zeros_like(l_new), l_new)
    k_out = jnp.where(active, k_new, k)
    l_out = jnp.where(active, l_new, l)
    return k_out, l_out
