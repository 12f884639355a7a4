"""Device-resident index: the device layout of the reference's in-RAM
index set (fmi + lchash + SA + text; alnmain.c:179-256 `init`).

Arrays (all jax, device-resident):

  packed    (ceil(n/16),) int32   2-bit packed BWT (16 bases/word)
  occ_samp  (ceil(n/16)+1, 4)     exclusive per-word base counts (int32
                                  unless a single base exceeds 2^31 occs)
  c4        (4,)                  C-table entries for A,C,G,T (raw-char C[·])
  sa_ctx    (n, 2) int32          fused rows: [SA[p] low 32 bits, packed
                                  16-base left-context window]
  sa_hi     (n,) uint8             high byte of the 40-bit SA value — only
                                  for n >= 2^31 (None otherwise); gathered
                                  alongside sa_ctx so positions never need
                                  int64 gathers (int32 tables keep every
                                  gather at 4-byte words)
  lch       (4^hlen, 2)           precomputed (k, l) SA intervals per k-mer
                                  (low 32 bits when lch_hi is present)
  lch_hi    (4^hlen, 2) uint8      high bytes of (k, l) for n >= 2^31
  text_packed (ceil(n/16),) int32 2-bit text ('$' as 0 — consumers remap
                                  position n-1 to the sentinel)
  mta_start/mta_len (M,)          contig table for seq_lookup (alnmain.c:151)

The full SA and byte text of round 1 were dropped from HBM: the mapping
step never gathers them (the fused sa_ctx and text_packed serve every
lookup), and at genome scale they were 5 of the ~14.5 bytes/position.

Positions are int32 when the .cat fits (n < 2^31) and 40-bit split-hi
otherwise (hg19's .cat is ~6.2e9 bytes — the reason the reference stores
the SA in a 5-byte codec, psascan/sa_use.h:17-28).  The int64 arithmetic
path requires jax x64 mode; load_device_index enables it before first use.

Static metadata lives in IndexMeta (hashable; safe as a jit static arg).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..formats.catmeta import MtaEntry, load_cat, load_mta
from ..ops.rank import occ_samples, pack_codes
from .fmi import FMIndex, encode_bytes


class DeviceIndex(NamedTuple):
    packed: jnp.ndarray
    occ_samp: jnp.ndarray
    c4: jnp.ndarray
    sa_ctx: jnp.ndarray            # (n, 2) int32 [SA low32, ctx window],
    #                                or (n,) int32 SA low32 in slim layout
    sa_hi: Optional[jnp.ndarray]   # (n,) uint8 SA high byte | None (int32 n)
    lch: jnp.ndarray
    lch_hi: Optional[jnp.ndarray]  # (4^hlen, 2) uint8 | None (int32 n)
    text_packed: jnp.ndarray
    text_pair: Optional[jnp.ndarray]  # slim only: (nw+2, 2) int32 adjacent
    #                                   padded text words [pad[i], pad[i+1]]
    mta_start: jnp.ndarray
    mta_len: jnp.ndarray


@dataclass(frozen=True)
class IndexMeta:
    n: int            # .cat length including '$'
    dollar_pos: int   # row of '$' in the BWT
    hlen: int
    n_contigs: int
    pos_dtype: str    # 'int32' | 'int64'
    # slim HBM layout: sa_ctx is (n,) SA-only (4 B/pos instead of 8) and
    # the verify window is recomputed per vote from a text_pair gather —
    # one extra (R,2) gather per vote buys ~3.5 B/pos of HBM, raising the
    # single-chip genome ceiling ~1.6x (the reference's sampled CSA
    # exists for the same RAM trade, fmidx.c:153-163,315-331)
    slim: bool = False


def _pack_ctx_words(sa: np.ndarray, text_codes: np.ndarray) -> np.ndarray:
    """(n,) int32 16-base left-context windows for each SA row.

    ctx word for SA row p: text[SA[p]-16+u] 2-bit packed at bits [2u, 2u+2)
    for u in 0..15 (out-of-range positions pack as 0 — callers gate on
    SA[p] >= prefix length).  The expand-and-verify seeding
    (mapping/pipeline.py) gathers one [SA, ctx] row per candidate vote
    instead of running LF-refinement steps."""
    n = sa.shape[0]
    packed = pack_codes(np.where(text_codes < 4, text_codes, 0)
                        ).view(np.uint32)
    packed = np.concatenate([np.zeros(1, np.uint32), packed,
                             np.zeros(2, np.uint32)])  # +1: word index -1 ok
    out = np.empty(n, dtype=np.int32)
    chunk = 1 << 21
    for s in range(0, n, chunk):
        p = sa[s:s + chunk].astype(np.int64)
        start = p - 16
        w0 = (start >> 4) + 1                 # +1 for the zero pad word
        o = (start & 15).astype(np.uint32)
        lo = packed[np.maximum(w0, 0)] >> (2 * o)
        hi_raw = packed[np.maximum(w0, 0) + 1].astype(np.uint64)
        hi = (hi_raw << (32 - 2 * o)).astype(np.uint64) & 0xFFFFFFFF
        ctx = (lo | hi.astype(np.uint32))
        # positions < 0 must pack as 0: for p < 16 only the TOP 2p bits
        # (text positions 0..p-1) are real — zero the low 2*(16-p) bits
        short = p < 16
        if short.any():
            low = (2 * (16 - p.clip(0, 16))).astype(np.uint64)
            keep = ((np.uint64(0xFFFFFFFF) << low) & np.uint64(0xFFFFFFFF)
                    ).astype(np.uint32)
            ctx = np.where(short, ctx & keep, ctx)
        out[s:s + chunk] = ctx.view(np.int32)
    return out


_ARRAY_NAMES = ("packed", "occ_samp", "c4", "sa_ctx", "sa_hi", "lch",
                "lch_hi", "text_packed", "text_pair", "mta_start", "mta_len")
_CACHE_VERSION = 1


def _text_pair_words(text_packed: np.ndarray) -> np.ndarray:
    """(nw+2, 2) adjacent padded text words for the slim verify-window
    gather: row j = [padded[j], padded[j+1]] with padded = [0] + words +
    [0, 0] — exactly _pack_ctx_words' indexing, so the device recomputes
    the identical ctx word from one int32-pair gather."""
    words = text_packed.view(np.uint32)
    padded = np.concatenate([np.zeros(1, np.uint32), words,
                             np.zeros(2, np.uint32)])
    out = np.empty((padded.shape[0] - 1, 2), dtype=np.uint32)
    out[:, 0] = padded[:-1]
    out[:, 1] = padded[1:]
    return out.view(np.int32)


def _assemble_host_arrays(fmi: FMIndex, lch_kl: np.ndarray, hlen: int,
                          cat: np.ndarray, mta: list[MtaEntry],
                          force_pos_dtype: str | None = None,
                          slim: bool = False,
                          ) -> tuple[dict, IndexMeta]:
    """Derive the device-layout numpy arrays from host index structures
    (the expensive step at genome scale: _pack_ctx_words + occ sampling
    over n positions; slim skips the ctx packing entirely)."""
    n = fmi.length
    pos64 = (n >= 2**31) if force_pos_dtype is None \
        else force_pos_dtype == "int64"
    dtype = np.int64 if pos64 else np.int32
    bwt_codes = encode_bytes(fmi.bwt)
    dollar_pos = int(np.nonzero(bwt_codes == 4)[0][0])
    packed_codes = bwt_codes.copy()
    packed_codes[dollar_pos] = 0
    text_codes = encode_bytes(cat)

    sa = fmi.sa
    if slim:
        sa_ctx = (sa & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    else:
        ctx = _pack_ctx_words(sa, text_codes)
        sa_ctx = np.empty((n, 2), dtype=np.int32)
        sa_ctx[:, 0] = (sa & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        sa_ctx[:, 1] = ctx
    sa_hi = (sa >> 32).astype(np.uint8) if pos64 else None

    kl = np.asarray(lch_kl, dtype=np.uint64)
    if pos64:
        lch = (kl & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        lch_hi = (kl >> np.uint64(32)).astype(np.uint8)
    else:
        lch = kl.astype(np.int32)
        lch_hi = None

    arrays = dict(
        packed=pack_codes(packed_codes),
        occ_samp=occ_samples(bwt_codes, dollar_pos),
        c4=fmi.c4().astype(dtype),
        sa_ctx=sa_ctx,
        sa_hi=sa_hi,
        lch=lch,
        lch_hi=lch_hi,
        text_packed=pack_codes(np.where(text_codes < 4, text_codes, 0)),
        mta_start=np.array([m.offset for m in mta], dtype=dtype),
        mta_len=np.array([m.seq_len for m in mta], dtype=dtype),
    )
    arrays["text_pair"] = (_text_pair_words(arrays["text_packed"])
                           if slim else None)
    meta = IndexMeta(n=n, dollar_pos=dollar_pos, hlen=hlen,
                     n_contigs=len(mta), pos_dtype=np.dtype(dtype).name,
                     slim=slim)
    return arrays, meta


def _pad_rows4(a):
    """Pad a table to a 4-row multiple with zeros (numpy, pre-upload).

    The packed slot layout (MapperConfig.slot_pack in {2, 4}) reshapes
    sa_ctx/sa_hi into pack-units; a non-multiple length would force a
    full-table copy INSIDE the jitted step (~8 GB per step at a 1e9-row
    genome).  Padding here makes that branch statically dead.  Pad rows
    are only reachable through clipped ranks whose slots carry
    valid=False, so they never contribute votes (same invariant the
    mesh-padding path in parallel/dist.py relies on).  meta.n keeps the
    true length; the on-disk devidx cache stays unpadded (version 1)."""
    r = a.shape[0]
    pad = -(-r // 4) * 4 - r
    if pad == 0:
        return a
    return np.concatenate(
        [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)


def _upload(arrays: dict, meta: IndexMeta, mesh=None,
            shard_tables: bool = False) -> DeviceIndex:
    """Host arrays -> device: onto the default device, or with `mesh`
    straight to their placement on it (parallel/dist.shard_index)."""
    if meta.pos_dtype == "int64":
        _require_x64()
    host = DeviceIndex(**{
        k: (None if arrays[k] is None else
            _pad_rows4(arrays[k]) if k in ("sa_ctx", "sa_hi")
            else arrays[k])
        for k in _ARRAY_NAMES})
    if mesh is not None:
        from ..parallel.dist import shard_index
        return shard_index(host, mesh, shard_tables=shard_tables)
    return DeviceIndex(*(None if a is None else jnp.asarray(a)
                         for a in host))


def build_device_index(fmi: FMIndex, lch_kl: np.ndarray, hlen: int,
                       cat: np.ndarray, mta: list[MtaEntry],
                       force_pos_dtype: str | None = None,
                       slim: bool = False,
                       ) -> tuple[DeviceIndex, IndexMeta]:
    """Assemble device arrays from host index structures.

    `force_pos_dtype='int64'` builds the split-hi genome-scale layout even
    for small n (the int64-path parity tests use it).  `slim` selects the
    SA-only sa_ctx layout (IndexMeta.slim)."""
    arrays, meta = _assemble_host_arrays(fmi, lch_kl, hlen, cat, mta,
                                         force_pos_dtype=force_pos_dtype,
                                         slim=slim)
    if meta.pos_dtype == "int64":
        _require_x64()
    return _upload(arrays, meta), meta


def _require_x64() -> None:
    """int64 position arithmetic needs jax x64 mode; enable it globally.

    The flip changes weak-type promotion for every trace AFTER this call;
    programs traced before it stay pos32.  Mixing both in one process is
    almost always a bug (a pos64 index fed to a pos32-traced step truncates
    positions), so if device arrays already exist when the flip happens we
    warn loudly instead of silently changing semantics.  Best practice:
    load the pos64 index first, or run pos64 work in its own process
    (tests/_pos64_worker.py does exactly that)."""
    import jax
    if jax.config.jax_enable_x64:
        return
    if jax.live_arrays():
        import warnings
        warnings.warn(
            "enabling jax_enable_x64 for a pos64 (>2^31) index AFTER other "
            "jax arrays/programs were created: earlier-traced steps keep "
            "pos32 semantics and later traces promote differently. Load "
            "the pos64 index first or use a separate process.",
            RuntimeWarning, stacklevel=3)
    jax.config.update("jax_enable_x64", True)


def _artifact_fingerprint(genome_path: str) -> dict:
    """Cheap content fingerprint of the 5 reference artifacts: size plus a
    blake2b of the first and last 1 MiB of each file.  Editing any artifact
    (even preserving size) perturbs either an end or the size for every
    realistic change; full-content hashing would cost minutes at hg19
    scale, defeating the cache's purpose."""
    import hashlib
    import os as _os

    prefix = genome_path + ".cat"
    fp = {}
    for path in (genome_path + ".mta", prefix, prefix + ".sa5",
                 prefix + ".mfi", prefix + ".lch"):
        st = _os.stat(path)
        h = hashlib.blake2b(digest_size=16)
        with open(path, "rb") as f:
            h.update(f.read(1 << 20))
            if st.st_size > (1 << 20):
                f.seek(max(st.st_size - (1 << 20), 1 << 20))
                h.update(f.read(1 << 20))
        fp[_os.path.basename(path)] = [st.st_size, h.hexdigest()]
    return fp


def _cache_dir(genome_path: str) -> str:
    return genome_path + ".cat.devidx"


def save_device_cache(genome_path: str, arrays: dict,
                      meta: IndexMeta) -> None:
    """Persist the derived device-layout arrays next to the 5 reference
    artifacts so later loads are I/O-bound freads (the reference's `init`
    is exactly that, alnmain.c:192-252) instead of minutes of recompute
    (~64 min measured at a 2.7e9-position index).  Writes are staged into
    a temp dir and renamed in, so a crashed save never leaves a
    half-written cache that fingerprint checks would accept."""
    import json
    import os as _os
    import shutil
    import tempfile

    d = _cache_dir(genome_path)
    tmp = tempfile.mkdtemp(prefix=".devidx_tmp_",
                           dir=_os.path.dirname(_os.path.abspath(d)) or ".")
    try:
        for k in _ARRAY_NAMES:
            if arrays[k] is not None:
                np.save(_os.path.join(tmp, k + ".npy"),
                        np.asarray(arrays[k]))
        info = dict(version=_CACHE_VERSION,
                    meta=dict(n=meta.n, dollar_pos=meta.dollar_pos,
                              hlen=meta.hlen, n_contigs=meta.n_contigs,
                              pos_dtype=meta.pos_dtype, slim=meta.slim),
                    fingerprint=_artifact_fingerprint(genome_path))
        with open(_os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(info, f)
        if _os.path.isdir(d):
            shutil.rmtree(d)
        _os.rename(tmp, d)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _load_device_cache(genome_path: str, force_pos_dtype: str | None,
                       slim: bool = False,
                       ) -> tuple[dict, IndexMeta] | None:
    """Load the cached device-layout arrays, or None when absent/stale.

    A full-layout cache serves a slim request by deriving the slim arrays
    in O(n) (sa column view + text_pair from text_packed); a slim cache
    cannot serve a full request (the ctx words are gone) and misses."""
    import json
    import os as _os
    from dataclasses import replace

    d = _cache_dir(genome_path)
    mpath = _os.path.join(d, "meta.json")
    if not _os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            info = json.load(f)
    except (OSError, ValueError):
        return None
    if info.get("version") != _CACHE_VERSION:
        return None
    meta = IndexMeta(**info["meta"])
    if force_pos_dtype is not None and meta.pos_dtype != force_pos_dtype:
        return None
    if meta.slim and not slim:
        return None
    if info["fingerprint"] != _artifact_fingerprint(genome_path):
        return None
    arrays = {}
    for k in _ARRAY_NAMES:
        p = _os.path.join(d, k + ".npy")
        # mmap: jnp.asarray streams straight from the page cache/disk
        arrays[k] = np.load(p, mmap_mode="r") if _os.path.exists(p) else None
    if arrays["sa_ctx"] is None:
        return None
    if slim and not meta.slim:
        arrays["sa_ctx"] = np.ascontiguousarray(arrays["sa_ctx"][:, 0])
        arrays["text_pair"] = _text_pair_words(
            np.asarray(arrays["text_packed"]))
        meta = replace(meta, slim=True)
    return arrays, meta


def load_device_index(genome_path: str, force_pos_dtype: str | None = None,
                      cache: bool = True, slim: bool = False,
                      verbose: bool = True, mesh=None,
                      shard_tables: bool = False,
                      ) -> tuple[DeviceIndex, IndexMeta, list[MtaEntry]]:
    """Load the persisted artifact set (.mta/.cat/.sa5/.mfi/.lch) to device —
    the accaln `init` equivalent (alnmain.c:179-256).  With `mesh` the
    tables are placed on it directly (replicated, or row-sharded over
    'model' when `shard_tables`) instead of onto the default device.

    With `cache` (default), the derived device-layout arrays are read from
    `<genome>.cat.devidx/` when its fingerprint matches the artifacts, and
    written there after a from-artifacts build otherwise — turning genome-
    scale index load from O(n) recompute into O(n) sequential fread."""
    from ..utils.log import new_logger

    log = new_logger(verbose=verbose)
    mta = load_mta(genome_path + ".mta")
    if cache:
        hit = _load_device_cache(genome_path, force_pos_dtype, slim=slim)
        if hit is not None:
            arrays, meta = hit
            log.vlog(f"device index cache hit: {_cache_dir(genome_path)}")
            return _upload(arrays, meta, mesh, shard_tables), meta, mta

    from ..formats.lch import read_lch

    prefix = genome_path + ".cat"
    fmi = FMIndex.read(prefix, with_sa=True)
    hlen, kl = read_lch(prefix + ".lch")
    cat = load_cat(prefix)
    arrays, meta = _assemble_host_arrays(fmi, kl, hlen, cat, mta,
                                         force_pos_dtype=force_pos_dtype,
                                         slim=slim)
    if cache and force_pos_dtype is None:
        # forced layouts are a parity-test affordance; caching one would
        # shadow the natural layout for every later load
        try:
            save_device_cache(genome_path, arrays, meta)
            log.vlog(f"device index cache written: {_cache_dir(genome_path)}")
        except OSError as e:
            log.vlog(f"device index cache write failed (continuing): {e}")
    return _upload(arrays, meta, mesh, shard_tables), meta, mta
