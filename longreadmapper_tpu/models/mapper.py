"""TPUMapper — the flagship end-to-end mapping model.

Bundles the HBM-resident DeviceIndex with jitted mapping steps (one per
read-length bucket) and the host post-processing (CIGAR traceback + SAM
field assembly).  This is the framework's equivalent of the reference's
whole `accaln` per-batch path (/root/reference/alnmain.c:302-527).

Defined-behavior choices where the reference is UB (shared with oracle/):
  - unmapped reads (flag 0x4) always emit CIGAR '*' and ED:I:-1; lookup
    failures emit RNAME '*' (the reference prints uninitialized memory
    there, alnmain.c:458-475)
  - device band half-width is max(8, limit(L)) for the padded length L;
    since every read's limit <= band, scores and tracebacks for accepted
    (<= limit) alignments are exact and band-width independent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..formats.catmeta import MtaEntry
from ..formats.fastx import encode_seq
from ..formats.sam import cigar_string, sam_record
from ..index.device import DeviceIndex, IndexMeta
from ..mapping.pipeline import MapperConfig, make_map_step
from ..oracle.refpipe import revcomp
from ..utils.config import Params


@dataclass
class MapRecord:
    qname: str
    flag: int
    rname: str
    off: int          # 0-based; SAM POS = off + 1
    mapq: int
    cigar: str
    seq: str
    qual: str
    ed: int
    valid: bool

    def to_sam(self) -> str:
        return sam_record(self.qname, self.flag, self.rname, self.off,
                          self.mapq, self.cigar, self.seq, self.qual, self.ed)


_OP_CHARS = np.frombuffer(b"MID?", dtype=np.uint8)


def _rle_groups(runs: np.ndarray, entry_bytes: int = 1):
    """Decode device_traceback_v output for a WHOLE chunk in one numpy
    pass: (count << 2 | op) bytes in reverse path order -> merged
    forward-order groups (g_row, g_op, tot).  Per-read numpy calls cost
    more than the device step at these throughputs.

    entry_bytes 2/4: the runs are a column walk's int16/int32 entries
    shipped as little-endian byte groups (MapperConfig.tb_entry_bytes) —
    same format, wider counts."""
    if entry_bytes > 1:
        w = runs.shape[1] - runs.shape[1] % entry_bytes
        runs = np.ascontiguousarray(runs[:, :w]).view(
            np.int16 if entry_bytes == 2 else np.int32)
    rev = runs[:, ::-1]
    op = rev & 3
    cnt = (rev >> 2).astype(np.int64)
    valid = (op != 3) & (cnt > 0)
    rows, cols = np.nonzero(valid)
    if rows.size == 0:
        return rows, rows, rows
    ops_f = op[rows, cols]
    cnt_f = cnt[rows, cols]
    # group boundaries: row change or op change
    brk = np.empty(rows.size, dtype=bool)
    brk[0] = True
    brk[1:] = (rows[1:] != rows[:-1]) | (ops_f[1:] != ops_f[:-1])
    starts = np.flatnonzero(brk)
    return rows[starts], ops_f[starts], np.add.reduceat(cnt_f, starts)


def _rle_runs_batch(runs: np.ndarray,
                    entry_bytes: int = 1) -> List[List[Tuple[int, str]]]:
    B = runs.shape[0]
    out: List[List[Tuple[int, str]]] = [[] for _ in range(B)]
    for r, o, t in zip(*_rle_groups(runs, entry_bytes)):
        out[r].append((int(t), chr(_OP_CHARS[o])))
    return out


def _tail_needed(ops: np.ndarray, entry_bytes: int) -> bool:
    """True when some read's runs reach the last eager head slot (the
    lazily-fetched tail may hold more).  The sentinel is the LAST ENTRY's
    op bits — for multi-byte entries that is the low byte of the final
    group (little-endian)."""
    col = -entry_bytes
    if ops.shape[1] < entry_bytes:
        return True
    return bool((np.asarray(ops[:, col]) & 3 != 3).any())


def _cigar_strings_batch(runs: np.ndarray,
                         entry_bytes: int = 1) -> List[str]:
    """Per-read CIGAR strings straight from the packed run bytes."""
    B = runs.shape[0]
    g_row, g_op, tot = _rle_groups(runs, entry_bytes)
    parts: List[List[str]] = [[] for _ in range(B)]
    opc = "MID?"
    for r, o, t in zip(g_row.tolist(), g_op.tolist(), tot.tolist()):
        parts[r].append(f"{t}{opc[o]}")
    return ["".join(p) for p in parts]


def _bucket_len(n: int, minimum: int = 128) -> int:
    """Round read length up to a bucket (powers of two to 1K, then 1K steps)
    to bound jit recompiles across batches."""
    b = minimum
    while b < n and b < 1024:
        b *= 2
    if b < n:
        b = -(-n // 1024) * 1024
    return b


class TPUMapper:
    def __init__(self, idx: DeviceIndex, meta: IndexMeta,
                 mta: Sequence[MtaEntry], params: Params,
                 chunk_b: int = 0, mesh=None, shard_tables: bool = False):
        """Single-device mapper, or — when `mesh` is given — ONE logical
        mapper over the whole ('data', 'model') device mesh: chunks are
        GLOBAL batches sharded over 'data', the index is replicated per
        device or (shard_tables) row-sharded over 'model', and the
        sensitivity counter is a cross-device collective
        (parallel/dist.make_sharded_map_step).  In multi-process meshes
        each process packs/assembles only its own row slice."""
        self.mesh = mesh
        self.shard_tables = shard_tables
        self.meta = meta
        self.mta = list(mta)
        self.params = params
        self.B = chunk_b or params.chunk_size
        if mesh is not None:
            from ..parallel.dist import shard_index
            n_data = mesh.shape["data"]
            self.B = -(-self.B // n_data) * n_data
            self.idx = shard_index(idx, mesh, shard_tables=shard_tables)
        else:
            self.idx = idx
        self._steps = {}
        self._retry_steps = {}
        self._raw_steps = {}
        self._sat_steps = {}
        # reads whose per-phase votes exceeded the compaction budget (tail
        # votes dropped — raise Params.vote_budget for exact handling)
        self.overflow_reads = 0
        # reads re-run through the exact-slots tier (_retry_overflow)
        self.retried_reads = 0
        # gact chunks re-walked through the 4x run buffer (_retry_saturation)
        self.retried_sat_chunks = 0
        # global mapped-read count accumulated from the device-side
        # collective counter (mesh mode only; single mode counts on host)
        self.valid_global = 0
        # wall-clock per host pipeline phase (seconds, cumulative) — the
        # e2e-vs-device-gap ledger: prepare = read packing, dispatch =
        # H2D + step enqueue, fetch = blocking on device outputs (device
        # time NOT overlapped by host work shows up here), assemble =
        # SAM/record building
        self.phase_s = {"prepare": 0.0, "dispatch": 0.0, "fetch": 0.0,
                        "assemble": 0.0}

    def _b_for(self, L: int) -> int:
        """Device batch for a length bucket: scale B down for long reads so
        the DP working set (bands grow with L) stays within HBM."""
        if L <= 1024:
            return self.B
        b = max(8, (self.B * 1024 // L) // 8 * 8)
        if self.mesh is not None:
            n_data = self.mesh.shape["data"]
            b = max(n_data, -(-b // n_data) * n_data)
        return b

    def _local_rows(self, B: int) -> tuple[int, int]:
        """This process's contiguous row range [lo, hi) of a global
        (B, ...) batch sharded over the mesh 'data' axis."""
        if self.mesh is None:
            return 0, B
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(self.mesh, P("data"))
        idx_map = sh.addressable_devices_indices_map((B,))
        slices = {((s[0].start or 0),
                   B if s[0].stop is None else s[0].stop)
                  for s in idx_map.values()}
        lo = min(s for s, _ in slices)
        hi = max(e for _, e in slices)
        # the deduped local slices must exactly tile [lo, hi): an
        # interleaved ownership layout (e.g. rows [0,256)+[512,768)) would
        # silently pack the wrong global rows into the local buffer
        assert sum(e - s for s, e in slices) == hi - lo, \
            f"non-contiguous local rows: {sorted(slices)}"
        return lo, hi

    def _step_for(self, L: int):
        if L not in self._steps:
            import os
            from dataclasses import replace
            cfg = MapperConfig.from_params(self.params, self.meta,
                                           self._b_for(L), L)
            if self.mesh is not None:
                from ..parallel.dist import make_sharded_map_step

                # the overflow-retry tier is a host-local affair; mesh
                # runs stay single-tier on the full budget and band
                cfg = replace(cfg, exact_slots=True, short_W_override=0)
                step = make_sharded_map_step(cfg, self.mesh,
                                             shard_tables=self.shard_tables)
            else:
                if L > cfg.gact_threshold and \
                        os.environ.get("LRM_HALF_BAND", "1") != "0":
                    # long-read primary pass at half band: DP cells halve;
                    # rare ed >= W/2 lanes re-run through the full-band
                    # retry tier (overflow bit 2).  Set for BOTH long
                    # paths: half_band covers gact, short_W_override the
                    # resident-dirs mid-length path (MapperConfig.use_gact
                    # picks by dirs-volume fit)
                    cfg = replace(cfg, half_band=True,
                                  short_W_override=max(64, cfg.W // 2))
                step = make_map_step(cfg)
            self._steps[L] = (cfg, step)
        return self._steps[L]

    @property
    def _raw_ok(self) -> bool:
        """Device-side encode applies in single-device mode (the mesh path
        packs per-process row slices host-side); LRM_HOST_ENCODE=1 forces
        the host path for A/B measurement."""
        import os
        return self.mesh is None and \
            os.environ.get("LRM_HOST_ENCODE", "") != "1"

    def _raw_step_for(self, L: int):
        """raw-input (device-encode) step variant for uniform chunks."""
        if L not in self._raw_steps:
            from dataclasses import replace
            cfg, _ = self._step_for(L)
            cfg_r = replace(cfg, raw_input=True)
            self._raw_steps[L] = (cfg_r, make_map_step(cfg_r))
        return self._raw_steps[L]

    def _retry_step_for(self, L: int):
        """Exact-slots (full vote budget) step for overflow-flagged reads,
        at a small batch size — compiled lazily, used only when the compact
        tier's budget was exceeded (mapping/pipeline.MapperConfig.vote_slots)."""
        if L not in self._retry_steps:
            from dataclasses import replace
            cfg, _ = self._step_for(L)
            # full band as well as full vote budget: the retry tier is
            # the exact-everything tier (half-band bit-2 lanes land here)
            cfg_r = replace(cfg, B=min(cfg.B, 256), exact_slots=True,
                            half_band=False, short_W_override=0)
            self._retry_steps[L] = (cfg_r, make_map_step(cfg_r))
        return self._retry_steps[L]

    def _sat_step_for(self, L: int):
        """4x-run-buffer gact step for saturation-flagged chunks (overflow
        bit 1): the shared CIGAR run buffer sized by ops/gact.gact_runs_cols*
        can in principle be overrun by adversarial clustered-indel batches;
        this tier re-walks such a chunk with 4x the edit-row budget instead
        of leaving corrupt CIGARs.  Compiled lazily — realistic batches
        never saturate, so the extra compile is paid only on first flag."""
        if L not in self._sat_steps:
            from dataclasses import replace
            cfg, _ = self._step_for(L)
            assert cfg.use_gact
            cfg_s = replace(cfg, gact_runs_scale=4)
            self._sat_steps[L] = (cfg_s, make_map_step(cfg_s))
        return self._sat_steps[L]

    def warmup(self, lengths: Sequence[int] = (256, 1024),
               concurrent: bool = True) -> float:
        """Precompile the map step for the given read-length buckets.

        Cold-start mitigation: a full map-step compile costs minutes per
        (B, L) bucket.  XLA/PJRT compilation releases the GIL (and
        remote-compile services parallelize server-side), so multiple
        buckets compile CONCURRENTLY; results land in jax's persistent
        compilation cache (set JAX_COMPILATION_CACHE_DIR), making every
        later run's first chunk a cache load instead of a compile.
        Returns elapsed seconds."""
        import time
        from concurrent.futures import ThreadPoolExecutor

        import jax

        t0 = time.time()
        buckets = sorted({_bucket_len(int(l)) for l in lengths})
        sds = jax.ShapeDtypeStruct

        def _enc_args(cfg):
            return (self.idx,
                    sds((cfg.B, cfg.L), jnp.int8), sds((cfg.B, cfg.L), jnp.int8),
                    sds((cfg.B,), jnp.int32), sds((cfg.B,), jnp.int32))

        def variants(L):
            # every step variant _prepare_chunk/_retry_overflow can dispatch
            # mid-stream: host-encode (ragged chunks / mesh), raw
            # device-encode (uniform chunks), and the exact-slots overflow
            # retry tier — a "successful" warmup must leave NO 1-4 min
            # compile for any of them
            cfg, step = self._step_for(L)
            yield step, _enc_args(cfg)
            if self._raw_ok:
                cfg_r, step_r = self._raw_step_for(L)
                yield step_r, (self.idx, sds((cfg_r.B, L), jnp.uint8),
                               sds((cfg_r.B,), jnp.int32),
                               sds((cfg_r.B,), jnp.int32))
            if self.mesh is None and not cfg.exact_slots \
                    and (cfg.vote_slots < cfg.vote_slots_exact
                         or cfg.half_band):
                cfg_t, step_t = self._retry_step_for(L)
                yield step_t, _enc_args(cfg_t)

        tasks = [v for L in buckets for v in variants(L)]

        def compile_one(task):
            step, args = task
            step.lower(*args).compile()

        if concurrent and len(tasks) > 1:
            with ThreadPoolExecutor(max_workers=len(tasks)) as ex:
                list(ex.map(compile_one, tasks))
        else:
            for t in tasks:
                compile_one(t)
        return time.time() - t0

    def _prepare_chunk(self, reads):
        """Host-side read packing (pure numpy; safe on a worker thread).

        In mesh mode `reads` is the GLOBAL chunk (so every process agrees
        on the length bucket — an SPMD requirement); each process packs
        only its own contiguous row slice of each cfg.B-read part."""
        n_real = len(reads)
        assert n_real <= self.B
        max_len = max((len(s) for _, s, _ in reads), default=1)
        L = _bucket_len(max_len)
        cfg, _ = self._step_for(L)
        row_lo, row_hi = self._local_rows(cfg.B)
        n_pack = row_hi - row_lo
        prepped = []
        for s in range(0, max(n_real, 1), cfg.B):
            part = reads[s + row_lo:s + row_hi]
            if (self._raw_ok and part
                    and all(len(p[1]) == len(part[0][1]) for p in part)):
                # uniform chunk: ship raw ASCII, encode + RC on device
                # (cfg.raw_input step variant) — half the H2D bytes and
                # none of the host LUT passes
                prepped.append((part,) + self._pack_raw(part, L, n_pack))
            else:
                prepped.append((part,) + self._pack_reads(part, L, n_pack))
        return L, prepped

    def _pack_raw(self, part, L: int, n_pack: int):
        """Uniform-length raw-byte packing for the device-encode step:
        (raw, None, lens, limits) — the None marks the raw variant for
        _dispatch_chunk."""
        L0 = len(part[0][1])
        raw = np.zeros((n_pack, L), dtype=np.uint8)
        raw[:len(part), :L0] = np.frombuffer(
            "".join(p[1] for p in part).encode(),
            np.uint8).reshape(len(part), L0)
        lens = np.zeros(n_pack, dtype=np.int32)
        lens[:len(part)] = L0
        return raw, None, lens, self._limits(lens)

    def _limits(self, lens: np.ndarray) -> np.ndarray:
        # (int)(ERROR_RATE*len*2) in C double semantics (alnmain.c:428)
        return ((self.params.error_rate * lens.astype(np.float64)) * 2
                ).astype(np.int32)

    def _pack_reads(self, part, L: int, n_pack: int):
        """Encode up to n_pack (name, seq, qual) reads into device buffers:
        (codes, codes_rc, lens, limits).

        Two LUT passes over the raw bytes and slice writes — no full-batch
        masks or where() temporaries (they were ~2/3 of a 25 ms pack at
        B=2048, L=1024; host pack overlaps the device step but bounds e2e
        once the step itself is faster than the host loop)."""
        from ..formats.fastx import _encode_lut
        lut = _encode_lut().view(np.int8)
        clut = lut.copy()
        clut[lut < 4] = 3 - lut[lut < 4]   # complement; N stays 4
        lens = np.zeros(n_pack, dtype=np.int32)
        n_part = len(part)
        codes = np.full((n_pack, L), 4, dtype=np.int8)
        codes_rc = np.full((n_pack, L), 4, dtype=np.int8)
        uniform = n_part > 0 and all(
            len(s) == len(part[0][1]) for _, s, _ in part)
        if uniform:
            # uniform-length fast path: one join + one frombuffer
            L0 = len(part[0][1])
            raw = np.frombuffer(
                "".join(s for _, s, _ in part).encode(),
                np.uint8).reshape(n_part, L0)
            lens[:n_part] = L0
            codes[:n_part, :L0] = lut[raw]
            codes_rc[:n_part, :L0] = clut[raw][:, ::-1]
        else:
            for i, (_, seq, _) in enumerate(part):
                raw = np.frombuffer(seq.encode(), np.uint8)
                lens[i] = raw.shape[0]
                codes[i, :raw.shape[0]] = lut[raw]
                codes_rc[i, :raw.shape[0]] = clut[raw[::-1]]
        return codes, codes_rc, lens, self._limits(lens)

    def _dispatch_chunk(self, prepared):
        """Upload + queue the device steps (async; main thread)."""
        import jax
        L, prepped = prepared
        cfg, step = self._step_for(L)
        parts = []
        for part, codes, codes_rc, lens, limits in prepped:
            if self.mesh is None:
                if codes_rc is None:       # raw uniform-chunk variant
                    _, rstep = self._raw_step_for(L)
                    draw, dl, dlim = jax.device_put((codes, lens, limits))
                    out = rstep(self.idx, draw, dl, dlim)
                    parts.append((cfg, part, lens, out))
                    continue
                dc, drc, dl, dlim = jax.device_put((codes, codes_rc, lens,
                                                    limits))
                out = step(self.idx, dc, drc, dl, dlim)
            else:
                from jax.sharding import NamedSharding, PartitionSpec as P
                sh = NamedSharding(self.mesh, P("data"))
                dc, drc, dl, dlim = (
                    jax.make_array_from_process_local_data(sh, a)
                    for a in (codes, codes_rc, lens, limits))
                out, valid = step(self.idx, dc, drc, dl, dlim)
                out = dict(out, _valid=valid)
            parts.append((cfg, part, lens, out))
        return parts

    @staticmethod
    def _local_numpy(arr) -> np.ndarray:
        """This process's rows of a global 'data'-sharded array, in row
        order (deduped across model-axis replicas)."""
        if isinstance(arr, np.ndarray):
            return arr
        by_start = {}
        for s in arr.addressable_shards:
            st = s.index[0].start or 0
            if st not in by_start:
                by_start[st] = np.asarray(s.data)
        return np.concatenate([by_start[k] for k in sorted(by_start)],
                              axis=0)

    def submit_chunk(self, reads: Sequence[Tuple[str, str, Optional[str]]]):
        """Dispatch the device step for up to B reads WITHOUT blocking.
        Pair with collect_chunk.  In mesh mode `reads` is the global
        chunk; the returned records cover only this process's row slice."""
        import time
        t0 = time.perf_counter()
        prepared = self._prepare_chunk(reads)
        t1 = time.perf_counter()
        out = self._dispatch_chunk(prepared)
        self.phase_s["prepare"] += t1 - t0
        self.phase_s["dispatch"] += time.perf_counter() - t1
        return out

    def _fetch_chunk(self, pending):
        """Block on the device outputs; returns numpy-materialized parts.

        ONE batched device->host fetch per part: each per-array
        np.asarray sync pays its own host round trip.  The
        compacted CIGAR tail is fetched only when some read's runs
        overflow the eager head columns (rare: high-edit reads)."""
        import jax
        fetched = []
        for cfg, reads, lens, out in pending:
            if self.mesh is not None:
                self.valid_global += int(out.pop("_valid"))
                out = {k: self._local_numpy(v) for k, v in out.items()}
            tail = out.pop("ops_tail", None)
            out = jax.device_get(out)
            if "blob" in out:
                # short-read path fuses meta (8 or 10 int32 words/read) +
                # CIGAR head into one array = one link round trip
                mb = 4 * cfg.meta_words
                blob = out.pop("blob")
                out["meta"] = np.ascontiguousarray(
                    blob[:, :mb]).view(np.int32)
                out["ops"] = blob[:, mb:]
            if tail is not None and _tail_needed(out["ops"],
                                                 cfg.tb_entry_bytes):
                out["ops"] = np.concatenate(
                    [out["ops"], jax.device_get(tail)], axis=1)
            out = self._retry_saturation(cfg, reads, out)
            out = self._retry_overflow(cfg, reads, out)
            fetched.append((cfg, reads, lens, out))
        return fetched

    def _retry_saturation(self, cfg: MapperConfig, reads, out):
        """Re-walk a gact chunk whose shared run buffer saturated
        (overflow bit 1, ops/gact.gact_traceback_*) through the 4x-buffer
        tier (_sat_step_for).  Saturation is a chunk-level flag — the
        clamped last buffer row may hold any lane's runs — so the whole
        chunk re-runs and replaces its meta/ops wholesale.  If even the
        4x budget saturates (adversarial beyond docs/TUNING.md's stated
        bound) the flag survives in the retried meta and surfaces via
        overflow_reads; no silent-corrupt-CIGAR path remains."""
        if self.mesh is not None or not cfg.use_gact:
            return out
        import jax
        meta = np.asarray(out["meta"])
        n = len(reads)
        if not (meta[:n, cfg.meta_words - 1] & 2).any():
            return out
        cfg_s, step_s = self._sat_step_for(cfg.L)
        codes, codes_rc, lens_r, limits = self._pack_reads(
            reads, cfg.L, cfg_s.B)
        dc, drc, dl, dlim = jax.device_put((codes, codes_rc, lens_r,
                                            limits))
        o = step_s(self.idx, dc, drc, dl, dlim)
        tail_s = o.pop("ops_tail")
        blob = np.asarray(o["blob"])
        mb = 4 * cfg_s.meta_words
        meta_s = np.ascontiguousarray(blob[:, :mb]).view(np.int32)
        ops_s = blob[:, mb:]
        if ops_s.shape[1] and _tail_needed(ops_s, cfg_s.tb_entry_bytes):
            ops_s = np.concatenate([ops_s, np.asarray(tail_s)], axis=1)
        self.retried_sat_chunks += 1
        return dict(out, meta=meta_s, ops=ops_s)

    def _retry_overflow(self, cfg: MapperConfig, reads, out):
        """Re-map overflow-flagged reads through the exact-slots tier.

        The compact tier's results are bit-identical to the full vote
        budget for every read whose executed phases fit its slots (same
        votes, same order); flagged reads re-run on the full budget and
        their rows (meta incl. the REAL overflow flag, CIGAR run bytes)
        are spliced in.  Random-ish genomes essentially never flag; heavy
        repeats cost one extra small dispatch per affected chunk."""
        if self.mesh is not None or cfg.exact_slots:
            return out
        import jax

        meta = np.asarray(out["meta"])
        n = len(reads)
        # bit 0 = vote overflow (more slots fixes it); bit 2 = half-band
        # ed >= W/2 (full band fixes it) — both re-run through the
        # exact-everything tier.  bit 1 = gact run-buffer saturation
        # (handled chunk-wise by _retry_saturation; a vote-slot retry
        # CANNOT fix it — the flag survives via overflow_reads instead)
        flagged = np.flatnonzero(meta[:n, cfg.meta_words - 1] & 5)
        if flagged.size == 0:
            return out
        cfg_r, step_r = self._retry_step_for(cfg.L)
        meta = meta.copy()
        ops = np.asarray(out["ops"]).copy()
        for s in range(0, flagged.size, cfg_r.B):
            sel = flagged[s:s + cfg_r.B]
            part = [reads[i] for i in sel]
            codes, codes_rc, lens_r, limits = self._pack_reads(
                part, cfg.L, cfg_r.B)
            dc, drc, dl, dlim = jax.device_put((codes, codes_rc, lens_r,
                                                limits))
            o = step_r(self.idx, dc, drc, dl, dlim)
            tail_r = o.pop("ops_tail")
            blob = np.asarray(o["blob"])
            mb = 4 * cfg_r.meta_words
            meta_r = np.ascontiguousarray(blob[:, :mb]).view(np.int32)
            ops_r = blob[:, mb:]
            if ops_r.shape[1] and _tail_needed(ops_r, cfg_r.tb_entry_bytes):
                ops_r = np.concatenate([ops_r, np.asarray(tail_r)], axis=1)
            if ops_r.shape[1] > ops.shape[1]:
                pad = np.full((ops.shape[0], ops_r.shape[1] - ops.shape[1]),
                              3, np.int8)
                ops = np.concatenate([ops, pad], axis=1)
            meta[sel] = meta_r[:sel.size]
            ops[sel] = 3          # blank any leftover compact-tier bytes
            ops[sel, :ops_r.shape[1]] = ops_r[:sel.size]
        self.retried_reads += int(flagged.size)
        return dict(out, meta=meta, ops=ops)

    def _assemble_chunk(self, fetched) -> List[MapRecord]:
        recs: List[MapRecord] = []
        for cfg, reads, lens, out in fetched:
            self.overflow_reads += int(
                (out["meta"][:len(reads), cfg.meta_words - 1] != 0).sum())
            recs.extend(self._postprocess(cfg, reads, lens, out))
        return recs

    def collect_chunk(self, pending) -> List[MapRecord]:
        """Block on a submit_chunk handle and assemble MapRecords."""
        import time
        t0 = time.perf_counter()
        fetched = self._fetch_chunk(pending)
        t1 = time.perf_counter()
        recs = self._assemble_chunk(fetched)
        self.phase_s["fetch"] += t1 - t0
        self.phase_s["assemble"] += time.perf_counter() - t1
        return recs

    def map_chunk(self, reads: Sequence[Tuple[str, str, Optional[str]]]
                  ) -> List[MapRecord]:
        """Map up to B reads: (name, seq, qual) tuples -> MapRecords."""
        return self.collect_chunk(self.submit_chunk(reads))

    def map_stream(self, chunk_iter):
        """Map an iterator of read chunks with device/host overlap (the
        device version of the reference's pipelined batch loop,
        alnmain.c:302-527 / SURVEY.md P4):

        A depth-3 submit/collect pipeline gives each chunk's async D2H copy
        a full device step to land, so a collect finds its copy done
        instead of waiting on a synchronous fetch.  Single-threaded: jax
        dispatch holds the GIL."""
        from collections import deque

        queue = deque()
        for chunk in chunk_iter:
            nxt = self.submit_chunk(chunk)
            self._start_fetch(nxt)
            queue.append(nxt)
            if len(queue) > 2:
                yield self.collect_chunk(queue.popleft())
        while queue:
            yield self.collect_chunk(queue.popleft())

    @staticmethod
    def _start_fetch(parts):
        # queue the D2H copies right behind the compute they depend on,
        # so they overlap the NEXT chunk's device step
        for _, _, _, out in parts:
            for k, a in out.items():
                if k == "ops_tail":
                    continue              # fetched lazily, usually never
                try:
                    a.copy_to_host_async()
                except AttributeError:
                    pass

    def collect_chunk_sam(self, pending) -> Tuple[str, int, int]:
        """Block on a submit_chunk handle and return (sam_text, n_records,
        n_valid) — the write-path twin of collect_chunk that skips
        MapRecord objects entirely (PART 3+4, alnmain.c:458-527; the
        per-read record loop was the biggest host post-processing cost)."""
        import time
        t0 = time.perf_counter()
        fetched = self._fetch_chunk(pending)
        t1 = time.perf_counter()
        text, total, valid = [], 0, 0
        for cfg, reads, lens, out in fetched:
            self.overflow_reads += int(
                (out["meta"][:len(reads), cfg.meta_words - 1] != 0).sum())
            t, v = self._postprocess_sam(cfg, reads, lens, out)
            text.append(t)
            total += len(reads)
            valid += v
        self.phase_s["fetch"] += t1 - t0
        self.phase_s["assemble"] += time.perf_counter() - t1
        return "".join(text), total, valid

    def map_stream_sam(self, chunk_iter):
        """map_stream's SAM-text twin: yields (sam_text, n_records,
        n_valid) per chunk with the same depth-3 overlap pipeline."""
        from collections import deque
        queue = deque()
        for chunk in chunk_iter:
            nxt = self.submit_chunk(chunk)
            self._start_fetch(nxt)
            queue.append(nxt)
            if len(queue) > 2:
                yield self.collect_chunk_sam(queue.popleft())
        while queue:
            yield self.collect_chunk_sam(queue.popleft())

    # must match oracle/refpipe.revcomp exactly (lowercase -> UPPER comp)
    _COMP = bytes.maketrans(b"ACGTacgt", b"TGCATGCA")

    def _names_cache(self) -> List[str]:
        if not hasattr(self, "_names"):
            self._names = [m.seq_name for m in self.mta]
        return self._names

    def _meta_cols(self, cfg: MapperConfig, meta: np.ndarray):
        """(found, gi, strand, off, ed) columns for either meta layout."""
        if cfg.pos64:
            # row: [best_lo, best_hi, found, gi, strand, off_lo, off_hi,
            #       ed, limit, overflow] — positions as LE int32 pairs
            off = (meta[:, 6].astype(np.int64) << 32) \
                | meta[:, 5].astype(np.uint32).astype(np.int64)
            return (meta[:, 2] != 0, meta[:, 3], meta[:, 4] != 0, off,
                    meta[:, 7])
        return (meta[:, 1] != 0, meta[:, 2], meta[:, 3] != 0, meta[:, 4],
                meta[:, 5])

    def _postprocess_sam(self, cfg: MapperConfig, reads, lens, out
                         ) -> Tuple[str, int]:
        """Chunk-vectorized SAM assembly: columns hoisted to Python lists
        once, one f-string per record, no MapRecord/dataclass overhead."""
        meta = np.asarray(out["meta"])
        found, gi, strand, off, ed = self._meta_cols(cfg, meta)
        n = len(reads)
        cigs = _cigar_strings_batch(np.asarray(out["ops"][:n]),
                                    cfg.tb_entry_bytes)
        valid_l = (found & (ed >= 0))[:n].tolist()
        strand_l = strand[:n].tolist()
        found_l = found[:n].tolist()
        pos_l = (off + 1)[:n].tolist()
        ed_l = ed[:n].tolist()
        gi_l = gi[:n].tolist()
        names = self._names_cache()
        comp = self._COMP
        lines = []
        ap = lines.append
        n_valid = 0
        for i, (name, seq, qual) in enumerate(reads):
            q = qual if qual else "*"
            if valid_l[i]:
                n_valid += 1
                if strand_l[i]:
                    seq = seq.encode().translate(comp)[::-1].decode()
                    ap(f"{name}\t16\t{names[gi_l[i]]}\t{pos_l[i]}\t255\t"
                       f"{cigs[i] or '*'}\t*\t0\t0\t{seq}\t{q}\t"
                       f"ED:I:{ed_l[i]}\n")
                else:
                    ap(f"{name}\t0\t{names[gi_l[i]]}\t{pos_l[i]}\t255\t"
                       f"{cigs[i] or '*'}\t*\t0\t0\t{seq}\t{q}\t"
                       f"ED:I:{ed_l[i]}\n")
            elif found_l[i]:
                if strand_l[i]:
                    seq = seq.encode().translate(comp)[::-1].decode()
                ap(f"{name}\t4\t{names[gi_l[i]]}\t{pos_l[i]}\t0\t*\t*\t0\t0"
                   f"\t{seq}\t{q}\tED:I:-1\n")
            else:
                ap(f"{name}\t4\t*\t1\t0\t*\t*\t0\t0\t{seq}\t{q}\tED:I:-1\n")
        return "".join(lines), n_valid

    def _postprocess(self, cfg: MapperConfig, reads, lens, out) -> List[MapRecord]:
        meta = np.asarray(out["meta"])
        if cfg.pos64:
            # row: [best_lo, best_hi, found, gi, strand, off_lo, off_hi,
            #       ed, limit, overflow] — positions as LE int32 pairs
            found = meta[:, 2] != 0
            gi = meta[:, 3]
            strand = meta[:, 4] != 0
            off = (meta[:, 6].astype(np.int64) << 32) \
                | meta[:, 5].astype(np.uint32).astype(np.int64)
            ed = meta[:, 7]
        else:
            found = meta[:, 1] != 0
            gi = meta[:, 2]
            strand = meta[:, 3] != 0
            off = meta[:, 4]
            ed = meta[:, 5]
        all_runs = _rle_runs_batch(np.asarray(out["ops"]),
                           cfg.tb_entry_bytes)

        recs: List[MapRecord] = []
        for i, (name, seq, qual) in enumerate(reads):
            ok = bool(found[i])
            ed_i = int(ed[i]) if ok else -1
            valid = ok and ed_i >= 0
            if valid:
                ops = all_runs[i]
                cig = cigar_string(ops) if ops else "*"
                flag = 16 if strand[i] else 0
                mapq = 255
            else:
                cig = "*"
                flag = 0x4
                mapq = 0
            rname = self.mta[int(gi[i])].seq_name if ok else "*"
            seq_out = revcomp(seq) if (ok and strand[i]) else seq
            recs.append(MapRecord(
                qname=name, flag=flag, rname=rname,
                off=int(off[i]) if ok else 0, mapq=mapq, cigar=cig,
                seq=seq_out, qual=qual if qual else "*", ed=ed_i,
                valid=valid))
        return recs
