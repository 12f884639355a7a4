"""The batched device mapping step: seed -> vote -> locate -> align.

Replicates the per-read control flow of the reference's PART 1-3
(/root/reference/alnmain.c:330-477) as masked, batched JAX:

  for iter in 0..seed_len+gap (phase-shifted seed tilings, :349):
      seeds at j = iter, iter+sl+gl, ... while j < len - sl        (:353)
      lc_aln each seed; informative iff 0 < hits < thres           (:356-360)
      every SA hit votes diagonal SA[k]-j into an in-phase histo   (:362-367)
      score = top2_votes / (len // (sl+gl))                        (:371-375)
      score > 0.6  -> accept top-1, stop                           (:378-384)
      else top-1 key joins the cross-phase (outer) histogram       (:386-388)
  no acceptance OR acceptance on the LAST phase -> best = outer top-1
      (:400-403 — note `iter >= sl+gl-1` is also true when the break
       happened at iter == sl+gl-1, overwriting that acceptance; we
       replicate this quirk)

  locate: seq_lookup maps the winning .cat offset to (contig, strand,
      forward offset) (:151-176); reverse-strand reads are
      reverse-complemented before alignment (:433-438)
  align: banded NW vs the same-length window at the located offset with
      limit = (int)(ERROR_RATE * len * 2) (:428); distance > limit => -1
      (unmapped, flag 0x4)

Device seeding: EXPAND-AND-VERIFY, not LF-refinement.  The reference
narrows each seed's SA interval with seed_len-hlen sequential LF steps
(lchash.c:103) — on a device that is 2 serialized gathers per step per seed.
Instead, every candidate in the hlen-mer lchash interval is expanded
directly and the remaining `left = seed_len - hlen` prefix characters are
verified with ONE fused gather from the (SA value, packed 16-base left
context) table (index/device.py sa_ctx).  Vote-order parity is exact: for
positions matching the full seed, suffix order within the hlen-mer interval
equals order within the seed_len-mer interval (both are decided by the text
AFTER the shared prefix), so verified candidates appear in precisely the
reference's SA-interval insertion order.

All seed_len+gap phases are evaluated as ONE batched tensor step (phase is
a data dimension, not a sequential loop); the reference's early-accept
control flow is recovered exactly by a first-accepted-phase selection.
Everything is static-shaped; per-(read, phase) vote expansion is compacted
into `vote_budget` slots (overflow flagged per read).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..index.device import DeviceIndex, IndexMeta
from ..ops.vote import top2_small_histo, top2_votes
from ..utils.config import Params


@dataclass(frozen=True)
class MapperConfig:
    """Static pipeline shape parameters (hashable; closed over by jit)."""
    B: int               # reads per device chunk
    L: int               # padded max read length
    seed_len: int
    gap_len: int
    thres: int
    hlen: int
    n: int               # .cat length
    dollar_pos: int
    accept_score: float
    error_rate: float
    pos64: bool = False  # 40-bit split-hi positions (n >= 2^31 genomes)

    @property
    def phases(self) -> int:
        return self.seed_len + self.gap_len

    @property
    def step(self) -> int:
        return self.seed_len + self.gap_len

    @property
    def left(self) -> int:
        # prefix length verified against the fused context word
        assert 0 <= self.seed_len - self.hlen <= 16, \
            "expand-and-verify supports hlen <= seed_len <= hlen + 16"
        return self.seed_len - self.hlen

    @property
    def max_seeds(self) -> int:
        # seeds per phase: j = iter + s*step must cover j < L - seed_len
        if self.L <= self.seed_len:
            return 1
        return max(1, -(-(self.L - self.seed_len) // self.step))

    @property
    def npos(self) -> int:
        return self.max_seeds * self.phases

    vote_budget: int = 256   # vote slots per (read, phase)
    wide_budget: int = 0     # LF-narrowed wide-seed lanes per batch
                             # (0 = auto: (B*phases*max_seeds)/16)

    @property
    def wide_lanes(self) -> int:
        if self.wide_budget > 0:
            return self.wide_budget
        return max(512, (self.B * self.phases * self.max_seeds) // 16)
    gact_tile: int = 512     # row-tile for the checkpointed long-read path
    gact_threshold: int = 2048   # buckets longer than this use ops/gact
    # run-buffer budget multiplier for the gact walks: the saturation
    # retry tier (models/mapper._retry_saturation) re-runs a flagged
    # chunk through a scale-4 step instead of keeping corrupt CIGARs
    gact_runs_scale: int = 1
    ops_head_cols: int = 128     # eagerly-fetched CIGAR run bytes per read
    # column-consuming traceback (ops/traceback.device_traceback_c):
    # transpose vdirs to (B, band, G) and walk whole band columns per
    # gather — iterations = #indels + 2 instead of L/16 + 2*edits.  Emits
    # 16-bit run entries (counts reach L); the blob ships them bitcast to
    # bytes and the host decode switches on this flag.  Short-read XLA
    # path only; LRM_TB_COLWALK=0 falls back to the per-word v-walk.
    tb_cols: bool = True

    @property
    def tb_entry_bytes(self) -> int:
        """Entry width of the CIGAR runs in the blob: 1 = per-word walk
        int8 run bytes; 2/4 = column-walk (count << 2 | op) entries.
        The count field is entry_bits - 2 wide, and counts reach L on
        the resident-dirs mid-length path — int16's 14-bit field
        overflows at 8192, so those buckets ship int32 entries.  The
        tiled gact walk's counts are bounded by max(T, band - W) < 8192
        (asserted in ops/gact), so it stays at 2."""
        if self.use_gact:
            return 2 if self.tb_cols else 1
        if not self.tb_cols:
            return 1
        cmax = max(self.L, self.short_band - self.short_W)
        return 2 if cmax < 8192 else 4
    # slim HBM index layout (IndexMeta.slim): sa_ctx carries SA only and
    # the 16-base verify window is recomputed from a text_pair gather
    slim: bool = False
    # step variant taking raw ASCII bytes (B, L) uint8 instead of
    # (codes, codes_rc): encode + reverse-complement run on device.
    # UNIFORM-length chunks only (the RC left-align is a single roll by
    # L - max(lens); ragged chunks would need per-row gathers).  Halves
    # H2D traffic and removes ~26 ms/chunk of host LUT passes at B=2048.
    raw_input: bool = False

    # resident-dirs ceiling for mid-length reads: the tiled gact path
    # exists because a full direction volume is O(L * band) HBM, but at
    # the mapper's scaled-down batch sizes a 10-16 kb bucket's volume is
    # only ~0.5-0.9 GB — the single-pass short-read path (no 2x
    # rematerialization, per-indel walk with NO per-tile loop) wins
    # whenever it fits.  gact remains for genuinely long reads (50 kb+)
    # and mesh configs that force it.  LRM_MID_DIRS_BUDGET overrides.
    mid_dirs_budget: int = 1 << 30

    @property
    def use_gact(self) -> bool:
        if self.L <= self.gact_threshold:
            return False
        vol = self.B * (self.L // 16) * self.short_band * 4
        return vol > self.mid_dirs_budget

    @property
    def accept_frac(self):
        """accept_score as an exact small rational (num, den)."""
        from fractions import Fraction
        f = Fraction(self.accept_score).limit_denominator(10000)
        return f.numerator, f.denominator

    exact_slots: bool = False  # use the full headroom budget (retry tier)

    @property
    def vote_slots_exact(self) -> int:
        """Full-headroom slots per (read, phase): the configured budget,
        floored by what the genome statistically needs.  A phase's votes
        are ~max_seeds draws of (1 + Poisson(lam)), lam = n/4^hlen: each
        sampled seed matches ITSELF once (the +1 — measured mean 69 at
        the 4 Mb bench where the lam-only model predicted 23) plus lam
        background hits.  Reserve mean + 2x the background (overflow
        beyond that is flagged per read)."""
        lam = self.n / float(4 ** self.hlen)
        need = int(self.max_seeds * (1 + 2 * max(lam, 0.5))) + 64
        want = max(self.vote_budget, need, 128)
        return -(-want // 128) * 128

    @property
    def vote_slots(self) -> int:
        """Slots the compiled step actually allocates.

        The sa_ctx gather is the map step's single biggest cost and scales
        with SLOTS, not with real votes.  The compact tier budgets
        mean + 5 sigma, where mean = max_seeds*(1+lam) (self-hit + lam
        background per seed) and the variance is the BACKGROUND part only
        (sigma^2 = max_seeds*lam — the self-hits are near-deterministic;
        empirical p99 at the 4 Mb bench: 81 vs mean 69, i.e. ~2.5 of
        these sigma).  Reads whose executed phases overflow raise the
        per-read flag and re-run through an exact_slots step
        (models/mapper._retry_overflow) — bit-identical results with the
        retry tier essentially never firing on low-repeat genomes.  The
        win over exact grows with lam (deep tables / big genomes): at the
        500 Mb hlen=14 bench config this is 384 vs 512 slots."""
        if self.exact_slots:
            return self.vote_slots_exact
        # LRM_VOTE_SLOTS: forced compact-tier budget for A/B runs (the
        # sigma knob can't reach below mean+16 — at the hlen-14 bench
        # config that floors at 80 while the simulated phase max is 58,
        # so a 64-slot candidate needs an explicit override).  Clamped to
        # [64, exact]; 16-granular; the retry tier keeps results
        # bit-identical however tight the budget is set.
        forced = os.environ.get("LRM_VOTE_SLOTS")
        if forced:
            want = max(64, -(-int(forced) // 16) * 16)
            return min(self.vote_slots_exact, want)
        # lam floor 0.05 (was 0.25): at deep-table configs lam is tiny
        # (hlen=14 on the 4 Mb bench: 0.03) and the old floor held the
        # budget at 96 slots where the self-hit mean is ~50 and the
        # simulated phase max over 1e6 draws is ~61 — a 0.05 floor lands
        # on 80 slots, cutting the step's dominant sa_ctx gather by
        # another 1/6.  The retry tier keeps results bit-identical if a
        # tail read ever exceeds the compact budget.
        lam = self.n / float(4 ** self.hlen)
        mean = self.max_seeds * (1 + max(lam, 0.05))
        sigma = (self.max_seeds * max(lam, 0.05)) ** 0.5
        # LRM_VOTE_SIGMA: headroom multiplier A/B knob (default 5.0).
        # Lower = fewer gathered sa_ctx rows per step but more retry-tier
        # dispatches; the retry keeps results bit-identical either way.
        mult = float(os.environ.get("LRM_VOTE_SIGMA", "5.0"))
        want = int(mean + mult * sigma) + 16
        # 16-granular (not 64): at the 4 Mb bench config a 64-rounding
        # made sigma 3 and 5 land on the same 128 slots, turning the
        # LRM_VOTE_SIGMA A/B into a no-op (sim at max_seeds=48: phase max
        # 94 over 4e5 draws; the default lands on 112, a 12.5% gather cut)
        return min(self.vote_slots_exact, max(64, -(-want // 16) * 16))

    # packed slot layout (LRM_SLOT_PACK=2|4): one gathered row covers
    # `slot_pack` ADJACENT sa_ctx rows.  A seed's votes are a CONTIGUOUS
    # SA interval [k, k+cnt), so assignment can run in pack-units of
    # ceil((k%pack + cnt)/pack) rows per seed — fewer, wider gather rows
    # for the step's dominant gather.  Pays off iff the gather cost is
    # per-ROW rather than per-element (scripts/bench_gather.py row-width
    # sweep); flat layout (pack=1) is the default.
    slot_pack: int = 1

    @property
    def pack(self) -> int:
        # the exact-slots retry tier keeps the flat layout (its job is
        # bit-exact reference semantics independent of the packed fast
        # path); mesh steps set exact_slots and ride the same guard
        return 1 if self.exact_slots else self.slot_pack

    @property
    def slot_rows(self) -> int:
        """Gather rows (= assignment slots) per (read, phase)."""
        p = self.pack
        if p == 1:
            return self.vote_slots
        if os.environ.get("LRM_VOTE_SLOTS"):
            # the forced budget is a flat-layout row count; silently
            # ignoring it under a pack>1 layout would make a combined
            # A/B run misleading (ADVICE r4) — refuse the combination.
            raise ValueError(
                "LRM_VOTE_SLOTS and LRM_SLOT_PACK>1 are mutually exclusive "
                "(the packed layout budgets pack-units, not flat slots)")
        lam = max(self.n / float(4 ** self.hlen), 0.25)
        # units/seed = ceil((k%p + 1 + Poisson(lam))/p): mean (lam+p)/p
        # exactly (k%p ~ U[0,p)); variance = background lam/p^2 plus
        # alignment jitter <= 1/4
        mean = self.max_seeds * (1.0 + lam / p)
        var = self.max_seeds * (lam / (p * p) + 0.25)
        mult = float(os.environ.get("LRM_VOTE_SIGMA", "5.0"))
        want = int(mean + mult * var ** 0.5) + 8
        # unit capacity matching the exact vote budget must include the
        # per-seed edge waste — a seed strands up to p-1 positions at its
        # FIRST unit (k%p) and up to p-1 more at its last (ceil rounding),
        # so units/seed <= (cnt + 2(p-1))/p: ceil(exact/p) alone
        # under-budgets (sim at the 4 Mb bench: pack-4 phase max > exact/4)
        cap = -(-(self.vote_slots_exact
                  + self.max_seeds * 2 * (p - 1)) // p)
        return min(cap, max(32, -(-want // 8) * 8))


    @property
    def W(self) -> int:
        # static band half-width >= every read's limit (len <= L)
        return max(8, int(self.error_rate * self.L * 2))

    @property
    def band(self) -> int:
        return -(-(2 * self.W + 1) // 128) * 128

    # half-band first pass for the gact (long-read) buckets: DP cells
    # scale with the band, and the limit-derived W (2*err*L) is ~3x the
    # TYPICAL edit distance, so the primary step runs at W/2 and flags
    # the rare ed >= W/2 lanes for a full-band retry (overflow bit 2 ->
    # models/mapper._retry_overflow splices exact rows back).
    # Exactness: a banded value <= W'-1 is achieved by a path deviating
    # <= W'-1 columns, which fits strictly inside ANY band >= W' — so
    # every H value (and every stored direction the walk can visit) of a
    # lane with ed < W' is identical between the W' and W bands; only
    # ed' >= W' lanes (where ed' >= true ed) need the retry.
    half_band: bool = False

    @property
    def gact_W(self) -> int:
        if self.half_band:
            return min(self.W, max(64, self.W // 2))
        return self.W

    @property
    def gact_band(self) -> int:
        return -(-(2 * self.gact_W + 1) // 128) * 128

    # narrow-band first pass for the SHORT-read path (opt-in A/B:
    # LRM_SHORT_BAND=<W'>): same exact-or-retry contract as half_band,
    # but the win only exists when 2*W'+1 crosses a 128-lane band
    # boundary (the 1 kb bucket: W 102 -> 63 shrinks band 256 -> 128)
    # AND typical ed stays ~6 sigma below W' — at high error rates every
    # chunk would pay the retry dispatch, so this stays off by default.
    short_W_override: int = 0

    @property
    def short_W(self) -> int:
        if 0 < self.short_W_override < self.W:
            return self.short_W_override
        return self.W

    @property
    def short_band(self) -> int:
        return -(-(2 * self.short_W + 1) // 128) * 128

    @property
    def meta_words(self) -> int:
        """int32 columns in the per-read meta row: positions (best, off)
        ship as [lo, hi] int32 pairs on the pos64 path."""
        return 10 if self.pos64 else 8

    @staticmethod
    def from_params(p: Params, meta: IndexMeta, B: int, L: int) -> "MapperConfig":
        return MapperConfig(
            B=B, L=L, seed_len=p.seed_len, gap_len=p.gap_len, thres=p.thres,
            hlen=meta.hlen, n=meta.n,
            dollar_pos=meta.dollar_pos, accept_score=p.accept_score,
            error_rate=p.error_rate, vote_budget=p.vote_budget,
            pos64=meta.pos_dtype == "int64", slim=meta.slim,
            tb_cols=os.environ.get("LRM_TB_COLWALK", "1") != "0",
            short_W_override=int(os.environ.get("LRM_SHORT_BAND", "0")),
            mid_dirs_budget=int(os.environ.get("LRM_MID_DIRS_BUDGET",
                                               1 << 30)),
            slot_pack=(lambda v: v if v in (1, 2, 4) else 1)(
                int(os.environ.get("LRM_SLOT_PACK", "1"))))


def _position_tables(cfg: MapperConfig, codes):
    """Per-START-POSITION packed seed values, computed once with static
    shifted slices (no gathers): for every j in [0, npos)

      qw[j]  = 2-bit pack of codes[j .. j+left)          (verify pattern)
      num[j] = lchash key of codes[j+left .. j+seed_len) (first char is the
               most-significant 2 bits — lchash.c:36-49)
      ok[j]  = all seed_len codes < 4 (N-free seed; N seeds hit the empty
               interval in the reference's defined-behavior replacement)
    """
    B, L = codes.shape
    sl, hlen, left, NP = cfg.seed_len, cfg.hlen, cfg.left, cfg.npos
    need = NP + sl
    cp = codes if need <= L else jnp.concatenate(
        [codes, jnp.full((B, need - L), 4, codes.dtype)], axis=1)
    c32 = cp.astype(jnp.int32)

    qw = jnp.zeros((B, NP), jnp.int32)
    for t in range(left):
        qw = qw | (c32[:, t:t + NP] << (2 * t))
    num = jnp.zeros((B, NP), jnp.int32)
    for t in range(hlen):
        num = num | (c32[:, left + t:left + t + NP] << (2 * (hlen - 1 - t)))
    ok = jnp.ones((B, NP), bool)
    for t in range(sl):
        ok = ok & (c32[:, t:t + NP] < 4)
    return qw, num, ok


def _by_phase(cfg: MapperConfig, a):
    """(B, npos) position-major -> (B*phases, max_seeds): j = it + s*step."""
    B = a.shape[0]
    return (a.reshape(B, cfg.max_seeds, cfg.phases)
             .transpose(0, 2, 1)
             .reshape(B * cfg.phases, cfg.max_seeds))


def _narrow_wide_seeds(cfg: MapperConfig, idx: DeviceIndex, wide,
                       k12, l12, cnt12, qw):
    """LF-narrow repeat-heavy seeds to their exact seed_len-mer intervals.

    Seeds whose hlen-mer interval is >= thres wide (`wide`, (BP, S) bool)
    are compacted into cfg.wide_lanes lanes (one device sort), narrowed
    with `left` masked backward-search steps (ops/rank.backward_step — the
    reference's lchash.c:103 loop, but only on the lanes that need it),
    informative-filtered (0 < hits < thres, alnmain.c:360), and scattered
    back.  The whole branch runs under lax.cond, so batches with no wide
    seeds (most genomes below ~100 Mb) skip it entirely.

    Returns (k_seed (BP,S), cnt (BP,S), row_overflow (BP,)): the expansion
    base rank per seed, its vote count (0 for filtered/non-selected wide
    seeds), and which rows lost a wide seed to the lane budget.
    """
    from ..ops.rank import backward_step

    BP, S = wide.shape
    left = cfg.left
    Kw = cfg.wide_lanes
    N = BP * S

    def no_wide(args):
        k12, l12, cnt12, qw = args
        # derive from `wide` so the branch outputs carry the same
        # device-varying type under shard_map
        return k12, cnt12, jnp.any(wide, axis=1) & False

    def do_narrow(args):
        k12, l12, cnt12, qw = args
        flat_w = wide.reshape(-1)
        iota = jnp.arange(N, dtype=jnp.int32)
        key = jnp.where(flat_w, jnp.int32(0), jnp.int32(1))
        key_s, sel = lax.sort((key, iota), dimension=0, is_stable=True,
                              num_keys=1)
        sel = sel[:Kw]
        sel_valid = key_s[:Kw] == 0
        sel_safe = jnp.where(sel_valid, sel, 0)
        k = k12.reshape(-1)[sel_safe]
        l = l12.reshape(-1)[sel_safe]
        qws = qw.reshape(-1)[sel_safe]
        if left > 0:
            def stp(carry, t):
                kk, ll = carry
                c = ((qws >> (2 * t)) & 3).astype(jnp.int32)
                kk, ll = backward_step(idx.c4, idx.packed, idx.occ_samp,
                                       cfg.dollar_pos, kk, ll, c,
                                       sel_valid & (kk <= ll))
                return (kk, ll), None
            (k, l), _ = lax.scan(stp, (k, l),
                                 jnp.arange(left - 1, -1, -1))
        hits = jnp.where(sel_valid & (k <= l), l - k + 1, 0)
        informative = (hits > 0) & (hits < cfg.thres)
        cnt_w = jnp.where(informative, hits, 0).astype(jnp.int32)

        # scatter back via a one-slot dump for unselected lanes
        tgt = jnp.where(sel_valid, sel, N)

        def scat(base_flat, vals):
            padded = jnp.concatenate(
                [base_flat, jnp.zeros((1,), base_flat.dtype)])
            return padded.at[tgt].set(vals.astype(base_flat.dtype))[:N]

        # all wide seeds default to 0 votes; selected ones get their
        # narrowed count (non-selected stay 0 and flag their row)
        cnt_base = jnp.where(wide, 0, cnt12).reshape(-1)
        cnt = scat(cnt_base, cnt_w).reshape(BP, S)
        k_seed = scat(k12.reshape(-1), k.astype(k12.dtype)).reshape(BP, S)
        picked = scat(jnp.zeros((N,), jnp.int32),
                      sel_valid.astype(jnp.int32)).reshape(BP, S) > 0
        row_overflow = jnp.any(wide & ~picked, axis=1)
        return k_seed, cnt, row_overflow

    return lax.cond(jnp.any(wide), do_narrow, no_wide,
                    (k12, l12, cnt12, qw))


def _join_hi(lo, hi):
    """(int32 low word, uint8 high byte) -> int64 position."""
    return ((hi.astype(jnp.int64) << 32)
            | lo.astype(jnp.uint32).astype(jnp.int64))


def _slots_by_sort(cfg: MapperConfig, cnt, k_seed, qw, j_ps, wide,
                   extras=(), n_slots=None):
    """Slot -> seed assignment by merge-sort instead of the owns matrix.

    The owns-matrix reduce materializes (B*P, S, C) — fine for short
    reads (S <= ~100) but QUADRATIC in read length (S ~ L/step and
    C ~ 2*S*lam), blowing memory at 50 kb.  Long reads have few rows and
    long columns, exactly where device sorts are cheap, so: per row, sort
    seed records (key = 2*start) and slot probes (key = 2*slot + 1)
    together, forward-fill each seed's payload onto the slots it owns
    (associative scan), then stable-sort the slot probes back to the
    front.  Produces bit-identical (p_rank, qw, j, wide) per slot to the
    owns path (property-tested in tests/test_ops.py).

    `extras`: per-seed (BP, S) arrays forwarded onto owning slots like qw
    (zeroed on empty slots); returned as a trailing tuple.  `n_slots`
    overrides cfg.vote_slots (the packed layout assigns pack-units).
    """
    BP, S = cnt.shape
    C = n_slots or cfg.vote_slots
    pdt = k_seed.dtype
    cum = jnp.cumsum(cnt, axis=1)
    starts = cum - cnt

    big = jnp.int32(0x7FFFFFFF)
    seed_key = jnp.where(cnt > 0, starts * 2, big)
    slot_key = (2 * jnp.arange(C, dtype=jnp.int32) + 1)[None, :]
    keys = jnp.concatenate(
        [seed_key, jnp.broadcast_to(slot_key, (BP, C))], axis=1)
    zP = jnp.zeros((BP, C), pdt)
    z32 = jnp.zeros((BP, C), jnp.int32)
    d_all = jnp.concatenate([k_seed - starts.astype(pdt), zP], axis=1)
    qw_all = jnp.concatenate([qw, z32], axis=1)
    aux_all = jnp.concatenate(
        [((j_ps + 1) << 1) | wide.astype(jnp.int32), z32], axis=1)
    ex_all = tuple(jnp.concatenate(
        [e, jnp.zeros((BP, C), e.dtype)], axis=1) for e in extras)
    isslot = jnp.concatenate(
        [jnp.zeros((BP, S), jnp.int8), jnp.ones((BP, C), jnp.int8)], axis=1)

    srt = lax.sort((keys, d_all, qw_all, aux_all) + ex_all + (isslot,),
                   dimension=1, is_stable=True, num_keys=1)
    d_s, qw_s, aux_s = srt[1:4]
    ex_s = srt[4:-1]
    slot_s = srt[-1]

    # forward-fill the latest SEED record onto following slot probes
    def fill(a, b):
        keep_b = b[-1] > 0
        vals = tuple(jnp.where(keep_b, bv, av)
                     for av, bv in zip(a[:-1], b[:-1]))
        return vals + (jnp.maximum(a[-1], b[-1]),)

    seen = (1 - slot_s).astype(jnp.int32)       # 1 at seed records
    payload = tuple(jnp.where(slot_s == 0, v, jnp.zeros_like(v))
                    for v in (d_s, qw_s, aux_s) + ex_s) + (seen,)
    filled = lax.associative_scan(fill, payload, axis=1)

    # slot probes back to the front, in slot order (stable)
    back = lax.sort(((1 - slot_s).astype(jnp.int32),) + filled,
                    dimension=1, is_stable=True, num_keys=1)
    d_o, qw_o, aux_o = (a[:, :C] for a in back[1:4])
    ex_o = tuple(a[:, :C] for a in back[4:-1])
    seen_o = back[-1][:, :C]

    slot_idx = jnp.arange(C, dtype=jnp.int32)[None, :]
    total = cum[:, -1]
    slot_valid = (slot_idx < total[:, None]) & (seen_o > 0)
    p_rank = jnp.where(slot_valid, d_o + slot_idx.astype(pdt), 0)
    qw_slot = qw_o
    wide_slot = slot_valid & ((aux_o & 1) > 0)
    j_slot = jnp.where(slot_valid, (aux_o >> 1) - 1, -1)
    ex_slot = tuple(jnp.where(slot_valid, e, jnp.zeros_like(e))
                    for e in ex_o)
    return p_rank, qw_slot, wide_slot, j_slot, total, ex_slot


def _ctx_window(cfg: MapperConfig, idx: DeviceIndex, sa12):
    """Slim-layout verify window: recompute the ctx word _pack_ctx_words
    would have fused — one (R,2) adjacent-word gather from the padded
    text pairs (rows [padded[w], padded[w+1]]); w0's +1 is the pad offset.
    start in [-16, n-17]; int32/int64 >> and & 15 give floor semantics
    for the negative sub-word offsets."""
    left = cfg.left
    start = sa12 - 16
    w0 = lax.shift_right_arithmetic(start, np.int32(4) if not
                                    cfg.pos64 else 4) + 1
    o = (start & 15).astype(jnp.uint32)
    pair = idx.text_pair[jnp.clip(w0, 0, idx.text_pair.shape[0] - 1)]
    lo = lax.shift_right_logical(pair[..., 0].astype(jnp.uint32), 2 * o)
    # o == 0 would shift by 32 (undefined on u32): mask it off
    hi = jnp.where(o == 0, jnp.uint32(0),
                   pair[..., 1].astype(jnp.uint32)
                   << jnp.minimum(32 - 2 * o, np.uint32(31)))
    ctx = lo | hi
    return lax.shift_right_logical(ctx, np.uint32(2 * (16 - left)))


def _seed_vote(cfg: MapperConfig, idx: DeviceIndex, codes, lens):
    """All seeding phases in one batched pass; returns (best, overflow)."""
    B, P, S = cfg.B, cfg.phases, cfg.max_seeds
    left = cfg.left
    BP = B * P

    qw_p, num_p, ok_p = _position_tables(cfg, codes)
    qw = _by_phase(cfg, qw_p)                          # (BP, S)
    num = _by_phase(cfg, num_p)
    ok = _by_phase(cfg, ok_p)

    # seed start offsets j = it + s*step, as (P, S) -> (BP, S)
    j_ps = jnp.tile((jnp.arange(P, dtype=jnp.int32)[:, None]
                     + cfg.step * jnp.arange(S, dtype=jnp.int32)[None, :]),
                    (B, 1))
    lens_bp = jnp.repeat(lens.astype(jnp.int32), P)    # (BP,)
    seed_ok = j_ps < (lens_bp[:, None] - cfg.seed_len)

    # lc_access (lchash.c:12-16): one row gather; (0,0) rows = absent k-mer.
    # pos64: (k, l) ride as int32 low words + uint8 high bytes (no int64
    # gathers).
    safe_num = jnp.clip(num, 0, idx.lch.shape[0] - 1)
    kl = idx.lch[safe_num]
    if cfg.pos64:
        klh = idx.lch_hi[safe_num]
        k12 = _join_hi(kl[..., 0], klh[..., 0])
        l12 = _join_hi(kl[..., 1], klh[..., 1])
    else:
        k12 = kl[..., 0].astype(jnp.int32)
        l12 = kl[..., 1].astype(jnp.int32)
    present = ok & seed_ok & ~((k12 == 0) & (l12 == 0))
    # hlen-mer interval width; clamped to thres so the count lanes stay
    # int32 (every >= thres seed is wide and never expands directly)
    cnt12 = jnp.where(present,
                      jnp.minimum(l12 - k12 + 1, cfg.thres), 0
                      ).astype(jnp.int32)

    # WIDE-SEED FALLBACK: a repeat-heavy hlen-mer (hits12 >= thres) would
    # blow the expansion budget and cannot decide informativeness cheaply;
    # those rare seeds are compacted into `wide_lanes` lanes and LF-narrowed
    # to their exact seed_len-mer interval, exactly like the reference's
    # per-seed backward search (lchash.c:103) — but only for the seeds that
    # need it.  Lanes beyond the budget raise the overflow flag.
    wide = present & (cnt12 >= cfg.thres)
    k_seed, cnt, wide_overflow = _narrow_wide_seeds(
        cfg, idx, wide, k12, l12, cnt12, qw)
    is_wide = wide                                      # (BP, S)

    # compaction: seed-major, interval-rank-minor contiguous slot layout.
    # Short reads use the fused owns-matrix reduce ((BP, S, C) compare+
    # mask+sum); long reads use the sort-based assignment — owns is
    # quadratic in read length (S ~ L/step AND C ~ 2*S*lam) and would
    # materialize TBs at 50 kb.  Genome-scale slot counts also blow the
    # owns transient (4 GB at B=2048, C=512), so big products take the
    # sort path too (bit-identical, property-tested).
    #
    # Packed layout (cfg.pack > 1): a seed's votes are the CONTIGUOUS SA
    # rows [k, k+cnt), so assignment runs in units of `pk` adjacent rows
    # — ceil((k%pk + cnt)/pk) units per seed — and each gather row later
    # fetches pk (sa, ctx) entries at once.  The seed's absolute k and
    # cnt ride along as slot extras to mask the unit-edge positions that
    # fall outside [k, k+cnt).
    pk = cfg.pack
    CS = cfg.slot_rows
    if pk > 1:
        shiftp = pk.bit_length() - 1
        a_base = k_seed >> shiftp
        a_cnt = jnp.where(
            cnt > 0,
            ((k_seed & (pk - 1)).astype(jnp.int32) + cnt + pk - 1)
            >> shiftp, 0)
        extras = (k_seed, cnt)
    else:
        a_base, a_cnt, extras = k_seed, cnt, ()

    if cfg.use_gact or B * P * S * CS > (1 << 28):
        p_rank, qw_slot, wide_slot, j_slot, total, ex_slot = _slots_by_sort(
            cfg, a_cnt, a_base, qw, j_ps, is_wide, extras=extras,
            n_slots=CS)
    else:
        cum = jnp.cumsum(a_cnt, axis=1)
        total = cum[:, -1]
        starts = cum - a_cnt
        slots = jnp.arange(CS, dtype=jnp.int32)[None, None, :]
        owns = (starts[:, :, None] <= slots) & (slots < cum[:, :, None])
        o32 = owns.astype(jnp.int32)
        p_rank = (jnp.sum(o32 * (a_base - starts)[:, :, None], axis=1)
                  + slots[0])
        qw_slot = jnp.sum(o32 * qw[:, :, None], axis=1)
        wide_slot = jnp.sum(o32 * is_wide.astype(jnp.int32)[:, :, None],
                            axis=1) > 0
        # j+1 so empty slots carry -1 (distinct from any real seed's j)
        j_slot = jnp.sum(o32 * (j_ps + 1)[:, :, None], axis=1) - 1
        ex_slot = tuple(jnp.sum(o32 * e[:, :, None], axis=1)
                        for e in extras)
    valid = j_slot >= 0

    # ONE fused gather per vote: (SA value, packed 16-base left context).
    # Narrowed wide seeds index the seed_len-mer interval directly: their
    # SA value IS the seed start and needs no verification.  The gather
    # reads every slot, occupied or not; its cost scales with slot COUNT
    # (vote_slots / LRM_VOTE_SIGMA).
    if pk == 1:
        p_safe = jnp.clip(p_rank, 0, cfg.n - 1)
        if cfg.slim:
            sa_low = idx.sa_ctx[p_safe]                # (BP, C)
            sa12 = (_join_hi(sa_low, idx.sa_hi[p_safe]) if cfg.pos64
                    else sa_low)
            ctx_col = None
        else:
            row = idx.sa_ctx[p_safe]                   # (BP, C, 2)
            if cfg.pos64:
                sa12 = _join_hi(row[..., 0], idx.sa_hi[p_safe])
            else:
                sa12 = row[..., 0]
            ctx_col = row[..., 1]
        valid_v, qw_v, wide_v, j_v = valid, qw_slot, wide_slot, j_slot
    else:
        # packed gather: CS rows of pk adjacent (sa, ctx) entries each,
        # expanded to CS*pk votes; unit-edge positions outside the owning
        # seed's [k, k+cnt) are masked via the forwarded extras
        kfwd, cntfwd = ex_slot
        n_tbl = idx.sa_ctx.shape[0]
        n_units = -(-n_tbl // pk)
        padr = n_units * pk - n_tbl

        def _units(t, w):
            # padr > 0 copies the table once per step (~40 us at the 4 Mb
            # bench — fine for the A/B).  If pack graduates to default,
            # pad sa_ctx/sa_hi to 4-row multiples at build time instead
            # (devidx version bump) so this branch is statically dead.
            tp = t if padr == 0 else jnp.concatenate(
                [t, jnp.zeros((padr,) + t.shape[1:], t.dtype)], axis=0)
            return tp.reshape(n_units, w)

        u_safe = jnp.clip(p_rank, 0, n_units - 1)

        def rep(a):
            return jnp.repeat(a, pk, axis=1)

        if cfg.slim:
            sa_low = _units(idx.sa_ctx, pk)[u_safe].reshape(BP, CS * pk)
            ctx_col = None
        else:
            rowg = _units(idx.sa_ctx, 2 * pk)[u_safe].reshape(
                BP, CS * pk, 2)
            sa_low = rowg[..., 0]
            ctx_col = rowg[..., 1]
        if cfg.pos64:
            hi8 = _units(idx.sa_hi, pk)[u_safe].reshape(BP, CS * pk)
            sa12 = _join_hi(sa_low, hi8)
        else:
            sa12 = sa_low
        half = jnp.tile(jnp.arange(pk, dtype=jnp.int32), CS)[None, :]
        posa = rep(p_rank) * pk + half.astype(p_rank.dtype)
        kv, cv = rep(kfwd), rep(cntfwd)
        valid_v = rep(valid) & (posa >= kv) & (posa < kv + cv)
        qw_v, wide_v, j_v = rep(qw_slot), rep(wide_slot), rep(j_slot)

    if left > 0:
        win = (_ctx_window(cfg, idx, sa12) if cfg.slim else
               lax.shift_right_logical(ctx_col.astype(jnp.uint32),
                                       np.uint32(2 * (16 - left))))
        verified = valid_v & (wide_v | ((sa12 >= left) &
                              (win == qw_v.astype(jnp.uint32))))
    else:
        verified = valid_v

    # informative filter (alnmain.c:360: 0 < hits < thres) is already
    # implied: non-wide seeds have verified-count <= cnt12 < thres by the
    # wide cutoff, and narrowed wide seeds were filtered to hits < thres at
    # narrowing time — so no per-slot recheck is needed here
    vote_ok = verified
    keys = sa12 - jnp.where(wide_v, 0, left) - j_v  # diagonal = SA - j

    v1, key1, v2 = top2_votes(keys, vote_ok)           # (BP,)
    v1 = v1.reshape(B, P)
    key1 = key1.reshape(B, P)
    v2 = v2.reshape(B, P)

    # per-phase accept: `(double)(v1+v2)/num_seeds > 0.6` (alnmain.c:375-378)
    # as an exact rational compare (no float64 on the device path; the gap
    # between the double literal and the rational is ~2e-17, unreachable
    # by v/num)
    num_seeds = (lens.astype(jnp.int32) // cfg.step)[:, None]
    nacc, dacc = cfg.accept_frac
    accept = (num_seeds > 0) & ((v1 + v2) * dacc > nacc * num_seeds)
    any_acc = jnp.any(accept, axis=1)
    it_star = jnp.argmax(accept, axis=1).astype(jnp.int32)
    best_acc = jnp.take_along_axis(key1, it_star[:, None], axis=1)[:, 0]

    # outer histogram (alnmain.c:386-388): every phase BEFORE the accepted
    # one (all phases if none accepted) adds its nonzero top-1 key
    pidx = jnp.arange(P, dtype=jnp.int32)[None, :]
    upto = jnp.where(any_acc, it_star, P)[:, None]
    outer_valid = (num_seeds > 0) & (v1 != 0) & (pidx < upto)
    _, okey1, _ = top2_small_histo(key1, outer_valid)

    # post-loop overwrite (alnmain.c:400-403): no acceptance OR acceptance
    # exactly on the last phase -> outer top-1 wins
    need_outer = ~any_acc | (it_star == P - 1)
    best = jnp.where(need_outer, okey1, best_acc)
    # overflow only counts phases the reference's early-exit loop actually
    # executes (0 .. accepted phase inclusive; all P when none accepted) —
    # a dropped vote in a never-run later phase cannot affect the mapping
    executed = pidx <= jnp.where(any_acc, it_star, P - 1)[:, None]
    per_phase_ovf = ((total > CS) | wide_overflow).reshape(B, P)
    overflow = jnp.any(per_phase_ovf & executed, axis=1)
    return best, overflow


def _seq_lookup(idx: DeviceIndex, loc, qlen):
    """Vectorized seq_lookup (alnmain.c:151-176): first contig whose forward
    or reverse half fully contains [loc, loc+qlen)."""
    pdt = idx.mta_start.dtype
    start = idx.mta_start[None, :]                     # (1,M)
    slen = idx.mta_len[None, :]
    end = start + 2 * slen
    loc_ = loc.astype(pdt)[:, None]
    q_ = qlen[:, None].astype(pdt)
    fwd = (loc_ >= start) & (loc_ + q_ <= start + slen)
    rev = (loc_ >= start + slen) & (loc_ + q_ <= end)
    hit = fwd | rev
    found = jnp.any(hit, axis=1)
    gi = jnp.argmax(hit, axis=1)
    g_start = jnp.take(idx.mta_start, gi)
    g_len = jnp.take(idx.mta_len, gi)
    g_end = g_start + 2 * g_len
    strand = jnp.take_along_axis(rev, gi[:, None], axis=1)[:, 0] & found
    off = jnp.where(strand, g_end - loc.astype(pdt) - qlen.astype(pdt),
                    loc.astype(pdt) - g_start)
    loc_fwd = jnp.where(strand, off + g_start, loc)
    return found, gi.astype(jnp.int32), strand, off, loc_fwd


def make_map_step(cfg: MapperConfig):
    """Build the jitted device mapping step.

    step(idx, codes (B,L) int8, codes_rc (B,L) int8, lens (B,) int32,
         limits (B,) int32) -> dict(meta (B,8) int32, ops packed int32)

    `codes_rc` is the reverse complement of each read, front-aligned and
    pad-4-filled, computed HOST-side at submit (a per-row device gather is
    ~10x the cost of the numpy flip).  `limits` = (int)(ERROR_RATE*len*2)
    in C double semantics (alnmain.c:428, exactly).

    With cfg.raw_input the signature is step(idx, raw (B,L) uint8, lens,
    limits): ASCII decode (ACGT/acgt -> 0..3, else 4 incl. the zero pad)
    and the reverse complement run on device — compare-selects fused
    into the step, valid for uniform-length chunks where the RC re-align
    is one roll (the wrapped pad 4s land exactly on the tail).
    """

    def _body(idx: DeviceIndex, codes, codes_rc, lens, limits):
        B, L, W, band = cfg.B, cfg.L, cfg.W, cfg.band
        best, overflow = _seed_vote(cfg, idx, codes, lens)

        # PART 2: locate + align (alnmain.c:420-451)
        found, gi, strand, off, loc_fwd = _seq_lookup(idx, best, lens)
        safe_loc = jnp.clip(jnp.where(found, loc_fwd, 0), 0, cfg.n - 1)

        # reverse-strand reads align their reverse complement (:433-438)
        q = jnp.where(strand[:, None], codes_rc, codes)

        # target window via the 2-bit packed text: L/16 word gathers per
        # read + a vector shift-realign beats L byte gathers ~10x
        i_idx = jnp.arange(L, dtype=jnp.int32)[None, :]
        nwords = L // 16
        w0 = (safe_loc >> 4).astype(jnp.int32)
        o = (safe_loc & 15).astype(jnp.int32)[:, None]
        # the window rows are CONTIGUOUS word slices, so fetch them as a
        # slice-gather (slice_sizes=(nwords+1,)): one row per read
        # instead of B*(L/16+1) single-element gathers.  text_packed is
        # padded by a
        # window so CLIP never shifts an in-range row; pad words are only
        # read at positions >= n, which the gpos mask sends to 5.
        tp_pad = jnp.concatenate(
            [idx.text_packed,
             jnp.zeros((nwords + 1,), idx.text_packed.dtype)])
        wordsu = lax.gather(
            tp_pad, jnp.maximum(w0, 0)[:, None],
            lax.GatherDimensionNumbers(offset_dims=(1,),
                                       collapsed_slice_dims=(),
                                       start_index_map=(0,)),
            slice_sizes=(nwords + 1,),
            mode=lax.GatherScatterMode.CLIP).astype(jnp.uint32)
        lo = lax.shift_right_logical(wordsu[:, :-1],
                                     (2 * o).astype(jnp.uint32))
        hi_shift = jnp.where(o > 0, 32 - 2 * o, 31).astype(jnp.uint32)
        hi = jnp.where(o > 0, wordsu[:, 1:] << hi_shift, 0)
        aligned = (lo | hi).astype(jnp.int32)                # (B, nwords)
        shifts = (2 * jnp.arange(16, dtype=jnp.int32))[None, None, :]
        t = ((aligned[:, :, None] >> shifts) & 3).reshape(B, L)
        # '$' (position n-1) and out-of-range -> 5 so they never match
        gpos = safe_loc[:, None] + i_idx.astype(safe_loc.dtype)
        t = jnp.where(gpos >= cfg.n - 1, 5, t).astype(jnp.int8)

        if cfg.use_gact:
            # long reads: checkpointed tiled DP + rematerialized
            # run-consuming walk keeps memory O(tile * band) instead of
            # O(L * band) (ops/gact.py); same run-byte format as the
            # short path, so everything downstream is shared
            from ..ops.gact import (gact_forward, gact_traceback_c,
                                    gact_traceback_v)
            T = cfg.gact_tile
            Wg, bandg = cfg.gact_W, cfg.gact_band
            ckpt, wcol = gact_forward(q, t, T, Wg, bandg)
            ed_pre = wcol[lens, jnp.arange(B)].astype(jnp.int32)
            # half-band first pass (cfg.half_band): values < Wg are exact
            # (see MapperConfig.half_band); ed' >= Wg lanes whose limit
            # the half band cannot certify are flagged (bit 2) for the
            # mapper's full-band retry splice and skip their walk here.
            if cfg.half_band:
                band_short = found & (ed_pre >= jnp.int32(Wg)) & \
                    (jnp.int32(Wg) <= limits.astype(jnp.int32))
            else:
                band_short = jnp.zeros_like(found)
            # dead lanes (unmapped / over-limit — SAM CIGAR '*' either
            # way) skip their walk via masked lens: they would otherwise
            # pace every tile's while_loop to its indel bound
            alive = found & (ed_pre <= limits.astype(jnp.int32)) & \
                ~band_short
            lens_tb = jnp.where(alive, lens.astype(jnp.int32), 0)
            if cfg.tb_cols:
                # per-INDEL column walk (ops/gact.gact_traceback_c): a
                # subs-only lane crosses a tile in ONE iteration instead
                # of T/16 word fragments; 16-bit entries (counts <= T)
                run_units, run_sat = gact_traceback_c(
                    q, t, ckpt, lens_tb, T, Wg, bandg,
                    scale=cfg.gact_runs_scale)
                K = 2 * run_units.shape[1]      # bytes after bitcast
            else:
                run_bytes, run_sat = gact_traceback_v(
                    q, t, ckpt, lens_tb, T, Wg, bandg,
                    scale=cfg.gact_runs_scale)
                # real (non-pad) run bytes for an in-limit read: word
                # fragments (L/16 + one boundary split per tile + one per
                # edit) + one edit byte per edit, edits <= ed <= Wg
                K = (L // 16 + L // T + cfg.gact_runs_scale * 4 * Wg + 16)
            # a saturated shared run buffer can corrupt ANY lane's CIGAR
            # (ops/gact.gact_traceback_v) — surface it in the per-read
            # flag word so no silent truncation path remains.  DISTINCT
            # bit from the vote overflow: re-running with more vote slots
            # cannot grow the run buffer, so the retry tier must not fire
            # on saturation (bit 1), only on vote overflow (bit 0).
            overflow = overflow.astype(jnp.int32) | \
                jnp.where(run_sat, jnp.int32(2), jnp.int32(0)) | \
                jnp.where(band_short, jnp.int32(4), jnp.int32(0))
        else:
            from ..ops.wavefront import banded_nw_dirs_v
            from ..ops.traceback import (device_traceback_c,
                                         device_traceback_v,
                                         traceback_c_iters,
                                         traceback_v_iters)
            if cfg.tb_cols:
                # column-consuming walk: one gather per INDEL instead of
                # per 16-row word.  Dead lanes (unmapped / over-limit, SAM
                # CIGAR '*' either way) skip their walk entirely via the
                # masked lens — they would otherwise pace the while_loop.
                Ws, bands = cfg.short_W, cfg.short_band
                vdirs, wcol, nm = banded_nw_dirs_v(q, t, Ws, bands,
                                                   with_nm=True)
                ed_pre = wcol[lens, jnp.arange(B)].astype(jnp.int32)
                if Ws < W:
                    # narrow-band first pass (cfg.short_W_override): same
                    # exact-or-retry contract as the gact half_band
                    band_short = found & (ed_pre >= jnp.int32(Ws)) & \
                        (jnp.int32(Ws) <= limits.astype(jnp.int32))
                    overflow = overflow.astype(jnp.int32) | \
                        jnp.where(band_short, jnp.int32(4), jnp.int32(0))
                else:
                    band_short = jnp.zeros_like(found)
                alive = found & (ed_pre <= limits.astype(jnp.int32)) & \
                    ~band_short
                lens_tb = jnp.where(alive, lens.astype(jnp.int32), 0)
                run_units = device_traceback_c(
                    vdirs, lens_tb, L, Ws, nm=nm,
                    entry_dtype=jnp.int16 if cfg.tb_entry_bytes == 2
                    else jnp.int32)
                K = cfg.tb_entry_bytes * run_units.shape[1]
            else:
                vdirs, wcol = banded_nw_dirs_v(q, t, W, band)
                run_bytes = device_traceback_v(vdirs, lens, L, W)
                # real run bytes for an in-limit read: <= L/16 + 2W + slack
                K = traceback_v_iters(L, W) + 4
                band_short = jnp.zeros_like(found)
        ed_raw = wcol[lens, jnp.arange(B)].astype(jnp.int32)
        limit = limits.astype(jnp.int32)
        ed = jnp.where(ed_raw <= limit, ed_raw, -1)
        # a bit-2 lane's ed' is only an upper bound — never report it
        # (the retry splice replaces the whole row with exact values)
        ed = jnp.where(band_short, -1, ed)

        # Host-link layout: every fetched array pays its own round trip,
        # so everything leaves the device as exactly two dense arrays —
        # per-read scalars stacked into `meta` and the op string packed
        # 2 bits/op (codes 0=M 1=I 2=D 3=pad).  pos64 rows carry best/off
        # as little-endian [lo, hi] int32 pairs.
        if cfg.pos64:
            b2 = lax.bitcast_convert_type(best, jnp.int32)
            o2 = lax.bitcast_convert_type(off.astype(jnp.int64), jnp.int32)
            meta = jnp.stack([b2[:, 0], b2[:, 1], found.astype(jnp.int32),
                              gi, strand.astype(jnp.int32),
                              o2[:, 0], o2[:, 1], ed, limit,
                              overflow.astype(jnp.int32)], axis=1)
        else:
            meta = jnp.stack([best.astype(jnp.int32),
                              found.astype(jnp.int32),
                              gi, strand.astype(jnp.int32),
                              off.astype(jnp.int32), ed, limit,
                              overflow.astype(jnp.int32)], axis=1)
        # compact the run bytes (stable sort by pad flag keeps path order):
        # at most head_cols entries are real for typical reads, so the D2H
        # fetch ships meta + the head FUSED into one array (one round trip
        # instead of two); `ops_tail` is fetched lazily only when some
        # read overflows the head
        if cfg.tb_entry_bytes > 1:
            # pad-sort the 16/32-bit entries, then ship them bitcast to
            # little-endian byte groups (the host decode views them back
            # at cfg.tb_entry_bytes width — models/mapper._rle_groups)
            is_pad = ((run_units & 3) == 3).astype(jnp.int8)
            _, cu = lax.sort((is_pad, run_units), dimension=1,
                             is_stable=True, num_keys=1)
            compact = lax.bitcast_convert_type(cu, jnp.int8).reshape(
                cfg.B, -1)
        else:
            is_pad = ((run_bytes & 3) == 3).astype(jnp.int8)
            _, compact = lax.sort((is_pad, run_bytes), dimension=1,
                                  is_stable=True, num_keys=1)
        # long reads legitimately need ~L/16+2*ed real bytes, so the gact
        # path ships all K eagerly (the compute per chunk dwarfs the D2H);
        # short reads ship a small head + lazy tail
        head = K if cfg.use_gact else min(cfg.ops_head_cols, K)
        if cfg.tb_entry_bytes > 1 and not cfg.use_gact:
            # entries are one per M-run/indel (not one per 16-row word):
            # a typical read needs 1-2, a 15-indel read 31 — so the eager
            # head can be 4x smaller than the byte format's, cutting the
            # pass's D2H blob ~2x; rare indel-heavy chunks pay one lazy
            # tail fetch instead.  Default 16 B (8 entries).
            head = min(head, int(os.environ.get("LRM_OPS_HEAD", "16")))
            head -= head % cfg.tb_entry_bytes     # whole entries only
        meta_bytes = lax.bitcast_convert_type(meta, jnp.int8).reshape(
            B, 4 * cfg.meta_words)
        blob = jnp.concatenate([meta_bytes, compact[:, :head]], axis=1)
        return dict(blob=blob, ops_tail=compact[:, head:K])

    if not cfg.raw_input:
        return jax.jit(_body)

    @jax.jit
    def raw_step(idx: DeviceIndex, raw, lens, limits):
        u = raw | jnp.uint8(32)            # lowercase-fold ASCII letters
        codes = jnp.where(
            u == ord("a"), 0, jnp.where(
                u == ord("c"), 1, jnp.where(
                    u == ord("g"), 2, jnp.where(
                        u == ord("t"), 3, 4)))).astype(jnp.int8)
        comp = jnp.where(codes < 4, 3 - codes, codes)
        # full-row reverse puts the read at [L-L0, L); rolling left by
        # L - L0 front-aligns it and wraps the leading pad 4s to the tail
        codes_rc = jnp.roll(comp[:, ::-1],
                            jnp.max(lens) - np.int32(cfg.L), axis=1)
        return _body(idx, codes, codes_rc, lens, limits)

    return raw_step
