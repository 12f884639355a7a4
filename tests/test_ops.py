"""Property tests for the core device ops against pure-Python references."""

import numpy as np
import jax.numpy as jnp
import pytest

from longreadmapper_tpu.ops.vote import top2_votes, top2_small_histo
from longreadmapper_tpu.ops.wavefront import banded_nw_scores, banded_nw_ed, INF
from longreadmapper_tpu import native


def ref_histo_top2(keys):
    """Literal transcription of histo.c add/find_2_max semantics."""
    entries = []  # (bucket, key_min, count) in insertion order
    for key in keys:
        b = key >> 4
        found = False
        for e in entries:
            if e[0] == b:
                e[2] += 1
                e[1] = min(e[1], key)
                found = True
        if not found:
            entries.append([b, key, 1])
    store = [[0, 0, 0], [0, 0, 0]]  # (bucket, key, val) x2
    for e in entries:
        b, k, v = e
        if store[1][2] < v and store[0][2] < v:
            store[1] = store[0]
            store[0] = [b, k, v]
        elif store[1][2] < v and store[0][2] >= v:
            store[1] = [b, k, v]
    return store[0][2], store[0][1], store[1][2]  # v1, key1, v2


@pytest.mark.parametrize("seed", range(5))
def test_top2_votes_matches_reference_histo(seed):
    rng = np.random.default_rng(seed)
    B, V = 7, 64
    keys = rng.integers(-50, 200, (B, V)).astype(np.int64)
    valid = rng.random((B, V)) < 0.7
    v1, k1, v2 = top2_votes(jnp.asarray(keys), jnp.asarray(valid))
    for b in range(B):
        ks = [int(k) for k, ok in zip(keys[b], valid[b]) if ok]
        ev1, ek1, ev2 = ref_histo_top2(ks)
        assert (int(v1[b]), int(k1[b]), int(v2[b])) == (ev1, ek1, ev2), b


@pytest.mark.parametrize("seed", range(3))
def test_top2_small_histo_matches(seed):
    rng = np.random.default_rng(seed + 100)
    B, P = 5, 21
    keys = rng.integers(0, 120, (B, P)).astype(np.int64)
    valid = rng.random((B, P)) < 0.5
    v1, k1, v2 = top2_small_histo(jnp.asarray(keys), jnp.asarray(valid))
    for b in range(B):
        ks = [int(k) for k, ok in zip(keys[b], valid[b]) if ok]
        ev1, ek1, ev2 = ref_histo_top2(ks)
        assert (int(v1[b]), int(k1[b]), int(v2[b])) == (ev1, ek1, ev2), b


def full_nw(q, t):
    """Unbanded NW edit distance."""
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    H[0, :] = np.arange(m + 1)
    H[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            H[i, j] = min(H[i - 1, j - 1] + (q[i - 1] != t[j - 1]),
                          H[i - 1, j] + 1, H[i, j - 1] + 1)
    return H[n, m]


@pytest.mark.parametrize("seed", range(4))
def test_banded_nw_matches_full_nw(seed):
    rng = np.random.default_rng(seed)
    B, L, W = 4, 48, 12
    band = 2 * W + 1
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = q.copy()
    # inject < W edits per read so the band is sufficient
    for b in range(B):
        for _ in range(int(rng.integers(0, W // 2))):
            t[b, rng.integers(0, L)] = rng.integers(0, 4)
    lens = np.full(B, L, dtype=np.int32)
    ed, H = banded_nw_ed(jnp.asarray(q), jnp.asarray(t), jnp.asarray(lens), W, band)
    for b in range(B):
        assert int(ed[b]) == full_nw(q[b], t[b])


def test_banded_nw_variable_lengths():
    rng = np.random.default_rng(9)
    B, L, W = 3, 40, 8
    band = 2 * W + 1
    q = np.full((B, L), 4, dtype=np.int8)
    t = np.full((B, L), 5, dtype=np.int8)
    lens = np.array([40, 25, 10], dtype=np.int32)
    for b in range(B):
        x = rng.integers(0, 4, lens[b])
        q[b, :lens[b]] = x
        t[b, :lens[b]] = x
        t[b, 3] = (t[b, 3] + 1) % 4  # one mismatch
    ed, H = banded_nw_ed(jnp.asarray(q), jnp.asarray(t), jnp.asarray(lens), W, band)
    assert list(np.asarray(ed)) == [1, 1, 1]


def test_traceback_reconstructs_cigar():
    rng = np.random.default_rng(11)
    L, W = 60, 10
    band = 2 * W + 1
    q = rng.integers(0, 4, L).astype(np.uint8)
    # target: delete 2 bases, then append 2 (same length overall)
    t = np.concatenate([q[:20], q[22:], rng.integers(0, 4, 2)]).astype(np.uint8)
    lens = np.full(1, L, np.int32)
    ed, H = banded_nw_ed(jnp.asarray(q[None].astype(np.int8)),
                         jnp.asarray(t[None].astype(np.int8)),
                         jnp.asarray(lens), W, band)
    # H layout is (L+1, B, band); the host traceback wants (L+1, band)
    ops = native.traceback(np.asarray(H[:, 0, :]), W, q, t, L, L)
    assert ops is not None
    # CIGAR must consume exactly L query and L target
    qlen = sum(n for n, op in ops if op in "MI")
    tlen = sum(n for n, op in ops if op in "MD")
    assert qlen == L and tlen == L
    # op cost must equal edit distance within band
    ed_host, ops_host = native.banded_align(q, t, W)
    assert ed_host == int(ed[0])


def test_vertical_dirs_and_run_walk_match_reference_walk():
    """banded_nw_dirs_v + device_traceback_v must reproduce the per-cell
    walk's CIGAR exactly (same tie-break), run-encoded."""
    import jax.numpy as jnp
    from longreadmapper_tpu.ops.wavefront import (banded_nw_dirs,
                                                  banded_nw_dirs_v)
    from longreadmapper_tpu.ops.traceback import (device_traceback,
                                                  device_traceback_v)
    rng = np.random.default_rng(9)
    B, L, W, band = 16, 256, 32, 128
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 5, np.int8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(100, L - 4))
        ref = rng.integers(0, 4, L).astype(np.int8)
        qs = []
        i = 0
        while i < n:
            r = rng.random()
            if r < 0.01:
                i += 1
            elif r < 0.02:
                qs.append(int(rng.integers(0, 4)))
            else:
                c = int(ref[i])
                if rng.random() < 0.04:
                    c = (c + int(rng.integers(1, 4))) % 4
                qs.append(c)
                i += 1
        lens[b] = len(qs)
        q[b, :len(qs)] = qs
        t[b] = ref
    q, t, lens = jnp.asarray(q), jnp.asarray(t), jnp.asarray(lens)

    dirs, wcol = banded_nw_dirs(q, t, W, band)
    ops_ref = np.asarray(device_traceback(dirs, lens, L, W))
    vdirs, wcol_v = banded_nw_dirs_v(q, t, W, band)
    np.testing.assert_array_equal(np.asarray(wcol), np.asarray(wcol_v))
    runs = np.asarray(device_traceback_v(vdirs, lens, L, W))

    ed = np.asarray(wcol)[np.asarray(lens), np.arange(B)]
    for b in range(B):
        if ed[b] >= 0x3FFF or ed[b] > W:
            continue
        # expand reference ops (reverse order, pad-strip)
        ref_ops = ops_ref[b][ops_ref[b] != 3][::-1]
        # expand run bytes
        op = runs[b] & 3
        cnt = (runs[b] >> 2).astype(np.int64)
        keep = (op != 3) & (cnt > 0)
        expanded = np.repeat(op[keep][::-1], cnt[keep][::-1])
        np.testing.assert_array_equal(expanded, ref_ops, err_msg=f"read {b}")


@pytest.mark.parametrize("band", [128, 256, 1152, 2176])
def test_minplus_scan_lowerings_agree(band):
    """Both lowerings of the band DP's min-plus scan (cummin slope
    transform, doubling scan) equal the definition
    out[d] = min_{e<=d} x[e] + slope*(d - e) at the map step's band
    widths: 1 kb short band 256, 10 kb half/full bands 1152/2176."""
    from longreadmapper_tpu.ops.wavefront import (SCAN_LOWERINGS,
                                                  _minplus_scan)
    rng = np.random.default_rng(band)
    x = rng.integers(0, INF + 1, (3, band)).astype(np.int32)
    x[:, ::7] = INF                  # masked cells, as outside the domain
    d = np.arange(band)
    for slope in (1, 2):
        want = np.empty_like(x)
        for j in range(band):
            want[:, j] = np.min(x[:, :j + 1] + slope * (j - d[:j + 1]),
                                axis=1)
        for lowering in SCAN_LOWERINGS:
            got = np.asarray(_minplus_scan(jnp.asarray(x), band,
                                           slope=slope, lowering=lowering))
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{lowering} {slope}")


def test_slots_by_sort_matches_owns():
    """The sort-based slot assignment (long-read path) is bit-identical to
    the owns-matrix reduce (short-read path) for every slot field."""
    import jax.numpy as jnp
    from dataclasses import replace
    from longreadmapper_tpu.mapping.pipeline import (MapperConfig,
                                                     _slots_by_sort)

    rng = np.random.default_rng(3)
    BP, S, C = 12, 9, 32
    cfg = MapperConfig(B=1, L=128, seed_len=20, gap_len=1, thres=300,
                       hlen=6, n=1 << 20, dollar_pos=0, accept_score=0.6,
                       error_rate=0.05, vote_budget=C)
    assert cfg.vote_slots >= C

    for trial in range(8):
        cnt = rng.integers(0, 7, (BP, S)).astype(np.int32)
        cnt[rng.random((BP, S)) < 0.4] = 0
        k_seed = rng.integers(0, 1 << 20, (BP, S)).astype(np.int32)
        qw = rng.integers(0, 1 << 16, (BP, S)).astype(np.int32)
        j_ps = rng.integers(0, 100, (BP, S)).astype(np.int32)
        wide = rng.random((BP, S)) < 0.2

        C_ = cfg.vote_slots
        cum = np.cumsum(cnt, axis=1)
        total = cum[:, -1]
        starts = cum - cnt
        slots = np.arange(C_, dtype=np.int32)[None, None, :]
        owns = (starts[:, :, None] <= slots) & (slots < cum[:, :, None])
        o32 = owns.astype(np.int32)
        p_rank = (o32 * (k_seed - starts)[:, :, None]).sum(1) + slots[0, 0]
        qw_slot = (o32 * qw[:, :, None]).sum(1)
        wide_slot = (o32 * wide.astype(np.int32)[:, :, None]).sum(1) > 0
        j_slot = (o32 * (j_ps + 1)[:, :, None]).sum(1) - 1

        pr, qs, ws, js, tot, ex = _slots_by_sort(
            cfg, jnp.asarray(cnt), jnp.asarray(k_seed), jnp.asarray(qw),
            jnp.asarray(j_ps), jnp.asarray(wide),
            extras=(jnp.asarray(cnt),))
        valid = j_slot >= 0
        np.testing.assert_array_equal(np.asarray(js), j_slot)
        np.testing.assert_array_equal(np.asarray(tot), total)
        np.testing.assert_array_equal(np.asarray(ws), wide_slot)
        np.testing.assert_array_equal(np.asarray(pr)[valid], p_rank[valid])
        np.testing.assert_array_equal(np.asarray(qs)[valid], qw_slot[valid])
        # extras forward like qw: the owning seed's value on valid slots
        cnt_slot = (o32 * cnt[:, :, None]).sum(1)
        np.testing.assert_array_equal(np.asarray(ex[0])[valid],
                                      cnt_slot[valid])
