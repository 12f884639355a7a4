"""Aligner-family tests: the SSW-equivalent affine-gap scorer and the
edlib-equivalent Myers distance, cross-checked three ways (device op == native
C++ == brute-force numpy) — re-creating the reference's per-library test
drivers (ssw/ssw_test.c, edlib/ed_test.c) as property tests."""

import numpy as np
import pytest

from longreadmapper_tpu import native

MATCH, MISMATCH, OPEN, EXT = 2, -2, 3, 1   # ssw_use.c:27-54


def brute_affine_best(q, t):
    """Unbanded affine SW best score (numpy reference)."""
    m, n = len(q), len(t)
    NEG = -(1 << 28)
    H = np.zeros((m + 1, n + 1), np.int32)
    E = np.full((m + 1, n + 1), NEG, np.int32)
    F = np.full((m + 1, n + 1), NEG, np.int32)
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i, j] = max(H[i, j - 1] - OPEN - EXT, E[i, j - 1] - EXT)
            F[i, j] = max(H[i - 1, j] - OPEN - EXT, F[i - 1, j] - EXT)
            s = (MATCH if q[i - 1] == t[j - 1] else MISMATCH) \
                if q[i - 1] < 4 and t[j - 1] < 4 else 0
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            best = max(best, int(H[i, j]))
    return best


def brute_edit(q, t, mode):
    m, n = len(q), len(t)
    D = np.zeros((m + 1, n + 1), np.int64)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = 0 if mode == "HW" else np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = 0 if (q[i - 1] < 4 and q[i - 1] == t[j - 1]) else 1
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                          D[i - 1, j - 1] + s)
    if mode == "NW":
        return int(D[m, n])
    return int(D[m].min())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_native_matches_brute(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(20, 60))
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = q.copy()
    for _ in range(3):
        p = int(rng.integers(0, m))
        t[p] = (t[p] + 1) % 4
    W = 16
    score, span, ops = native.affine_align(q, t, W)
    assert score == brute_affine_best(q, t)
    # CIGAR consistency: ops consume exactly the reported spans
    qc = sum(c for c, op in ops if op in "MI")
    tc = sum(c for c, op in ops if op in "MD")
    assert qc == span[1] - span[0]
    assert tc == span[3] - span[2]


def test_affine_with_indel():
    rng = np.random.default_rng(7)
    q = rng.integers(0, 4, 50).astype(np.uint8)
    t = np.concatenate([q[:20], q[23:]]).astype(np.uint8)  # 3-base deletion
    score, span, ops = native.affine_align(q, t, 16)
    assert score == brute_affine_best(q, t)
    assert any(op == "I" and c == 3 for c, op in ops)


def test_affine_no_positive_score():
    q = np.zeros(10, np.uint8)          # AAAA...
    t = np.full(10, 3, np.uint8)        # TTTT...
    score, span, ops = native.affine_align(q, t, 8)
    assert score == 0 and span is None


def test_affine_device_matches_native():
    from longreadmapper_tpu.ops.affine import banded_sw_affine
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    B, L, W = 8, 64, 16
    band = 128
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = np.empty_like(q)
    for b in range(B):
        t[b] = q[b]
        for _ in range(4):
            p = int(rng.integers(0, L))
            t[b, p] = (t[b, p] + int(rng.integers(1, 4))) % 4
    sc, ei, ej = banded_sw_affine(jnp.asarray(q), jnp.asarray(t), W, band)
    for b in range(B):
        ns, span, _ = native.affine_align(q[b].astype(np.uint8),
                                          t[b].astype(np.uint8), W)
        assert int(sc[b]) == ns, b
        if ns > 0:
            assert int(ei[b]) == span[1], b
            assert int(ej[b]) == span[3], b


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("seed", [0, 5])
def test_myers_matches_brute(mode, seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(3, 200))       # crosses the 64-bit block boundary
    n = int(rng.integers(3, 260))
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = rng.integers(0, 4, n).astype(np.uint8)
    d, _ = native.myers_distance(q, t, mode)
    assert d == brute_edit(q, t, mode)


def test_myers_infix_location():
    rng = np.random.default_rng(11)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    q = t[100:180].copy()
    q[10] = (q[10] + 1) % 4
    d, end = native.myers_distance(q, t, "HW")
    assert d == 1
    assert end == 180


def test_myers_matches_banded_align_nw():
    rng = np.random.default_rng(13)
    q = rng.integers(0, 4, 120).astype(np.uint8)
    t = q.copy()
    t[40] = (t[40] + 1) % 4
    t = np.concatenate([t[:70], t[72:]]).astype(np.uint8)
    d, _ = native.myers_distance(q, t, "NW")
    ed, _ = native.banded_align(q, t, 16)
    assert d == ed == 3  # 1 sub + 2-base gap


def _brute_infix(q, t):
    """O(mn) HW-mode DP: (distance, best end) with free target prefix/suffix."""
    m, n = len(q), len(t)
    prev = np.arange(m + 1)
    prev[:] = np.arange(m + 1)
    best, pos = prev[m], 0
    for j in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = 0
        sub = (q != t[j - 1]) | (q >= 4)
        for i in range(1, m + 1):
            cur[i] = min(prev[i] + 1, cur[i - 1] + 1,
                         prev[i - 1] + int(sub[i - 1]))
        prev = cur
        if cur[m] < best:
            best, pos = cur[m], j
    return int(best), int(pos)


def _apply_ops(q, t_win, ops):
    """Walk run-length ops; returns (edits, q_consumed, t_consumed)."""
    qi = ti = edits = 0
    for ln, op in ops:
        if op == "M":
            edits += int(np.sum(q[qi:qi + ln] != t_win[ti:ti + ln]))
            qi += ln
            ti += ln
        elif op == "I":
            qi += ln
            edits += ln
        elif op == "D":
            ti += ln
            edits += ln
    return edits, qi, ti


@pytest.mark.parametrize("seed", range(8))
def test_myers_align_hw_path(seed):
    """edlib HW TASK_PATH equivalent: distance == brute infix DP, and the
    returned window+ops form a valid optimal alignment (edlib.h:225,249)."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(8, 40))
    n = int(rng.integers(m, 160))
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = rng.integers(0, 4, n).astype(np.uint8)
    ed, start, end, ops = native.myers_align(q, t, "HW")
    want, _ = _brute_infix(q, t)
    assert ed == want
    edits, qc, tc = _apply_ops(q, t[start:end], ops)
    assert qc == m and tc == end - start
    assert edits == ed


def test_myers_align_hw_planted():
    """A planted infix (with 1 sub + 1 del) is located and pathed."""
    rng = np.random.default_rng(99)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    q = t[100:160].copy()
    q[10] = (q[10] + 1) % 4
    q = np.concatenate([q[:30], q[31:]]).astype(np.uint8)  # delete 1 base
    ed, start, end, ops = native.myers_align(q, t, "HW")
    assert ed == 2
    assert start == 100 and end == 160
    edits, qc, tc = _apply_ops(q, t[start:end], ops)
    assert (edits, qc, tc) == (2, len(q), 60)


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("seed", range(6))
def test_myers_k_bounded(mode, seed):
    """k-bounded search (edlib.h:225's k): exact distance when d <= k,
    (-1, 0) when d > k, across the band/early-abort block machinery."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(3, 200))
    n = int(rng.integers(3, 260))
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = rng.integers(0, 4, n).astype(np.uint8)
    d, pos = native.myers_distance(q, t, mode)
    for k in (0, 1, d - 1, d, d + 1, d + 17):
        if k < 0:
            continue
        dk, pk = native.myers_distance(q, t, mode, k=k)
        if d <= k:
            assert (dk, pk) == (d, pos), (mode, k)
        else:
            assert (dk, pk) == (-1, 0), (mode, k)


def test_myers_k_bounded_planted_long():
    """Long query, small k: the banded path must still find a planted
    low-distance infix exactly (blocks outside i <= j + k are skipped)."""
    rng = np.random.default_rng(21)
    t = rng.integers(0, 4, 4000).astype(np.uint8)
    q = t[1000:1800].copy()          # 800 bases -> 13 blocks
    q[100] = (q[100] + 1) % 4
    q[500] = (q[500] + 1) % 4
    d, end = native.myers_distance(q, t, "HW", k=5)
    assert (d, end) == (2, 1800)
    assert native.myers_distance(q, t, "HW", k=1) == (-1, 0)
    # NW over the exact window
    d2, _ = native.myers_distance(q, t[1000:1800], "NW", k=4)
    assert d2 == 2


@pytest.mark.parametrize("seed", range(4))
def test_myers_align_extended_cigar(seed):
    """extended=True ('='/'X' runs, EDLIB_CIGAR_EXTENDED edlib.h:249):
    same path as 'M' ops, '='-runs match exactly, 'X'-runs mismatch."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(20, 80))
    n = int(rng.integers(m, 200))
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = rng.integers(0, 4, n).astype(np.uint8)
    ed, start, end, ops = native.myers_align(q, t, "HW")
    ed2, s2, e2, xops = native.myers_align(q, t, "HW", extended=True)
    assert (ed2, s2, e2) == (ed, start, end)
    assert all(op in "=XID" for _, op in xops)
    # collapsing =/X back to M reproduces the plain ops
    coll = []
    for ln, op in xops:
        op = "M" if op in "=X" else op
        if coll and coll[-1][1] == op:
            coll[-1] = (coll[-1][0] + ln, op)
        else:
            coll.append((ln, op))
    assert coll == ops
    qi, ti = 0, start
    n_x = 0
    for ln, op in xops:
        if op == "=":
            assert np.all(q[qi:qi + ln] == t[ti:ti + ln])
            qi, ti = qi + ln, ti + ln
        elif op == "X":
            assert np.all(q[qi:qi + ln] != t[ti:ti + ln])
            n_x += ln
            qi, ti = qi + ln, ti + ln
        elif op == "I":
            qi += ln
        else:
            ti += ln
    assert qi == m and ti == end
    n_id = sum(ln for ln, op in xops if op in "ID")
    assert n_x + n_id == ed  # unit costs: edits = X + I + D


def test_myers_align_k_bounded():
    rng = np.random.default_rng(31)
    t = rng.integers(0, 4, 500).astype(np.uint8)
    q = t[50:150].copy()
    q[10] = (q[10] + 1) % 4
    assert native.myers_align(q, t, "HW", k=0) == (-1, 0, 0, [])
    ed, start, end, ops = native.myers_align(q, t, "HW", k=1)
    assert (ed, start, end) == (1, 50, 150)


def test_myers_empty_target():
    """n == 0 regression (round-3 review): every mode returns m (all
    insertions), matching the numpy fallback, and k-bounds apply."""
    q = np.array([0, 1, 2], np.uint8)
    t = np.zeros(0, np.uint8)
    for mode in ("NW", "SHW", "HW"):
        assert native.myers_distance(q, t, mode) == (3, 0 if mode != "NW" else 0)
        assert native.myers_distance(q, t, mode, k=5) == (3, 0)
        assert native.myers_distance(q, t, mode, k=2) == (-1, 0)
        assert native._myers_py(q, t, {"NW": 0, "SHW": 1, "HW": 2}[mode]) \
            == (3, 0)
