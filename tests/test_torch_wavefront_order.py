"""The order of operations of the kernels' CTA route (M >= 33), emulated in
plain torch thread by thread, against the plain versions bit for bit.

``csrc/smallchol.cu`` factors each matrix with right-looking wavefronts
(``cta_cholesky``, ``cta_invert_lower``), forms S⁻¹'s entries in 4 × 4
register tiles (``cta_inverse_entries``), stages the trace product's blocks
several at a time (``stage_blocks``) and forms the edge update's Wcᵀ = Uᵀ·A
in tiles staged chunk by chunk (``edge_product_kernel``).  No CUDA runs on
this CPU, so each device function is transliterated here: each thread of
a group runs its loop in turn between two barriers, over entries that are
(batch,) tensors, with the device code's index walks, and the packed
workspace checks that no entry is written by two threads, or written by one
and read by another, between two barriers.  The results must equal
``ops/smallchol``'s ``_cholesky``, ``_invert_lower``, ``_inverse_entry``,
``spd_trace_product_packed`` and ``small_mm`` to the last bit (NaN where
they have NaN), at M = 33 and 48 in float32 and float64, on random SPD
matrices and on matrices whose last pivot is clamped."""

import collections

import numpy as np
import pytest
import torch

from ipp_rl_tpu_torch.ops import smallchol

from test_torch_zero_search import one_thread  # noqa: F401,E402 (an autouse fixture)

WAVEFRONT_M = [33, 48]
DTYPES = [torch.float32, torch.float64]
ENTRY_TILE = 4
TILE = 4  # kTile
MAX_REGISTER_M = 176  # kMaxRegisterM: past it the shared-memory forms factor
CTA_THREADS = 1024  # kCtaThreads


def tri(i):
    return i * (i + 1) // 2


def packed_row(q):
    """The device's row of packed entry q: a float32 estimate, corrected."""
    i = int((np.sqrt(np.float32(8 * q + 1), dtype=np.float32) - np.float32(1)) * np.float32(0.5))
    while tri(i + 1) <= q:
        i += 1
    while tri(i) > q:
        i -= 1
    return i


class Shared:
    """A workspace of entries, each a (batch,) tensor, that checks each
    interval between two barriers: no entry is written by two threads, or
    written by one and read by another (a race on the card)."""

    def __init__(self, n, fill=None):
        self.v = [fill] * n  # fill: what an entry never written holds (a buffer's garbage)
        self.sync()

    def sync(self, lanes=None):
        """A barrier; with ``lanes``, a __syncwarp: what those lanes did is
        ordered among them from here on, and still not with other threads."""
        if lanes is None:
            self.writer, self.readers = {}, collections.defaultdict(set)
            return
        warp = frozenset(lanes)
        for e, w in self.writer.items():
            if w in warp:
                self.writer[e] = warp
        for e, r in self.readers.items():
            self.readers[e] = {warp if x in warp else x for x in r}

    @staticmethod
    def _mine(record, tid):
        return record == tid or (isinstance(record, frozenset) and tid in record)

    def get(self, e, tid):
        w = self.writer.get(e)
        assert w is None or self._mine(w, tid), f"thread {tid} reads entry {e} written by another"
        assert self.v[e] is not None, f"entry {e} read before it was written"
        self.readers[e].add(tid)
        return self.v[e]

    def set(self, e, tid, x):
        w = self.writer.get(e)
        assert w is None or self._mine(w, tid), f"entry {e} written by two threads"
        assert all(self._mine(r, tid) for r in self.readers.get(e, ())), \
            f"entry {e} written while another thread reads it"
        self.writer[e] = tid
        self.v[e] = x


def barrier(*spaces):
    for s in spaces:
        s.sync()


def clamp_pivot(x):
    return torch.clamp(x, min=smallchol.PIVOT_FLOOR)


def cta_cholesky_shared(X, C, m, size):
    """csrc/smallchol.cu: cta_cholesky_shared, X packed in place, C two columns."""
    lanes = set(range(min(32, size)))
    for tid in sorted(lanes):
        d = smallchol._sqrt(clamp_pivot(X.get(0, tid)))
        inv_d = 1.0 / d
        for i in range(1 + tid, m, 32):
            v = X.get(tri(i), tid) * inv_d
            X.set(tri(i), tid, v)
            C.set(i, tid, v)
        if tid == 0:
            first = d
    X.sync(lanes)
    X.set(0, 0, first)
    C.set(0, 0, first)
    barrier(X, C)
    for k in range(m - 1):
        c = k % 2 * m  # L[.][k] at C[c + .]
        j1 = k + 1
        nxt = j1 % 2 * m
        pivots = {}
        for tid in sorted(lanes):  # the first warp: column k + 1
            lk = C.get(c + j1, tid)
            d = smallchol._sqrt(clamp_pivot(X.get(tri(j1) + j1, tid) - lk * lk))
            inv_d = 1.0 / d
            for i in range(j1 + 1 + tid, m, 32):
                p = tri(i) + j1
                v = (X.get(p, tid) - C.get(c + i, tid) * lk) * inv_d
                X.set(p, tid, v)
                C.set(nxt + i, tid, v)
            pivots[tid] = d
        X.sync(lanes)
        X.set(tri(j1) + j1, 0, pivots[0])
        C.set(nxt + j1, 0, pivots[0])
        base = k + 2
        cnt = tri(m - base) if base < m else 0
        for tid in range(min(size, cnt)):  # term k of the trailing triangle
            r = packed_row(tid)
            rs = tri(r)
            for q in range(tid, cnt, size):
                while q >= rs + r + 1:
                    rs += r + 1
                    r += 1
                i, j = base + r, base + q - rs
                p = tri(i) + j
                X.set(p, tid, X.get(p, tid) - C.get(c + i, tid) * C.get(c + j, tid))
        barrier(X, C)


def cta_invert_lower_shared(X, Y, C, m, size):
    """csrc/smallchol.cu: cta_invert_lower_shared, L in X, Li into Y (packed)."""
    Y.set(0, 0, 1.0 / X.get(0, 0))
    barrier(X, Y)
    for k in range(m - 1):
        w = k + 1
        cnt = (m - w) * w
        row_k = tri(k)
        for tid in range(size):
            dn = X.get(tri(w) + w, tid)
            if tid == 0:
                Y.set(tri(w) + w, 0, 1.0 / dn)
            if tid >= cnt:
                continue
            dr, dc = size // w, size % w
            r, col = tid // w, tid % w
            for q in range(tid, cnt, size):
                row = tri(w + r)
                t = X.get(row + k, tid) * Y.get(row_k + col, tid)
                v = t if col == k else Y.get(row + col, tid) + t
                if r == 0:
                    v = -v / dn
                Y.set(row + col, tid, v)
                r, col = r + dr, col + dc
                if col >= w:
                    col -= w
                    r += 1
        barrier(X, Y)


def cta_threads(m):
    """csrc/smallchol.cu: cta_threads."""
    nt = -(-m // TILE)
    need = tri(nt) if m <= MAX_REGISTER_M else m
    return min(CTA_THREADS, -(-need // 32) * 32)


def padded4(m):
    return -(-m // 4) * 4


def tile_by_trailing(m, tid):
    """csrc/smallchol.cu: tile_by_trailing, (i0, j0) or None."""
    nt = -(-m // TILE)
    if tid >= tri(nt):
        return None
    r = packed_row(tid)
    return (nt - 1 - (tid - tri(r))) * TILE, (nt - 1 - r) * TILE


def load_tile(X, m, tid, i0, j0, fill):
    return [[X.get(tri(i0 + r) + j0 + c, tid) if i0 + r < m and j0 + c <= i0 + r else fill
             for c in range(TILE)] for r in range(TILE)]


def store_tile(X, m, tid, i0, j0, acc):
    for r in range(TILE):
        for c in range(TILE):
            if i0 + r < m and j0 + c <= i0 + r:
                X.set(tri(i0 + r) + j0 + c, tid, acc[r][c])


def tile_by_columns(m, tid):
    """csrc/smallchol.cu: tile_by_columns, (i0, j0) or None."""
    nt = -(-m // TILE)
    if tid >= tri(nt):
        return None
    q, tj = tid, 0
    while q >= nt - tj:
        q -= nt - tj
        tj += 1
    return (nt - 1 - q) * TILE, tj * TILE


def cta_cholesky_tiles(X, C, m, size):
    """csrc/smallchol.cu: cta_cholesky_tiles: one register tile per thread,
    C two columns then two pivot reciprocals."""
    mp = padded4(m)
    inv = 2 * mp
    zero = torch.zeros_like(X.v[0])
    tiles = {tid: tile_by_trailing(m, tid) for tid in range(size) if tile_by_trailing(m, tid)}
    acc = {tid: load_tile(X, m, tid, i0, j0, zero) for tid, (i0, j0) in tiles.items()}
    for tid, (i0, j0) in tiles.items():
        if j0 == 0:
            for r in range(TILE):
                i = i0 + r
                if i == 0:
                    d = smallchol._sqrt(clamp_pivot(acc[tid][r][0]))
                    C.set(inv, tid, 1.0 / d)
                    acc[tid][r][0] = d
                elif i < m:
                    C.set(i, tid, acc[tid][r][0])
    barrier(X, C)
    for k in range(m - 1):
        ck, cn = k % 2 * mp, (k + 1) % 2 * mp
        for tid, (i0, j0) in tiles.items():
            if j0 + TILE - 1 < k or i0 + TILE - 1 <= k:
                continue
            t = acc[tid]
            inv_k = C.get(inv + k % 2, tid)
            a = [C.get(ck + i0 + r, tid) * inv_k for r in range(TILE)]
            b = [C.get(ck + j0 + c, tid) * inv_k for c in range(TILE)]
            for r in range(TILE):
                for c in range(TILE):
                    if j0 + c == k:
                        if i0 + r > k:
                            t[r][c] = t[r][c] * inv_k
                    elif j0 + c > k:
                        t[r][c] = t[r][c] - a[r] * b[c]
            if j0 <= k + 1 <= j0 + TILE - 1:
                c = k + 1 - j0
                for r in range(TILE):
                    i = i0 + r
                    if i == k + 1:
                        d = smallchol._sqrt(clamp_pivot(t[r][c]))
                        C.set(inv + (k + 1) % 2, tid, 1.0 / d)
                        t[r][c] = d
                    elif k + 1 < i < m:
                        C.set(cn + i, tid, t[r][c])
        barrier(X, C)
    for tid, (i0, j0) in tiles.items():
        store_tile(X, m, tid, i0, j0, acc[tid])
    barrier(X, C)


def cta_invert_lower_tiles(X, Y, C, m, size):
    """csrc/smallchol.cu: cta_invert_lower_tiles, C two rows of Li."""
    mp = padded4(m)
    neg_zero = torch.full_like(X.v[0], -0.0)
    tiles = {tid: tile_by_columns(m, tid) for tid in range(size) if tile_by_columns(m, tid)}
    acc = {tid: [[neg_zero] * TILE for _ in range(TILE)] for tid in tiles}
    for tid, (i0, j0) in tiles.items():
        if i0 == 0:
            acc[tid][0][0] = 1.0 / X.get(0, tid)
            C.set(0, tid, acc[tid][0][0])
    barrier(X, Y, C)
    for k in range(m - 1):
        rk, rn = k % 2 * mp, (k + 1) % 2 * mp
        for tid, (i0, j0) in tiles.items():
            if i0 + TILE - 1 <= k or j0 > k + 1:
                continue
            t = acc[tid]
            a = [X.get(tri(min(i0 + r, m - 1)) + k, tid) for r in range(TILE)]
            b = [C.get(rk + j0 + c, tid) for c in range(TILE)]
            dn = X.get(tri(k + 1) + k + 1, tid)
            for r in range(TILE):
                i = i0 + r
                for c in range(TILE):
                    j = j0 + c
                    if i > k and j <= k:
                        t[r][c] = t[r][c] + a[r] * b[c]
                    if i == k + 1 and j <= k + 1:
                        t[r][c] = -t[r][c] / dn if j <= k else 1.0 / dn
                        C.set(rn + j, tid, t[r][c])
        barrier(X, Y, C)
    for tid, (i0, j0) in tiles.items():
        store_tile(Y, m, tid, i0, j0, acc[tid])
    barrier(X, Y, C)


FORMS = {"tiles": (cta_cholesky_tiles, cta_invert_lower_tiles),
         "shared": (cta_cholesky_shared, cta_invert_lower_shared)}


def cta_inverse_entries(Y, m, size, f):
    """csrc/smallchol.cu: cta_inverse_entries, f(tid, i, j, S⁻¹[i][j])."""
    R = ENTRY_TILE
    nt = -(-m // R)
    zero = torch.full_like(Y.v[0], -0.0)
    for tid in range(size):
        for q in range(tid, tri(nt), size):
            ti = packed_row(q)
            i0, j0 = ti * R, (q - tri(ti)) * R
            ci = [min(i0 + r, m - 1) for r in range(R)]
            acc = [[zero] * R for _ in range(R)]
            for k in range(i0, m):
                row = tri(k)
                peel = k < i0 + R
                a = [Y.get(row + (min(ci[r], k) if peel else ci[r]), tid) for r in range(R)]
                b = [Y.get(row + (min(j0 + c, k) if peel else j0 + c), tid) for c in range(R)]
                for r in range(R):
                    if k >= i0 + r:
                        for c in range(R):
                            acc[r][c] = acc[r][c] + a[r] * b[c]
            for r in range(R):
                for c in range(R):
                    if i0 + r < m and j0 + c <= i0 + r:
                        f(tid, i0 + r, j0 + c, acc[r][c])


def workspace(S_lower, m):
    """X holding the lower triangle of the batch's matrices, packed, and
    the empty C (two columns and two pivot reciprocals, garbage where
    nothing was written) and Y."""
    garbage = torch.full_like(S_lower(0, 0), float("nan"))
    columns = -(-(2 * padded4(m) + 2) // 32) * 32  # cta_columns_elems
    X, C, Y = Shared(tri(m)), Shared(columns, garbage), Shared(tri(m))
    for i in range(m):
        for j in range(i + 1):
            X.set(tri(i) + j, 0, S_lower(i, j))
    barrier(X)
    return X, C, Y


def random_spd(rng, batch, m, dtype, clamp):
    A = rng.normal(size=(batch, m, m))
    S = A @ np.swapaxes(A, -1, -2) / m + 0.5 * np.eye(m)
    if clamp:  # the last pivot goes negative: clamped, and its factor overflows
        S[0, -1, -1] -= 2.0 * np.trace(S[0])
    return torch.from_numpy(S).to(dtype)


def bits_equal(got, want):
    """The same bits, or NaN in both (a NaN's payload aside)."""
    itype = torch.int32 if got.dtype == torch.float32 else torch.int64
    same = got.view(itype) == want.view(itype)
    return bool((same | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.parametrize("clamp", [False, True], ids=["spd", "clamped"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("m,form", [(33, "tiles"), (48, "tiles"), (33, "shared")])
def test_wavefront_factorisations_are_the_plain_order(m, form, dtype, clamp):
    """cta_cholesky and cta_invert_lower in both forms (register tiles, as
    these M run on the card, with cta_threads(M) threads; the shared-memory
    form of M past MAX_REGISTER_M with one warp, so every loop strides) and
    cta_inverse_entries against _cholesky, _invert_lower and
    _inverse_entry, every entry's bits."""
    size = cta_threads(m) if form == "tiles" else 32
    cholesky, invert_lower = FORMS[form]
    S = random_spd(np.random.default_rng(m + size + clamp), 3, m, dtype, clamp)
    L = smallchol.cholesky_ll(S)
    Li = smallchol._invert_lower(L, m)
    X, C, Y = workspace(lambda i, j: S[:, i, j], m)
    cholesky(X, C, m, size)
    for i in range(m):
        for j in range(i + 1):
            assert bits_equal(X.v[tri(i) + j], L[i][j]), ("L", i, j)
    invert_lower(X, Y, C, m, size)
    for i in range(m):
        for j in range(i + 1):
            assert bits_equal(Y.v[tri(i) + j], Li[i][j]), ("Li", i, j)
    seen = set()

    def check(tid, i, j, v):
        assert (i, j) not in seen
        seen.add((i, j))
        assert bits_equal(v, smallchol._inverse_entry(Li, m, i, j)), ("S^-1", i, j)

    cta_inverse_entries(Y, m, size, check)
    assert len(seen) == tri(m)


def stage_blocks(src, slots, live, t0, inner, m, tps):
    """csrc/smallchol.cu: stage_blocks: {(slot, e): flat index of src} of
    one CTA of slots x tps threads, each (slot, e) staged once."""
    kT = tri(m)
    staged = {}
    for thread in range(slots * tps):
        if inner >= slots:
            s, e, de = thread & (slots - 1), thread // slots, slots * tps // slots
        else:
            s, e, de = thread // tps, thread % tps, tps
        if s >= live:
            continue
        t = t0 + s
        o = t // inner
        base = o * kT * inner + (t - o * inner)
        for e in range(e, kT, de):
            assert (s, e) not in staged
            staged[(s, e)] = src[base + e * inner]
    assert len(staged) == kT * live
    return staged


@pytest.mark.parametrize("outer,inner,slots", [(2, 3, 4), (1, 7, 8), (3, 1, 2), (2, 16, 8)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_trace_product_slots_are_the_plain_order(dtype, outer, inner, slots):
    """The trace product's CTA (spd_trace_product_cta_kernel) at M = 33 over
    a ragged tail of blocks, one clamped: its staging, the slots'
    factorisations, the terms over G and each slot's serial sum, bitwise
    against spd_trace_product_packed."""
    m = 33
    size = cta_threads(m)
    n = outer * inner
    rng = np.random.default_rng(n + slots)
    S_full, G_full = random_spd(rng, n, m, dtype, True), random_spd(rng, n, m, dtype, False)

    def pack(F):
        return smallchol.pack_lower(F).view(outer, inner, tri(m)).transpose(1, 2).contiguous()

    Sp, Gp = pack(S_full), pack(G_full)
    want = smallchol.spd_trace_product_packed(Sp, Gp).reshape(-1)
    s_of, g_of = {}, {}  # (block, e) -> the staged entry, CTA by CTA
    for t0 in range(0, n, slots):
        live = min(slots, n - t0)
        for src, staged in ((Sp, s_of), (Gp, g_of)):
            for (s, e), v in stage_blocks(src.reshape(-1), slots, live, t0, inner, m,
                                          size).items():
                staged[(t0 + s, e)] = v
    # every slot runs the same operations on its block: one batch of all n
    X, C, Y = workspace(lambda i, j: torch.stack([s_of[(t, tri(i) + j)] for t in range(n)]), m)
    cta_cholesky_tiles(X, C, m, size)
    cta_invert_lower_tiles(X, Y, C, m, size)
    for e in range(tri(m)):
        X.v[e] = torch.stack([g_of[(t, e)] for t in range(n)])
    barrier(X, C, Y)

    def term(tid, i, j, v):
        e = tri(i) + j
        t = v * X.get(e, tid)
        if i != j:
            t = t + t
        X.set(e, tid, t)

    cta_inverse_entries(Y, m, size, term)
    total = X.v[0]  # thread s's serial sum of slot s's terms
    for e in range(1, tri(m)):
        total = total + X.v[e]
    assert bits_equal(total, want)


def edge_product(U, A, TM, mask=None):
    """csrc/smallchol.cu: edge_product_kernel and edge_gain_kernel: Wcᵀ = Uᵀ·A
    by column tiles of 64 and passes of 16·TM rows, U's rows (padded to the
    pass, zeros in the padding) and A's rows staged in chunks of 16 with
    the kernel's copy indices; each thread's TM × 4 tile summed over k in
    order from -0; then the squares by column in row order, the mask, and
    the warp's order of the gain."""
    B, m, n = A.shape
    rows, cols, kchunk = 16 * TM, 64, 16
    ldu = -(-m // rows) * rows
    u = torch.zeros((B, m, ldu), dtype=U.dtype)
    u[:, :, :m] = U
    WcT = torch.full_like(A, float("nan"))
    sq = torch.full((B, n), float("nan"), dtype=A.dtype)
    for n0 in range(0, n, cols):
        col_sq = torch.full((B, cols), -0.0, dtype=A.dtype)
        for r0 in range(0, m, rows):
            acc = torch.full((B, rows, cols), -0.0, dtype=A.dtype)
            for kc in range(0, m, kchunk):
                kr = min(kchunk, m - kc)
                us = torch.full((B, kchunk, rows), float("nan"), dtype=A.dtype)
                as_ = torch.full((B, kchunk, cols), float("nan"), dtype=A.dtype)
                for v in range(kr * rows):
                    kk, c = divmod(v, rows)
                    us[:, kk, c] = u[:, kc + kk, r0 + c]
                for v in range(kr * cols):
                    kk, c = divmod(v, cols)
                    if n0 + c < n:
                        as_[:, kk, c] = A[:, kc + kk, n0 + c]
                for kk in range(kr):
                    acc = acc + us[:, kk, :, None] * as_[:, kk, None, :]
            rend, cend = min(rows, m - r0), min(cols, n - n0)
            WcT[:, r0:r0 + rend, n0:n0 + cend] = acc[:, :rend, :cend]
            for r in range(rend):
                col_sq = col_sq + acc[:, r] * acc[:, r]
        cend = min(cols, n - n0)
        part = col_sq[:, :cend]
        if mask is not None:
            part = part * mask[..., n0:n0 + cend]
        sq[:, n0:n0 + cend] = part
    return WcT, smallchol.warp_order_sum(sq)


@pytest.mark.parametrize("TM", [2, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("m", WAVEFRONT_M)
def test_tiled_product_is_the_small_mm_order(m, dtype, TM):
    """N = 37 (a ragged column tile of 64) and passes of 32 rows (dividing
    neither M) or one of 128: Wcᵀ bitwise small_mm(Uᵀ, A), the gain bitwise
    the plain edge_factor_gain's squares, mask and warp order."""
    rng = np.random.default_rng(m + TM)
    B, n = 2, 37
    U = torch.from_numpy(np.tril(rng.normal(size=(B, m, m)))).to(dtype)
    A = torch.from_numpy(rng.normal(size=(B, m, n))).to(dtype)
    mask = torch.from_numpy((rng.random((B, n)) > 0.4).astype(np.float64)).to(dtype)
    WcT, gain = edge_product(U, A, TM, mask)
    want = smallchol.small_mm(U.mT, A)
    assert bits_equal(WcT, want)
    sq = None
    for r in range(m):
        t = want[:, r] * want[:, r]
        sq = t if sq is None else sq + t
    assert bits_equal(gain, smallchol.warp_order_sum(sq * mask))
