"""The order of operations of the unrolled kernels of the warp route
(M = 13..32), emulated in plain torch, against the plain versions bit for
bit.

``csrc/smallchol.cu`` runs ``spd_trace_product`` there with one lane per
block (``spd_trace_product_lanes_kernel``): each lane stages its block's
packed triangle into shared memory, interleaved by lane (entry e of lane l
at e * 32 + l), factors it in place two rows at a time, overwrites L with
L⁻¹ two columns at a time, writes each entry's term over L⁻¹ two columns
at a time, and adds the terms in packed order.
``spd_inverse`` runs with one warp per matrix (``spd_inverse_rows_kernel``):
lane i keeps row i of L in registers, lane c column c of L⁻¹, and reads
another lane's row or column from a shared copy by 16-byte broadcast
loads (the pivot by shuffle); ``factor_rows_kernel`` follows it with a
second such Cholesky on S⁻¹, for ``spd_inverse_factor`` and for
``edge_factor_gain``'s factor, which forms S = 0.5 (S_raw + S_rawᵀ) +
diag(R[a]) as its first Cholesky reads the staged S_raw and stores Uᵀ to
rows of 32; ``edge_columns_kernel`` then multiplies it with A, a thread
per column, and sums the gain in the warp order.  No CUDA
runs on this CPU, so both are transliterated here with the device code's
loops, guards, shared-memory addresses and shuffle sources, a warp's 32
lanes at once (every lane runs the same instructions).  The emulated
shared memory records what each entry holds and checks that every read
finds what the kernel means to read there: nothing is read after it is
overwritten.  The results must equal ``ops/smallchol``'s
``spd_trace_product_packed``, ``spd_inverse``, ``spd_inverse_factor`` and
``edge_factor_gain`` to the last bit (NaN where they have NaN), at M = 13,
25 and 32 in float32 and float64, on random SPD matrices, on matrices whose
last pivot is clamped, on block-diagonal ones whose L and L⁻¹ are mostly
zeros (the divisions' zero shortcut), and for the edge update on S with
unit rows (a clipped footprint's padded rows, H = 0 and R = 1)."""

import numpy as np
import pytest
import torch

from ipp_rl_tpu_torch.ops import smallchol

WARP_M = [13, 25, 32]
DTYPES = [torch.float32, torch.float64]
WARP = 32
VEC_BYTES = 16  # a cp.async / float4 copy


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tri(i):
    return i * (i + 1) // 2


def clamp_pivot(x):
    return torch.clamp(x, min=smallchol.PIVOT_FLOOR)


def neg_zero(like):
    return torch.full_like(like, -0.0)


def neg_quotient(acc, d):
    """csrc/smallchol.cu: neg_quotient, -acc / d with a zero acc divided as 1
    and the quotient replaced by -acc itself (d no NaN)."""
    zero = acc == 0
    q = -torch.where(zero, torch.ones_like(acc), acc) / d
    return torch.where(zero & ~torch.isnan(d), -acc, q)


class LaneTriangles:
    """A warp's shared memory of spd_trace_product_lanes_kernel: kT * 32
    slots, slot e * 32 + l holding entry e of lane l for every emulated warp
    (a (W,) tensor), each slot tagged with what it holds ("S", "L", "Li",
    "term").  A warp-wide access to entry e touches slots e * 32 .. e * 32
    + 31, which lie in 32 distinct banks."""

    def __init__(self, kT, W, dtype):
        self.val = torch.zeros((kT * WARP, W), dtype=dtype)
        self.tag = [None] * kT

    @staticmethod
    def slots(e):
        return slice(e * WARP, e * WARP + WARP)

    def read(self, e, holds):
        assert self.tag[e] == holds, f"entry {e} holds {self.tag[e]}, read as {holds}"
        return self.val[self.slots(e)]

    def write(self, e, x, holds):
        self.val[self.slots(e)] = x
        self.tag[e] = holds


def banks(addresses, elem_bytes):
    """The shared-memory wavefronts a warp's access to these element
    addresses takes: 32 banks of 4 bytes, 128 bytes per wavefront."""
    words = {}
    for a in addresses:
        for w in range(elem_bytes // 4):
            word = a * (elem_bytes // 4) + w
            words.setdefault(word % 32, set()).add(word)
    return max(len(v) for v in words.values())


def cholesky_rows(x, M, R, i, inv_d):
    """csrc/smallchol.cu: lanes_cholesky_rows<M, R>, rows i .. i + R - 1."""
    xr = [tri(i + q) for q in range(R)]
    r = [[None] * M for _ in range(R)]
    for j in range(M - 1):
        if j < i:
            a = [x.read(xr[q] + j, "S") for q in range(R)]
            for k in range(j):
                lv = x.read(tri(j) + k, "L")
                a = [a[q] - r[q][k] * lv for q in range(R)]
            for q in range(R):
                r[q][j] = a[q] * inv_d[j]
                x.write(xr[q] + j, r[q][j], "L")
    acc = x.read(xr[0] + i, "S")
    for k in range(M - 1):
        if k < i:
            acc = acc - r[0][k] * r[0][k]
    d0 = smallchol._sqrt(clamp_pivot(acc))
    x.write(xr[0] + i, d0, "L")
    inv_d[i] = 1.0 / d0
    if R == 2:
        a = x.read(xr[1] + i, "S")
        for k in range(M - 1):
            if k < i:
                a = a - r[1][k] * r[0][k]
        l10 = a * inv_d[i]
        x.write(xr[1] + i, l10, "L")
        acc1 = x.read(xr[1] + i + 1, "S")
        for k in range(M - 1):
            if k < i:
                acc1 = acc1 - r[1][k] * r[1][k]
        acc1 = acc1 - l10 * l10
        d1 = smallchol._sqrt(clamp_pivot(acc1))
        x.write(xr[1] + i + 1, d1, "L")
        inv_d[i + 1] = 1.0 / d1


def invert_columns(x, M, R, c):
    """csrc/smallchol.cu: lanes_invert_columns<M, R>, columns c .. c + R - 1:
    row i's entries of both columns are read before either is written."""
    col = [[None] * M for _ in range(R)]
    cc = tri(c) + c
    col[0][0] = 1.0 / x.read(cc, "L")
    x.write(cc, col[0][0], "Li")
    for dd in range(1, M):
        if c + dd < M:
            i = c + dd
            xi = tri(i) + c  # L[i][c + d] at entry xi + d
            acc0 = x.read(xi, "L") * col[0][0]
            if R == 2 and dd >= 2:
                acc1 = x.read(xi + 1, "L") * col[1][0]
            for d in range(1, dd):
                lv = x.read(xi + d, "L")
                acc0 = acc0 + lv * col[0][d]
                if R == 2 and d >= 2:
                    acc1 = acc1 + lv * col[1][d - 1]
            lii = x.read(xi + dd, "L")
            col[0][dd] = neg_quotient(acc0, lii)
            x.write(xi, col[0][dd], "Li")
            if R == 2:
                r = 0 if dd == 1 else dd - 1
                col[1][r] = 1.0 / lii if dd == 1 else neg_quotient(acc1, lii)
                x.write(xi + 1, col[1][r], "Li")


def term_columns(x, M, R, j, g_entry):
    """csrc/smallchol.cu: lanes_term_columns<M, R>, columns j .. j + R - 1:
    row i's entries of both columns are formed before either is written."""
    col = [[None] * M for _ in range(R)]
    gcol = [[None] * M for _ in range(R)]
    for k in range(M):
        for q in range(R):
            if k >= j + q:
                col[q][k] = x.read(tri(k) + j + q, "Li")
                gcol[q][k] = g_entry(tri(k) + j + q)
    for i in range(M):
        if i >= j:
            dii = x.read(tri(i) + i, "Li")
            live = [q for q in range(R) if i >= j + q]
            acc = {q: dii * col[q][i] for q in live}
            for k in range(i + 1, M):
                lv = x.read(tri(k) + i, "Li")
                acc = {q: acc[q] + lv * col[q][k] for q in live}
            for q in live:
                term = acc[q] * gcol[q][i]
                if i != j + q:
                    term = term + term
                x.write(tri(i) + j + q, term, "term")


def lanes_trace_product(Sp, Gp):
    """csrc/smallchol.cu: spd_trace_product_lanes_kernel, every warp of the
    launch at once; returns the output written (NaN where nothing was)."""
    outer, kT, inner = Sp.shape
    M = smallchol.packed_m(kT)
    n = outer * inner
    W = (n + WARP - 1) // WARP
    mine = torch.arange(W * WARP).view(W, WARP).T  # (lane, warp)
    t = torch.clamp(mine, max=n - 1)  # lanes past the end repeat the last block
    o = t // inner
    base = o * (kT - 1) * inner + t
    s_flat, g_flat = Sp.reshape(-1), Gp.reshape(-1)
    for w in range(W):  # entry e of a warp's live lanes: consecutive, but where o steps
        step = base[1:, w] - base[:-1, w]
        crosses = o[1:, w] != o[:-1, w]
        assert bool(((step == 1) | crosses | (mine[1:, w] >= n)).all())
    # a warp's access to one entry: one wavefront in float32, two in float64
    elem = Sp.element_size()
    assert banks([5 * WARP + lane for lane in range(WARP)], elem) == elem // 4

    x = LaneTriangles(kT, W, Sp.dtype)
    for e in range(kT):  # cp.async, one element each
        x.write(e, s_flat[base + e * inner], "S")

    inv_d = [None] * M
    for i in range(0, M - 1, 2):  # #pragma unroll 1
        cholesky_rows(x, M, 2, i, inv_d)
    if M % 2 == 1:
        cholesky_rows(x, M, 1, M - 1, inv_d)
    for c in range(0, M - 1, 2):
        invert_columns(x, M, 2, c)
    if M % 2 == 1:
        invert_columns(x, M, 1, M - 1)
    for j in range(0, M - 1, 2):
        term_columns(x, M, 2, j, lambda e: g_flat[base + e * inner])
    if M % 2 == 1:
        term_columns(x, M, 1, M - 1, lambda e: g_flat[base + e * inner])

    total = x.read(0, "term")
    for e in range(1, kT):
        total = total + x.read(e, "term")
    out = torch.full((W * WARP,), float("nan"), dtype=Sp.dtype)
    live = mine < n
    out[mine[live]] = total[live]
    return out[:n].view(outer, inner)


def stage_chunks(src_elem, count, elem_bytes):
    """csrc/smallchol.cu: warp_stage_async / warp_store's split of `count`
    elements starting at element address src_elem: the single-element head,
    the 16-byte chunks, the single-element tail."""
    vec = VEC_BYTES // elem_bytes
    head = min((vec - src_elem % vec) % vec, count)
    vecs = (count - head) // vec
    rest = head + vecs * vec
    return list(range(head)), [head + k * vec for k in range(vecs)], list(range(rest, count))


@pytest.mark.parametrize("elem_bytes", [4, 8])
@pytest.mark.parametrize("M", WARP_M)
def test_warp_staging_copies_each_element_once(M, elem_bytes):
    """The staged matrix b of spd_inverse_rows_kernel starts at element b·M²
    of the batch; its buffer starts at the same offset modulo 16 bytes, so
    every 16-byte copy is aligned at both ends, and head, chunks and tail
    cover each element exactly once."""
    vec = VEC_BYTES // elem_bytes
    for b in range(8):
        src = b * M * M
        dst = src % vec  # align_offset: the buffer's start past a 16-byte boundary
        head, chunks, tail = stage_chunks(src, M * M, elem_bytes)
        covered = head + tail + [c + k for c in chunks for k in range(vec)]
        assert sorted(covered) == list(range(M * M))
        assert all((src + c) % vec == 0 and (dst + c) % vec == 0 for c in chunks)
        assert len(head) < WARP  # one element per lane: `if (lane < head)`


def shfl(v, src_lane):
    """__shfl_sync(kFullMask, v, src_lane): lane src_lane's value for all."""
    assert 0 <= src_lane < WARP
    return v[src_lane].expand_as(v)


class RowsShared:
    """spd_inverse_rows_kernel's shared copy of L (rows of rows_ld(M)
    elements), then of L⁻¹ transposed: each slot (r, k) tagged with what it
    holds; a read of four slots (one 16-byte broadcast load) must start at a
    multiple of 4 and stay inside the row."""

    def __init__(self, M):
        self.ld = (M + 3) // 4 * 4
        self.val, self.tag = {}, {}

    def write(self, r, k, v, holds):
        self.val[r, k], self.tag[r, k] = v, holds

    def load4(self, r, k4, want, holds):
        """v[u] = slot (r, k4 + u) for the u in `want` (the ones used)."""
        assert k4 % 4 == 0 and k4 + 4 <= self.ld
        out = [None] * 4
        for u in want:
            assert self.tag.get((r, k4 + u)) == holds, (r, k4 + u, holds)
            out[u] = self.val[r, k4 + u]
        return out


def rows_cholesky(s, lsh, M, row, holds):
    """csrc/smallchol.cu: rows_cholesky<M>, column by column; s(j) is each
    lane's entry (row, j), a (WARP, n) tensor.  Writes the copy's slots
    tagged ``holds``; returns each lane's row of the factor."""
    Lrow = [None] * M
    for j in range(M):
        acc = s(j)
        for k4 in range(0, j, 4):
            v = lsh.load4(j, k4, [u for u in range(4) if k4 + u < j], holds)
            for u in range(4):
                if k4 + u < j:
                    acc = acc - Lrow[k4 + u] * v[u]
        d = smallchol._sqrt(clamp_pivot(shfl(acc, j)))
        inv_d = 1.0 / d
        Lrow[j] = torch.where(row == j, d, torch.where(row > j, acc * inv_d, torch.zeros_like(d)))
        for ln in range(M):  # if (lane < M) lsh[row][j] = Lrow[j]
            lsh.write(ln, j, Lrow[j][ln], holds)
    return Lrow


def rows_invert_lower(lsh, M, row):
    """csrc/smallchol.cu: rows_invert_lower<M>, lane c down column c of L⁻¹."""
    Lic = [None] * M
    for i in range(M):
        acc = neg_zero(lsh.val[0, 0].expand(WARP, -1))
        lii = None
        for k4 in range(0, i + 1, 4):
            v = lsh.load4(i, k4, [u for u in range(4) if k4 + u <= i], "L")
            for u in range(4):
                k = k4 + u
                if k < i:
                    acc = torch.where(k >= row, acc + v[u] * Lic[k], acc)
                if k == i:
                    lii = v[u]
        Lic[i] = torch.where(row == i, 1.0 / lii, neg_quotient(acc, lii))
    return Lic


def rows_inverse_entries(lsh, M, Lic):
    """csrc/smallchol.cu: rows_inverse_entries<M>: the columns of L⁻¹ over
    the copy of L, then lane j's column of S⁻¹; returns buf[r][c], every
    entry written (both triangles)."""
    for ln in range(M):
        for k in range(M):
            if k >= ln:
                lsh.write(ln, k, Lic[k][ln], "Li")
    buf = [[None] * M for _ in range(M)]
    for i in range(M):
        acc = neg_zero(Lic[0])
        for k4 in range(i // 4 * 4, M, 4):
            want = [u for u in range(4) if i <= k4 + u < M]
            v = lsh.load4(i, k4, want, "Li")
            for u in want:
                acc = acc + v[u] * Lic[k4 + u]
        for ln in range(min(i + 1, WARP)):  # if (lane <= i)
            for r, c in ((i, ln), (ln, i)):
                assert buf[r][c] is None or torch.equal(buf[r][c], acc[ln])
                buf[r][c] = acc[ln]
    assert all(v is not None for r in buf for v in r), "an entry of S^-1 was never written"
    return buf


def lanes_rows(buf, row, j):
    """Each lane's buf[row][j]: (WARP, n)."""
    return torch.stack([buf[r][j] for r in row.squeeze(1).tolist()])


def rows_factors(s, M, n, second):
    """The row kernels' common passes on n matrices at once (v[lane] is
    what lane `lane` holds for each matrix): the Cholesky of the matrix
    whose lanes' entries s(j) gives, L⁻¹, S⁻¹; with ``second`` the
    Cholesky of S⁻¹ as well.  Returns (S⁻¹, U or None)."""
    lane = torch.arange(WARP).view(WARP, 1)
    row = torch.clamp(lane, max=M - 1)  # lanes past M repeat row M - 1
    lsh = RowsShared(M)
    rows_cholesky(s(row), lsh, M, row, "L")
    buf = rows_inverse_entries(lsh, M, rows_invert_lower(lsh, M, row))
    inv = torch.stack([torch.stack(r, dim=-1) for r in buf], dim=-2)
    if not second:
        return inv, None
    rows_cholesky(lambda j: lanes_rows(buf, row, j), lsh, M, row, "U")
    U = torch.stack([torch.stack([lsh.val[r, c] for c in range(M)], dim=-1) for r in range(M)],
                    dim=-2)
    assert all(lsh.tag[r, c] == "U" for r in range(M) for c in range(M))
    return inv, U


def rows_inverse(S):
    """csrc/smallchol.cu: spd_inverse_rows_kernel (the Cholesky by columns,
    the column substitution, the S⁻¹ columns), every matrix at once."""
    n, M, _ = S.shape
    Sl = S.permute(1, 2, 0)  # (i, j, matrix)
    return rows_factors(lambda row: lambda j: Sl[row.squeeze(1), j], M, n, second=False)[0]


def rows_inverse_factor(S):
    """csrc/smallchol.cu: factor_rows_kernel for spd_inverse_factor: S⁻¹ as
    spd_inverse_rows_kernel, then U = chol(S⁻¹) from the staged buffer's
    S⁻¹ into the copy, stored with zeros above the diagonal."""
    n, M, _ = S.shape
    Sl = S.permute(1, 2, 0)
    return rows_factors(lambda row: lambda j: Sl[row.squeeze(1), j], M, n, second=True)


def edge_factor_rows(S_raw, R_table, a):
    """csrc/smallchol.cu: factor_rows_kernel for the edge: U = chol(S⁻¹) of S =
    0.5 (S_raw + S_rawᵀ) + diag(R[a]), each lane's entry (row, j) formed
    from the staged S_raw as the first Cholesky reads it; Uᵀ stored to rows
    of 32 elements (ut[m][k] = U[k][m]), zeros below the diagonal and in the
    padding."""
    n, M, _ = S_raw.shape
    Sl = S_raw.permute(1, 2, 0)
    Rl = R_table[a].T  # (i, mission)

    def entries(row):
        r = row.squeeze(1)
        r_row = Rl[r]
        return lambda j: 0.5 * (Sl[r, j] + Sl[j, r]) + torch.where(
            r[:, None] == j, r_row, torch.zeros_like(r_row))

    _, U = rows_factors(entries, M, n, second=True)
    ut = torch.zeros((n, M, 32), dtype=S_raw.dtype)
    ut[:, :, :M] = U.mT  # ub[m * 32 + lane] = lane < M ? U[lane][m] : 0
    return ut


COLUMNS_THREADS = 256  # csrc/smallchol.cu: kColumnsThreads


def edge_columns(ut, A, mask=None, round_bf16=False, threads=COLUMNS_THREADS):
    """csrc/smallchol.cu: edge_columns_kernel, every mission and column at
    once (a thread's column is one lane of these tensors): Uᵀ's rows staged
    (rows of rows_ld(M), read by 16-byte loads), each column's Wcᵀ row by
    row (the sum over k from -0, U's zeros kept), its squares in row order,
    the mask; the sums of each pass of ``threads`` columns read by warp 0 in
    the warp order, then the xor tree.  Returns (Wcᵀ, gain)."""
    B, M, n = A.shape
    ld = (M + 3) // 4 * 4
    us = ut[:, :, :ld]  # us[m * ld + k] = ub[m * 32 + k], kLd <= 32
    WcT = torch.full_like(A, float("nan"))
    sq = None
    for m in range(M):
        acc = torch.full((B, n), -0.0, dtype=A.dtype)
        for k4 in range(0, M, 4):
            for u in range(4):
                if k4 + u < M:
                    acc = acc + us[:, m, k4 + u, None] * A[:, k4 + u]
        if round_bf16:
            acc = acc.to(torch.bfloat16).to(A.dtype)
        WcT[:, m] = acc
        sq = acc * acc if m == 0 else sq + acc * acc
    if mask is not None:
        sq = sq * mask
    g = None  # warp 0: (B, 32) lane sums
    for c0 in range(0, n, threads):
        sqs = torch.zeros((B, threads), dtype=A.dtype)  # zero past n
        sqs[:, :min(threads, n - c0)] = sq[:, c0:c0 + threads]
        for w in range(threads // WARP):
            chunk = c0 // WARP + w
            if WARP * chunk < n:
                v = sqs[:, w * WARP:(w + 1) * WARP]
                g = v if chunk == 0 else g + v
    width = WARP // 2
    while width:  # the xor tree: lane l adds lane l ^ width, a + b = b + a
        g = g + g[:, torch.arange(WARP) ^ width]
        width //= 2
    return WcT, g[:, 0]


def same(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


def spd_batch(n, M, dtype, seed, clamp, sparse=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, M, M))
    if sparse:  # three interleaved independent blocks: most of L, L⁻¹ and S⁻¹
        i = np.arange(M)  # are zeros, as on the sweep's blocks
        A = A * (i[:, None] % 3 == i[None, :] % 3)
    S = torch.from_numpy(A @ A.transpose(0, 2, 1) + 0.5 * np.eye(M))
    if clamp:
        S[n // 2, -1, -1] -= 2.0 * S[n // 2].diagonal().sum()  # the last pivot clamps
    return S.to(dtype)


def packed(X, outer, inner):
    T = smallchol.packed_size(X.shape[-1])
    return smallchol.pack_lower(X).view(outer, inner, T).transpose(1, 2).contiguous()


@pytest.mark.parametrize("case", ["spd", "clamped", "sparse"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", WARP_M)
def test_lanes_trace_product_order_is_the_plain_order(M, dtype, case):
    """74 blocks: three warps, the last ragged, warps that cross an o."""
    outer, inner = 2, 37
    S = spd_batch(outer * inner, M, dtype, seed=M, clamp=case == "clamped",
                  sparse=case == "sparse")
    G = spd_batch(outer * inner, M, dtype, seed=100 + M, clamp=False)
    Sp, Gp = packed(S, outer, inner), packed(G, outer, inner)
    got = lanes_trace_product(Sp, Gp)
    want = smallchol.spd_trace_product_packed(Sp, Gp)
    assert same(got, want)


@pytest.mark.parametrize("case", ["spd", "clamped", "sparse"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", WARP_M)
def test_rows_inverse_order_is_the_plain_order(M, dtype, case):
    S = spd_batch(5, M, dtype, seed=M, clamp=case == "clamped", sparse=case == "sparse")
    got = rows_inverse(S)
    want = smallchol.spd_inverse(S)
    assert same(got, want)
    if case == "clamped":  # a clamped pivot gives ~1e30 there, not a NaN
        assert abs(got[2, -1, -1].item()) > 1e29
    if case == "sparse":  # zero dividends: the shortcut's zeros keep their sign
        assert bool((got == 0).any())
        assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("case", ["spd", "clamped", "sparse"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", WARP_M)
def test_rows_inverse_factor_order_is_the_plain_order(M, dtype, case):
    """factor_rows_kernel for K3: S⁻¹ and U, bitwise the plain
    spd_inverse_factor's (NaN where it overflows on a clamped pivot)."""
    S = spd_batch(4, M, dtype, seed=50 + M, clamp=case == "clamped", sparse=case == "sparse")
    inv, U = rows_inverse_factor(S)
    want_inv, want_U = smallchol.spd_inverse_factor(S)
    assert same(inv, want_inv) and same(U, want_U)
    assert torch.equal(torch.signbit(inv), torch.signbit(want_inv))
    assert torch.equal(torch.triu(U, 1), torch.zeros_like(U))


def edge_batch(B, M, N, dtype, seed, padded):
    """S_raw = A·Hᵀ and A = H·P as a descent step or the fitness forms them,
    an R table of 5 actions, actions and a 0/1 mask; with ``padded`` the
    last rows of each mission's H are zeros and their R ones, as the
    continuous world pads a clipped footprint (S gets unit rows)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, N))
    P = X @ X.T / N + 0.1 * np.eye(N)
    H = rng.normal(size=(B, M, N)) / N ** 0.5
    R = rng.uniform(0.5, 1.5, size=(5, M))
    if padded:
        H[:, M - M // 3:] = 0.0
        R[:, M - M // 3:] = 1.0
    a = rng.integers(0, 5, size=B)
    A = H @ P
    mask = (rng.random((B, N)) > 0.4).astype(np.float64)
    t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    return t(A @ np.swapaxes(H, -1, -2)), t(A), t(R), torch.from_numpy(a), t(mask)


@pytest.mark.parametrize("case", ["dense", "padded"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", WARP_M)
def test_edge_rows_and_columns_are_the_plain_order(M, dtype, case):
    """edge_factor_gain's warp route: Uᵀ from factor_rows_kernel into rows
    of 32, then edge_columns_kernel, over
    N = 70 columns in passes of 32 (three passes, the last ragged: the
    kernel's 256 columns a pass, scaled down) and of 256, with a per-mission
    mask, with a shared one and the bf16 round trip: Wcᵀ and the gain
    bitwise the plain edge_factor_gain's."""
    S_raw, A, R, a, mask = edge_batch(3, M, 70, dtype, seed=M, padded=case == "padded")
    ut = edge_factor_rows(S_raw, R, a)
    assert torch.equal(ut[:, :, M:], torch.zeros_like(ut[:, :, M:]))
    for m, rb, threads in ((mask, False, 32), (mask, False, COLUMNS_THREADS),
                           (mask[0], dtype == torch.float32, 64)):
        WcT, gain = edge_columns(ut, A, m, rb, threads)
        want_wct, want_gain = smallchol.edge_factor_gain(S_raw, A, R, a, m, rb)
        assert same(WcT, want_wct) and same(gain, want_gain)
    if case == "padded":  # unit rows: zeros in U, and zero dividends on the way
        assert bool((ut[:, :, :M] == 0).sum() > M * (M - 1) // 2 * 3)
