"""AIJ pack: arbitrary-pattern sparse matrices -> Clos-routed SpMV plans.

The capability analog of PETSc MatAIJ assembly + MatMult
(``/root/reference/src/utils/utils.c:139-155``): ANY sparse matrix, no
band/block structure assumed.  The pack compiles the matrix's access
pattern into a fixed routing program over two short gathers, each
confined to an (8, 128) block (row / column ``take_along_axis``, see
``ops/clos_route.py``):

    y = K3( D^-1( K2( D( K1(x) ) ) ) )

* K1 — "chunk gather": nonzeros grouped by 1024-element x-chunk; per
  (8, 128) block, gather the chunk and each nonzero's x value into the
  block (2 ops), then apply the first Clos stage R2 (3 ops).
* D  — XLA reshape-transpose ``(a, 1024) -> (1024, a)``: exchanges
  1024-element blocks with stride-1024 position classes (the "wiring"
  between Clos stages; a | 1024 keeps classes inside blocks).
* K2 — middle Clos stage: one in-block bijection per block (3 ops).
* K3 — final Clos stage fused with the ELL accumulation: per output
  row-tile slot, permute the incoming block into row positions, multiply
  by the stored values, accumulate into the y tile.

Positions are routed by König edge colorings (``clos_route.edge_color``)
at the global level (which block each element parks in between
transposes) and per block (which row it parks in between the two
column moves).  Every index map is static per matrix — pack once
(`prepare()` lifecycle), stream the i32 maps alongside the values at
apply time.  Traffic is pattern-independent.

Segments: rows are split into segments whose padded block count fits
a <= 1024 (M <= 2^20 positions); each segment owns its routing and the
kernels loop over segments inside one jit.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from medane_tchakorom_ufc_thesis_repository_tpu.ops import clos_route
from medane_tchakorom_ufc_thesis_repository_tpu.ops.clos_route import (
    next_pow2,
)

logger = logging.getLogger(__name__)

BLOCK = 1024  # elements per routed block = one (8, 128) f32 tile


def to_wide(arr: np.ndarray, a: int) -> np.ndarray:
    """Narrow block layout -> 8-block-wide super-step layout.

    Narrow: row ``b*8 + i``, lane ``l`` (one (8, 128) tile per block).
    Wide: row ``(b//8)*8 + i``, lane ``(b%8)*128 + l`` — 8 blocks side
    by side in the columns of one (8, 1024) tile, so one row gather
    (axis=0, any width) serves all 8 blocks.  Requires ``a % 8 == 0``."""
    nsb = a // 8
    return (arr.reshape(nsb, 8, 8, 128).transpose(0, 2, 1, 3)
            .reshape(a, 1024))


def to_narrow(arr: np.ndarray, a: int) -> np.ndarray:
    nsb = a // 8
    return (arr.reshape(nsb, 8, 8, 128).transpose(0, 2, 1, 3)
            .reshape(a * 8, 128))


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Static routing program for one row segment (numpy; the AIJ
    operator ships these to the device once).  When ``wide`` is set the
    k1/k2/k3 index maps and ``vals`` are stored in the 8-block-wide
    layout (``to_wide``) consumed by the wide kernels; the numpy/jnp
    reference paths convert back via ``to_narrow``."""

    a: int              # routed blocks per side (power of two, <= 1024)
    tile0: int          # first 1024-row output tile (global index)
    ntiles: int         # output tiles covered by this segment
    chunk_ids: np.ndarray   # (a,) int32: x chunk per g-block
    k1_idx: np.ndarray      # (a*8, 128) int32: c1|c2<<3|cA1<<10|cB<<13|cA2<<20
    k2_idx: np.ndarray      # (a*8, 128) int32: cA1|cB<<3|cA2<<10
    k3_idx: np.ndarray      # (a*8, 128) int32: cA1|cB<<3|cA2<<10
    vals: np.ndarray        # (a*8, 128) ELL values (0 at padding)
    y_tile: np.ndarray      # (a,) int32: local output tile per slot
    #                         (== ntiles for padding slots -> garbage tile)
    # y-unpermute (undoes the segment's degree-sort row permutation):
    a_y: int                # y blocks (power of two >= ntiles)
    yp_r2: np.ndarray       # (a_y*8, 128) int32 packed A∘B∘A
    yp_mid: np.ndarray      # (a_y*8, 128) int32
    yp_r1: np.ndarray       # (a_y*8, 128) int32
    wide: bool = False      # k1/k2/k3/vals in the 8-block-wide layout


@dataclasses.dataclass(frozen=True)
class AIJPlan:
    shape: tuple
    nnz: int
    n_pad_cols: int
    segments: tuple     # of SegmentPlan
    fill: float         # routed positions / nnz (padding diagnostic)


def _pack_k1_fields(c1, c2, cA1, cB, cA2):
    return (c1 | (c2 << 3) | (cA1 << 10) | (cB << 13)
            | (cA2 << 20)).astype(np.int32)


def _pack_aba(cA1, cB, cA2):
    return (cA1 | (cB << 3) | (cA2 << 10)).astype(np.int32)


def _batched_block_perms(src_off, dst_off):
    """Vectorized A∘B∘A decompositions for nb blocks at once.

    ``src_off``/``dst_off``: (nb, 1024) in-block offsets of each element
    (each row covers 0..1023 exactly once on each side).  Returns three
    (nb, 8, 128) int32 index arrays (see clos_route.block_perm_indices).
    """
    from medane_tchakorom_ufc_thesis_repository_tpu import native

    nb = src_off.shape[0]
    s_i, s_l = src_off // 128, src_off % 128
    d_i, d_l = dst_off // 128, dst_off % 128
    psi = native.euler_color_blocks(s_l, d_l)
    cA1 = np.zeros((nb, 8, 128), np.int32)
    cB = np.zeros((nb, 8, 128), np.int32)
    cA2 = np.zeros((nb, 8, 128), np.int32)
    bi = np.repeat(np.arange(nb), BLOCK).reshape(nb, BLOCK)
    cA1[bi, psi, s_l] = s_i
    cB[bi, psi, d_l] = s_l
    cA2[bi, d_i, d_l] = psi
    return cA1, cB, cA2


def _pack_gblocks(cols):
    """Group nonzeros by x-chunk and place them into (8, 128) g-blocks
    under the K1 gather constraint: within a block, cells in row ``i``
    whose source lane is ``l`` must all read the same source sublane
    (the sublane-gather map ``c1[i, l]`` is single-valued — duplicate
    reads of one x element may share a (row, lane) claim).  Greedy with
    spill: an element that fits no row of the current block defers to
    the next block of the same chunk, so adversarial duplicate patterns
    degrade fill instead of failing.

    ``cols``: (m,) global column index of each nonzero.

    Returns ``(chunk_ids (nb,), c1 (nb,8,128), c2 (nb,8,128),
    elem_order (m,), src_off (m,))``: element ``elem_order[p]`` (an index
    into ``cols``) lands in block ``p // 1024``-ish — precisely, elements
    are listed in packed order with ``src_off[p]`` its in-block offset
    and block boundaries implied by ``block_of[p]`` (also returned)."""
    from medane_tchakorom_ufc_thesis_repository_tpu import native

    m = cols.shape[0]
    chunk = cols // BLOCK
    s_all = ((cols % BLOCK) // 128).astype(np.int64)
    l_all = (cols % 128).astype(np.int64)
    order = np.argsort(chunk, kind="stable")

    placed = native.aij_pack_gblocks(chunk, s_all, l_all, order) \
        if m else None
    if placed is not None:
        chunk_ids, elem_order, src_off, block_of = placed
    else:
        # python fallback of the same greedy (native/src/clos.cpp is
        # the fast path: the per-element loop is the pack-time
        # bottleneck — ~2 µs/nnz in python, ~20 ns/nnz native)
        chunk_ids_l: list = []
        elem_order = np.empty(m, np.int64)
        src_off = np.empty(m, np.int64)
        block_of = np.empty(m, np.int64)
        pos = 0
        k = 0
        while k < m:
            q = int(chunk[order[k]])
            k2 = k
            while k2 < m and chunk[order[k2]] == q:
                k2 += 1
            queue = order[k:k2]
            while len(queue):
                b = len(chunk_ids_l)
                claim = np.full((8, 128), -1, np.int16)
                load = np.zeros(8, np.int64)
                deferred = []
                nplaced = 0
                for qi, e in enumerate(queue):
                    s = int(s_all[e])
                    l = int(l_all[e])
                    for i in range(8):
                        if load[i] < 128 and (claim[i, l] < 0
                                              or claim[i, l] == s):
                            claim[i, l] = s
                            elem_order[pos] = e
                            src_off[pos] = i * 128 + int(load[i])
                            block_of[pos] = b
                            load[i] += 1
                            nplaced += 1
                            pos += 1
                            break
                    else:
                        deferred.append(e)
                    if nplaced == BLOCK:
                        deferred.extend(queue[qi + 1:])
                        break
                chunk_ids_l.append(q)
                queue = np.asarray(deferred, np.int64)
            k = k2
        chunk_ids = np.asarray(chunk_ids_l, np.int32)

    nb = chunk_ids.shape[0] if m else 0
    if nb == 0:
        z = np.zeros(0, np.int64)
        return (np.zeros(0, np.int32), np.zeros((0, 8, 128), np.int32),
                np.zeros((0, 8, 128), np.int32), z, z, z)
    # c1/c2 from the placements, vectorized (duplicate writes per
    # (block, row, lane) carry the SAME s by the claim constraint)
    i_pos = src_off // 128
    j_pos = src_off % 128
    le = l_all[elem_order]
    se = s_all[elem_order]
    c1 = np.zeros((nb, 8, 128), np.int32)
    c2 = np.zeros((nb, 8, 128), np.int32)
    c1[block_of, i_pos, le] = se
    c2[block_of, i_pos, j_pos] = le
    return (chunk_ids, c1, c2, elem_order, src_off, block_of)


def _route_bijection(src_flat, dst_flat, a):
    """Three-stage Clos routing of a bijection on ``a * 1024``
    positions: global edge coloring (parking offset chi between the two
    transposes) + per-block A∘B∘A decompositions.  Returns three
    (a, 8, 128) int32 triples ``(r2, mid, r1)`` where each is
    ``(cA1, cB, cA2)`` — r2 applies within SOURCE blocks (before D),
    mid within the transposed blocks, r1 within DESTINATION blocks
    (after D^-1)."""
    chi = clos_route.edge_color(
        src_flat // BLOCK, dst_flat // BLOCK, a, a, BLOCK
    ).astype(np.int64)
    beta_s = src_flat // BLOCK
    beta_d = dst_flat // BLOCK
    r2 = _batched_block_perms(
        _group_offsets(beta_s, src_flat % BLOCK),
        _group_offsets(beta_s, chi))
    h_src = chi * a + beta_s
    h_dst = chi * a + beta_d
    mid = _batched_block_perms(
        _group_offsets(h_src // BLOCK, h_src % BLOCK),
        _group_offsets(h_src // BLOCK, h_dst % BLOCK))
    r1 = _batched_block_perms(
        _group_offsets(beta_d, chi),
        _group_offsets(beta_d, dst_flat % BLOCK))
    return r2, mid, r1


def _pack_segment(rows, cols, vals, tile0, ntiles, dtype,
                  min_blocks: int = 1):
    """Build one SegmentPlan for nonzeros whose rows lie in tiles
    [tile0, tile0 + ntiles).  Returns None if the padded block count
    exceeds 1024 (caller splits the segment).

    Rows are DEGREE-SORTED within the segment before the ELL layout:
    tile widths equal the max row degree in the tile, so clustering
    similar degrees makes slots ~full (random d=10 measured slot fill
    0.40 unsorted -> ~0.95 sorted).  The resulting row permutation is
    undone by a routed y-unpermute (3 cheap in-block stages + 2
    transposes on n-scale data — ~10% of the nnz-scale work)."""
    m = rows.shape[0]
    nloc = ntiles * BLOCK
    r_loc = rows - tile0 * BLOCK
    # --- degree sort (stable, descending): row -> sorted position
    deg = np.zeros(nloc, np.int64)
    if m:
        np.add.at(deg, r_loc, 1)
    srow = np.argsort(-deg, kind="stable")   # sorted pos -> local row
    pos_of_row = np.empty(nloc, np.int64)
    pos_of_row[srow] = np.arange(nloc)
    p = pos_of_row[r_loc]                    # each nnz's sorted row pos
    tile = p // BLOCK
    # w = occurrence index of each nonzero within its row
    order = np.argsort(p, kind="stable")
    sp_ = p[order]
    is_new = np.ones(m, bool)
    is_new[1:] = sp_[1:] != sp_[:-1]
    grp_start = np.maximum.accumulate(np.where(is_new, np.arange(m), 0))
    w = np.empty(m, np.int64)
    w[order] = np.arange(m) - grp_start
    # slots per tile = max w + 1
    W_t = np.zeros(ntiles, np.int64)
    if m:
        np.maximum.at(W_t, tile, w + 1)
    slot_base = np.zeros(ntiles + 1, np.int64)
    np.cumsum(W_t, out=slot_base[1:])
    nslots = int(slot_base[-1])
    slot = slot_base[tile] + w
    o_ell = (p % BLOCK).astype(np.int64)
    y_tile_real = np.repeat(np.arange(ntiles), W_t)

    # --- g side: chunk-grouped constrained placement
    (chunk_ids, c1g, c2g, elem_order, src_off_in, block_of) = \
        _pack_gblocks(cols)
    ngb = chunk_ids.shape[0]

    B = max(ngb, nslots, min_blocks, 1)
    a = next_pow2(B)
    if a > BLOCK:
        return None
    M = a * BLOCK

    # pad block lists to `a`
    chunk_ids = np.concatenate(
        [chunk_ids, np.zeros(a - ngb, np.int32)])
    c1g = np.concatenate(
        [c1g, np.zeros((a - ngb, 8, 128), np.int32)], axis=0)
    c2g = np.concatenate(
        [c2g, np.zeros((a - ngb, 8, 128), np.int32)], axis=0)
    y_tile = np.concatenate(
        [y_tile_real, np.full(a - nslots, ntiles, np.int64)])

    # --- full M-position source/destination lists (elements + pads)
    src_flat = np.empty(M, np.int64)
    dst_flat = np.empty(M, np.int64)
    src_flat[:m] = block_of * BLOCK + src_off_in
    # element destinations, in the g-packed element order
    dst_flat[:m] = (slot * BLOCK + o_ell)[elem_order]
    occ_src = np.zeros(M, bool)
    occ_src[src_flat[:m]] = True
    occ_dst = np.zeros(M, bool)
    occ_dst[dst_flat[:m]] = True
    src_flat[m:] = np.flatnonzero(~occ_src)
    dst_flat[m:] = np.flatnonzero(~occ_dst)

    r2, mid, r1 = _route_bijection(src_flat, dst_flat, a)
    k1_idx = _pack_k1_fields(c1g, c2g, *r2).reshape(a * 8, 128)
    k2_idx = _pack_aba(*mid).reshape(a * 8, 128)
    k3_idx = _pack_aba(*r1).reshape(a * 8, 128)

    # --- ELL values
    vals_ell = np.zeros(M, dtype)
    vals_ell[slot * BLOCK + o_ell] = vals
    vals_ell = vals_ell.reshape(a * 8, 128)

    # --- y-unpermute routing: y_nat[srow[q]] = y_perm[q]
    a_y = next_pow2(max(ntiles, 1))
    My = a_y * BLOCK
    ysrc = np.arange(My)
    ydst = np.concatenate([srow, np.arange(nloc, My)])
    yr2, ymid, yr1 = _route_bijection(ysrc, ydst, a_y)
    yp_r2 = _pack_aba(*yr2).reshape(a_y * 8, 128)
    yp_mid = _pack_aba(*ymid).reshape(a_y * 8, 128)
    yp_r1 = _pack_aba(*yr1).reshape(a_y * 8, 128)

    wide = a % 8 == 0
    if wide:
        k1_idx = to_wide(k1_idx, a)
        k2_idx = to_wide(k2_idx, a)
        k3_idx = to_wide(k3_idx, a)
        vals_ell = to_wide(vals_ell, a)

    return SegmentPlan(
        a=a, tile0=int(tile0), ntiles=int(ntiles),
        chunk_ids=chunk_ids, k1_idx=k1_idx, k2_idx=k2_idx,
        k3_idx=k3_idx, vals=vals_ell,
        y_tile=y_tile.astype(np.int32),
        a_y=a_y, yp_r2=yp_r2, yp_mid=yp_mid, yp_r1=yp_r1,
        wide=wide,
    )


def _group_offsets(block_idx, values):
    """Scatter per-element ``values`` into an (nblocks, 1024) table in
    block-grouped order: row b lists the values of the 1024 elements
    with ``block_idx == b`` (order within the row follows element
    order).  Every block index must appear exactly 1024 times."""
    order = np.argsort(block_idx, kind="stable")
    out = values[order].reshape(-1, BLOCK)
    return out


def pack_aij(rows, cols, vals, shape, dtype=np.float32,
             target_nnz: int = 900_000,
             min_blocks: int = 1) -> AIJPlan:
    """Pack an arbitrary COO/CSR-listed sparse matrix into the Clos
    gather plan.  Duplicate (row, col) entries are summed (PETSc
    ADD_VALUES semantics)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals)
    nrows, ncols = int(shape[0]), int(shape[1])
    if rows.size and (rows.min() < 0 or rows.max() >= nrows
                      or cols.min() < 0 or cols.max() >= ncols):
        raise ValueError("entry outside matrix shape")
    # sum duplicates, sort by (row, col) = CSR order
    key = rows * ncols + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        uniq = np.ones(rows.size, bool)
        uniq[1:] = key[1:] != key[:-1]
        seg_id = np.cumsum(uniq) - 1
        svals = np.zeros(int(seg_id[-1]) + 1, np.float64)
        np.add.at(svals, seg_id, vals.astype(np.float64))
        rows, cols = rows[uniq], cols[uniq]
        vals = svals
    nnz = rows.size
    n_pad_cols = BLOCK * max(1, -(-ncols // BLOCK))
    ntiles_total = max(1, -(-nrows // BLOCK))

    segments = []
    # tile-aligned row segmentation, pow2-aware: the routed position
    # count pads to a power of two (a | 1024 keeps Clos classes inside
    # blocks), so segments are cut where the estimated block count
    # lands just under a power of two instead of just past one.
    tile_of = rows // BLOCK

    def est_blocks(t0, t1):
        lo = np.searchsorted(tile_of, t0)
        hi = np.searchsorted(tile_of, t1)
        nloc = (t1 - t0) * BLOCK
        deg = np.bincount(rows[lo:hi] - t0 * BLOCK, minlength=nloc)
        ds = np.sort(deg)[::-1]
        slots = int(ds[::BLOCK][:t1 - t0].sum())
        cc = np.bincount(cols[lo:hi] // BLOCK)
        gb = int(np.sum(-(-cc[cc > 0] // BLOCK)))
        return max(slots, gb, 1)

    def largest_fitting(t0, cap):
        """Largest t1 with est_blocks(t0, t1) <= cap (est is monotone
        in t1); at least t0 + 1."""
        lo_t, hi_t = t0 + 1, ntiles_total
        if est_blocks(t0, hi_t) <= cap:
            return hi_t
        while hi_t - lo_t > 1:
            mid = (lo_t + hi_t) // 2
            if est_blocks(t0, mid) <= cap:
                lo_t = mid
            else:
                hi_t = mid
        return lo_t

    def nnz_of(t0, t1):
        return (np.searchsorted(tile_of, t1)
                - np.searchsorted(tile_of, t0))

    t0 = 0
    while t0 < ntiles_total:
        t1 = largest_fitting(t0, 1000)
        while t1 > t0 + 1 and nnz_of(t0, t1) > target_nnz:
            lo_t, hi_t = t0 + 1, t1
            while hi_t - lo_t > 1:
                mid = (lo_t + hi_t) // 2
                if nnz_of(t0, mid) <= target_nnz:
                    lo_t = mid
                else:
                    hi_t = mid
            t1 = lo_t
            break
        b_est = est_blocks(t0, t1)
        P = next_pow2(b_est)
        if t1 < ntiles_total or b_est < 0.8 * P:
            # cutting at the previous power of two wastes less padding
            # when this cut underfills its pow2
            while P > 128 and b_est < 0.8 * P:
                t1h = largest_fitting(t0, int(P // 2 * 0.98))
                bh = est_blocks(t0, t1h)
                if t1h > t0 and bh >= 0.8 * (P // 2):
                    t1, b_est, P = t1h, bh, P // 2
                else:
                    break
        lo = np.searchsorted(tile_of, t0)
        while True:
            hi = np.searchsorted(tile_of, t1)
            seg = _pack_segment(rows[lo:hi], cols[lo:hi],
                                vals[lo:hi].astype(dtype),
                                t0, t1 - t0, dtype,
                                min_blocks=min_blocks)
            if seg is not None:
                break
            if t1 == t0 + 1:
                raise ValueError(
                    "a single 1024-row tile exceeds the 2^20-position "
                    "routing budget (pathological duplicate pattern)")
            t1 = t0 + max(1, (t1 - t0) // 2)
        segments.append(seg)
        t0 = t1
    routed = sum(s.a * BLOCK for s in segments)
    fill = float(routed) / max(nnz, 1)
    if nnz >= 100_000 and fill > 4.0:
        # adversarial duplicate patterns / extreme sparsity degrade the
        # constrained placement; the plan stays correct, just padded
        logger.info(
            "aij pack fill %.1fx at nnz=%d (%d segments) — padding-"
            "dominated routing; per-nonzero cost scales with fill",
            fill, nnz, len(segments),
        )
    return AIJPlan(shape=(nrows, ncols), nnz=int(nnz),
                   n_pad_cols=int(n_pad_cols), segments=tuple(segments),
                   fill=fill)


# ---------------------------------------------------------------------------
# Applies: numpy (exact reference) and jnp (the device path)
# ---------------------------------------------------------------------------

def _unpack_k1(idx):
    return (idx & 7, (idx >> 3) & 127, (idx >> 10) & 7,
            (idx >> 13) & 127, (idx >> 20) & 7)


def _unpack_aba(idx):
    return idx & 7, (idx >> 3) & 127, (idx >> 10) & 7


def _aba_np(blk, cA1, cB, cA2):
    t = np.take_along_axis(blk, cA1, axis=1)
    u = np.take_along_axis(t, cB, axis=2)
    return np.take_along_axis(u, cA2, axis=1)


def aij_mv_np(plan: AIJPlan, x: np.ndarray) -> np.ndarray:
    """Numpy bit-reference of the full routed SpMV (the kernels must
    match this elementwise; exercised by tests against scipy/dense)."""
    nrows, _ = plan.shape
    x = np.asarray(x)
    xp = np.zeros(plan.n_pad_cols, x.dtype)
    xp[:x.shape[0]] = x
    xc = xp.reshape(-1, 8, 128)
    y = np.zeros(BLOCK * max(1, -(-nrows // BLOCK)), np.float64)
    for seg in plan.segments:
        a = seg.a
        k1i, k2i, k3i, vl = seg.k1_idx, seg.k2_idx, seg.k3_idx, seg.vals
        if seg.wide:
            k1i, k2i, k3i = (to_narrow(k1i, a), to_narrow(k2i, a),
                             to_narrow(k3i, a))
            vl = to_narrow(vl, a)
        chunks = xc[seg.chunk_ids]                       # (a, 8, 128)
        c1, c2, cA1, cB, cA2 = _unpack_k1(k1i.reshape(a, 8, 128))
        t = np.take_along_axis(chunks, c1, axis=1)
        g = np.take_along_axis(t, c2, axis=2)
        g = _aba_np(g, cA1, cB, cA2)                     # K1 out (t1)
        h = g.reshape(a, BLOCK).T.reshape(a, 8, 128)     # D
        h = _aba_np(h, *_unpack_aba(k2i.reshape(a, 8, 128)))
        h = h.reshape(BLOCK, a).T.reshape(a, 8, 128)     # D^-1
        o = _aba_np(h, *_unpack_aba(k3i.reshape(a, 8, 128)))
        contrib = (o.astype(np.float64)
                   * vl.reshape(a, 8, 128).astype(np.float64))
        tiles = np.zeros((seg.ntiles + 1, 8, 128), np.float64)
        np.add.at(tiles, seg.y_tile, contrib)
        # routed y-unpermute (undo the degree-sort row permutation)
        ay = seg.a_y
        yp = np.zeros((ay, 8, 128), np.float64)
        yp[:seg.ntiles] = tiles[:seg.ntiles]
        yp = _aba_np(yp, *_unpack_aba(seg.yp_r2.reshape(ay, 8, 128)))
        yp = yp.reshape(ay, BLOCK).T.reshape(ay, 8, 128)
        yp = _aba_np(yp, *_unpack_aba(seg.yp_mid.reshape(ay, 8, 128)))
        yp = yp.reshape(BLOCK, ay).T.reshape(ay, 8, 128)
        yp = _aba_np(yp, *_unpack_aba(seg.yp_r1.reshape(ay, 8, 128)))
        lo = seg.tile0 * BLOCK
        y[lo:lo + seg.ntiles * BLOCK] += \
            yp.reshape(-1)[:seg.ntiles * BLOCK]
    return y[:nrows]


def aij_mv_jnp(segments, n_pad_cols: int, nrows: int, x):
    """The device apply (every backend): identical math to
    ``aij_mv_np`` with XLA gathers over the small (…, 8, 128) axes.
    ``segments`` are ``operators.AIJSegment`` pytrees."""
    import jax
    import jax.numpy as jnp

    xp = jnp.zeros(n_pad_cols, x.dtype).at[:x.shape[0]].set(x)
    xc = xp.reshape(-1, 8, 128)

    def aba(blk, cA1, cB, cA2):
        t = jnp.take_along_axis(blk, cA1, axis=1)
        u = jnp.take_along_axis(t, cB, axis=2)
        return jnp.take_along_axis(u, cA2, axis=1)

    parts = []
    def nrw(arr, a, wide):
        if not wide:
            return arr
        nsb = a // 8
        return (arr.reshape(nsb, 8, 8, 128).transpose(0, 2, 1, 3)
                .reshape(a * 8, 128))

    for seg in segments:
        a = int(seg.a)
        wide = bool(getattr(seg, "wide", False))
        ntiles = int(seg.ntiles)
        k1i = nrw(seg.k1_idx, a, wide)
        k2i = nrw(seg.k2_idx, a, wide)
        k3i = nrw(seg.k3_idx, a, wide)
        vl = nrw(seg.vals, a, wide)
        chunks = jnp.take(xc, seg.chunk_ids, axis=0)
        c1, c2, cA1, cB, cA2 = _unpack_k1(k1i.reshape(a, 8, 128))
        t = jnp.take_along_axis(chunks, c1, axis=1)
        g = jnp.take_along_axis(t, c2, axis=2)
        g = aba(g, cA1, cB, cA2)
        h = g.reshape(a, BLOCK).T.reshape(a, 8, 128)
        h = aba(h, *_unpack_aba(k2i.reshape(a, 8, 128)))
        h = h.reshape(BLOCK, a).T.reshape(a, 8, 128)
        o = aba(h, *_unpack_aba(k3i.reshape(a, 8, 128)))
        contrib = o * vl.reshape(a, 8, 128)
        tiles = jax.ops.segment_sum(
            contrib, seg.y_tile, num_segments=ntiles + 1)
        ay = int(seg.a_y)
        yp = jnp.zeros((ay, 8, 128), contrib.dtype)
        yp = yp.at[:ntiles].set(tiles[:ntiles])
        yp = aba(yp, *_unpack_aba(seg.yp_r2.reshape(ay, 8, 128)))
        yp = yp.reshape(ay, BLOCK).T.reshape(ay, 8, 128)
        yp = aba(yp, *_unpack_aba(seg.yp_mid.reshape(ay, 8, 128)))
        yp = yp.reshape(BLOCK, ay).T.reshape(ay, 8, 128)
        yp = aba(yp, *_unpack_aba(seg.yp_r1.reshape(ay, 8, 128)))
        parts.append(yp.reshape(-1)[:ntiles * BLOCK])
    return jnp.concatenate(parts)[:nrows]
