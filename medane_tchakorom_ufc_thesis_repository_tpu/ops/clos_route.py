"""Clos/Benes routing for arbitrary-pattern gathers built from short ones.

The AIJ program moves data with two gathers, each confined to one
(8, 128) tile:

* row gather (``jnp.take_along_axis`` axis=0, shape (8, C)):
  ``out[i, j] = x[idx[i, j], j]`` — moves within columns, 8-row reach;
* column gather (axis=1, shape (R, 128)):
  ``out[i, j] = x[i, idx[i, j]]`` — moves within rows, 128-column reach.

An arbitrary permutation therefore needs ROUTING.  Two classical facts
(Clos 1953; König's edge-coloring theorem) do all the work:

1. Any permutation of an ``(a, b)`` grid factors as
   (permute within rows) ∘ (permute within columns) ∘ (permute within
   rows).  The middle assignment comes from a proper ``b``-edge-coloring
   of the bipartite multigraph whose edges connect each element's source
   row to its target row: colors = intermediate column index.
2. A Δ-regular bipartite multigraph is Δ-edge-colorable, and for
   Δ = 2^t the coloring is constructible in O(E·t) by repeated Euler
   splitting: walk closed even-length circuits, alternate edges into two
   Δ/2-regular halves, recurse.

Used at two levels by the AIJ SpMV (``ops/aij_pack.py``):

* block level: an arbitrary bijection within one (8, 128) tile =
  row ∘ column ∘ row gather ("A∘B∘A"), routed by an 8-coloring of the
  (source column → target column) multigraph;
* global level: a bijection over M = a·1024 elements = in-block perms +
  two XLA transposes (the ``(a, 1024) ↔ (1024, a)`` reshape-transpose
  exchanges 1024-element blocks with stride-1024 position classes),
  routed by a 1024-coloring of the (source block → target block) graph.

This is the data-movement core the reference delegates to PETSc's CSR
``MatMult`` (``/root/reference/src/utils/utils.c:139-155``).  It was
designed for hardware without a general gather; a GPU gathers natively,
and whether a plain CSR gather beats this program is an open measurement
(ROADMAP D2).  Pure-python Euler walker here; ``native/src/clos.cpp``
provides the O(E log Δ) C++ fast path for large packs.
"""

from __future__ import annotations

import numpy as np


def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _euler_split_py(src: np.ndarray, dst: np.ndarray, nl: int, nr: int):
    """Split a bipartite multigraph with all-even degrees into two
    half-degree edge sets by alternate labeling along closed walks.
    Returns a bool array (True = half B).  Pure python (pointer chasing
    is inherently sequential); the native library replaces this at
    scale."""
    m = src.shape[0]
    nn = nl + nr
    # CSR-style incidence: node -> list of incident edge ids
    deg = np.zeros(nn, np.int64)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst + nl, 1)
    ptr = np.zeros(nn + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    ends = np.concatenate([src, dst + nl])
    eids = np.concatenate([np.arange(m), np.arange(m)])
    inc = eids[np.argsort(ends, kind="stable")]
    cursor = ptr[:-1].copy()  # next incidence slot to try per node
    used = np.zeros(m, bool)
    half = np.zeros(m, bool)
    srcl = src
    dstl = dst + nl
    for start in range(nn):
        while True:
            # find an unused edge at `start`
            c = cursor[start]
            end = ptr[start + 1]
            while c < end and used[inc[c]]:
                c += 1
            cursor[start] = c
            if c >= end:
                break
            # closed walk from `start` (exists: all degrees even)
            node = start
            label = False
            while True:
                c = cursor[node]
                end = ptr[node + 1]
                while c < end and used[inc[c]]:
                    c += 1
                cursor[node] = c
                if c >= end:
                    break  # back at a node with no unused edge == walk closed
                e = inc[c]
                used[e] = True
                half[e] = label
                label = not label
                node = dstl[e] if srcl[e] == node else srcl[e]
    return half


def edge_color(src, dst, nl: int, nr: int, delta: int) -> np.ndarray:
    """Proper edge coloring of a Δ-regular bipartite multigraph with
    Δ = ``delta`` colors (Δ must be a power of two).  ``src`` in
    [0, nl), ``dst`` in [0, nr).  Returns int32 colors in [0, delta).

    Every node must have degree exactly ``delta`` (the AIJ packer pads
    blocks to full 1024 occupancy before routing, which makes the graph
    regular by construction)."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    m = src.shape[0]
    colors = np.zeros(m, np.int32)
    if m == 0 or delta == 1:
        return colors
    if delta & (delta - 1):
        raise ValueError(f"delta must be a power of two, got {delta}")
    from medane_tchakorom_ufc_thesis_repository_tpu import native

    if native.clos_available():
        native.euler_color(src, dst, nl, nr, delta, colors)
        return colors
    # recursion via explicit worklist of (edge-id subset, color offset)
    stack = [(np.arange(m, dtype=np.int64), delta, 0)]
    while stack:
        ids, d, base = stack.pop()
        if d == 1:
            colors[ids] = base
            continue
        half = _euler_split_py(src[ids], dst[ids], nl, nr)
        stack.append((ids[~half], d // 2, base))
        stack.append((ids[half], d // 2, base + d // 2))
    return colors


def block_perm_indices(src_pos: np.ndarray, dst_pos: np.ndarray):
    """Decompose an arbitrary bijection within one 1024-element block
    into the three gather index maps "A∘B∘A":

        t   = A1:  t[i', l]  = blk[cA1[i', l], l]      (sublane gather)
        u   = B :  u[i', l'] = t[i', cB[i', l']]       (lane gather)
        out = A2:  out[i, l'] = u[cA2[i, l'], l']      (sublane gather)

    so that ``out[dst] = blk[src]`` elementwise.  ``src_pos``/``dst_pos``
    are int arrays of 1024 in-block offsets (i*128 + lane), together
    covering all offsets exactly once on each side.

    Routed by an 8-edge-coloring of the (source lane -> target lane)
    multigraph (128+128 nodes, 8-regular): the color is the intermediate
    sublane each element parks in between the two lane-column moves.
    Returns three (8, 128) int32 arrays."""
    src_pos = np.asarray(src_pos, np.int64)
    dst_pos = np.asarray(dst_pos, np.int64)
    s_i, s_l = src_pos // 128, src_pos % 128
    d_i, d_l = dst_pos // 128, dst_pos % 128
    psi = edge_color(s_l, d_l, 128, 128, 8)
    cA1 = np.zeros((8, 128), np.int32)
    cB = np.zeros((8, 128), np.int32)
    cA2 = np.zeros((8, 128), np.int32)
    cA1[psi, s_l] = s_i
    cB[psi, d_l] = s_l
    cA2[d_i, d_l] = psi
    return cA1, cB, cA2


def apply_block_perm_np(blk: np.ndarray, cA1, cB, cA2) -> np.ndarray:
    """Numpy reference of the A∘B∘A in-block permutation (the kernels'
    exact semantics; used by tests and the pack-time self-check)."""
    t = np.take_along_axis(blk, cA1, axis=0)
    u = np.take_along_axis(t, cB, axis=1)
    return np.take_along_axis(u, cA2, axis=0)
