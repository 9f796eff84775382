// Euler-split edge coloring for Clos gather routing (ops/clos_route.py).
//
// Proper Δ-edge-coloring of a Δ-regular bipartite multigraph, Δ = 2^t,
// by recursive Euler splitting: walk closed circuits (even length in a
// bipartite graph), label edges alternately into two Δ/2-regular
// halves, recurse t levels.  O(E·t) time, O(E) memory.
//
// This is the host-side routing step of the AIJ SpMV — the analog
// of the CSR assembly the reference does once per matrix
// (create_matrix_sparse, /root/reference/src/utils/utils.c:139-155);
// the python fallback walks the same circuits ~50x slower.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o _clos.so clos.cpp

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// Split edges[ids[0..m)] into halves A/B (out: half flag per position in
// ids).  Degrees of every node within this edge subset must be even.
void euler_split(int64_t m, const int64_t* ids, const int64_t* src,
                 const int64_t* dst, int64_t nl, int64_t nr,
                 std::vector<uint8_t>& half, std::vector<uint8_t>& used,
                 std::vector<int64_t>& deg, std::vector<int64_t>& ptr,
                 std::vector<int64_t>& inc, std::vector<int64_t>& cursor,
                 std::vector<int64_t>& pos_of) {
  const int64_t nn = nl + nr;
  deg.assign(nn, 0);
  for (int64_t k = 0; k < m; ++k) {
    const int64_t e = ids[k];
    ++deg[src[e]];
    ++deg[dst[e] + nl];
    pos_of[e] = k;
  }
  ptr.resize(nn + 1);
  ptr[0] = 0;
  for (int64_t v = 0; v < nn; ++v) ptr[v + 1] = ptr[v] + deg[v];
  inc.resize(2 * m);
  {
    std::vector<int64_t>& fill = deg;  // reuse as fill cursor
    for (int64_t v = 0; v < nn; ++v) fill[v] = ptr[v];
    for (int64_t k = 0; k < m; ++k) {
      const int64_t e = ids[k];
      inc[fill[src[e]]++] = e;
      inc[fill[dst[e] + nl]++] = e;
    }
  }
  cursor.assign(ptr.begin(), ptr.end() - 1);
  for (int64_t k = 0; k < m; ++k) used[ids[k]] = 0;
  for (int64_t start = 0; start < nn; ++start) {
    for (;;) {
      int64_t c = cursor[start];
      const int64_t end = ptr[start + 1];
      while (c < end && used[inc[c]]) ++c;
      cursor[start] = c;
      if (c >= end) break;
      // closed walk from `start`: can only get stuck back at `start`
      // (every other node keeps even remaining degree)
      int64_t node = start;
      uint8_t label = 0;
      for (;;) {
        int64_t cc = cursor[node];
        const int64_t nend = ptr[node + 1];
        while (cc < nend && used[inc[cc]]) ++cc;
        cursor[node] = cc;
        if (cc >= nend) break;
        const int64_t e = inc[cc];
        used[e] = 1;
        half[pos_of[e]] = label;
        label = 1 - label;
        const int64_t s = src[e], d = dst[e] + nl;
        node = (s == node) ? d : s;
      }
    }
  }
}

}  // namespace

extern "C" {

// Color m edges of a delta-regular bipartite multigraph (src in [0,nl),
// dst in [0,nr)) with delta colors (delta a power of two).  colors: out.
void euler_color(int64_t m, int64_t nl, int64_t nr, int64_t delta,
                 const int64_t* src, const int64_t* dst, int32_t* colors) {
  if (m == 0) return;
  std::vector<int64_t> ids(m);
  for (int64_t k = 0; k < m; ++k) ids[k] = k;
  std::vector<uint8_t> half(m), used(m);
  std::vector<int64_t> deg, ptr, inc, cursor, pos_of(m);
  // iterative recursion over (range of a reordered id list, delta, base)
  struct Item { int64_t lo, hi, d; int32_t base; };
  std::vector<Item> stack;
  std::vector<int64_t> scratch(m);
  stack.push_back({0, m, delta, 0});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const int64_t len = it.hi - it.lo;
    if (it.d == 1) {
      for (int64_t k = it.lo; k < it.hi; ++k) colors[ids[k]] = it.base;
      continue;
    }
    euler_split(len, ids.data() + it.lo, src, dst, nl, nr, half, used,
                deg, ptr, inc, cursor, pos_of);
    // stable partition ids[lo..hi) by half flag
    int64_t a = 0, b = 0;
    for (int64_t k = 0; k < len; ++k) {
      if (half[k]) scratch[b++] = ids[it.lo + k];
      else         ids[it.lo + a++] = ids[it.lo + k];
    }
    for (int64_t k = 0; k < b; ++k) ids[it.lo + a + k] = scratch[k];
    const int32_t d2 = static_cast<int32_t>(it.d / 2);
    stack.push_back({it.lo, it.lo + a, it.d / 2, it.base});
    stack.push_back({it.lo + a, it.hi, it.d / 2, it.base + d2});
  }
}

// Batched 8-colorings for per-block bijections: nb blocks, each 1024
// edges (src/dst lanes in [0,128)), colors out per edge.
void euler_color_blocks(int64_t nb, const int64_t* src, const int64_t* dst,
                        int32_t* colors) {
  for (int64_t b = 0; b < nb; ++b) {
    euler_color(1024, 128, 128, 8, src + b * 1024, dst + b * 1024,
                colors + b * 1024);
  }
}

// AIJ g-block greedy placement (the pack-time hot loop of
// ops/aij_pack._pack_gblocks — the K1 gather constraint: within a
// block, cells in row i whose source lane is l must all read the same
// source row; spill-on-conflict).  Elements arrive SORTED by chunk
// (`order` indexes the original arrays).  Writes per-POSITION outputs
// (elem_order, src_off, block_of; positions 0..m) and per-block chunk
// ids (capacity m + 1).  Returns the block count.
int64_t aij_pack_gblocks(int64_t m, const int64_t* chunk,
                         const int32_t* s_all, const int32_t* l_all,
                         const int64_t* order, int64_t* elem_order,
                         int32_t* src_off, int64_t* block_of,
                         int64_t* chunk_of_block) {
  std::vector<int16_t> claim(8 * 128);
  std::vector<int32_t> load(8);
  std::vector<int64_t> queue, deferred;
  int64_t nb = 0, pos = 0, k = 0;
  while (k < m) {
    const int64_t q = chunk[order[k]];
    int64_t k2 = k;
    while (k2 < m && chunk[order[k2]] == q) ++k2;
    queue.assign(order + k, order + k2);
    while (!queue.empty()) {
      std::fill(claim.begin(), claim.end(), int16_t{-1});
      std::fill(load.begin(), load.end(), 0);
      deferred.clear();
      int32_t placed = 0;
      for (std::size_t qi = 0; qi < queue.size(); ++qi) {
        const int64_t e = queue[qi];
        const int32_t s = s_all[e], l = l_all[e];
        bool done = false;
        for (int i = 0; i < 8; ++i) {
          int16_t& c = claim[i * 128 + l];
          if (load[i] < 128 && (c < 0 || c == s)) {
            c = static_cast<int16_t>(s);
            elem_order[pos] = e;
            src_off[pos] = i * 128 + load[i];
            block_of[pos] = nb;
            ++load[i];
            ++placed;
            ++pos;
            done = true;
            break;
          }
        }
        if (!done) deferred.push_back(e);
        if (placed == 1024) {
          deferred.insert(deferred.end(), queue.begin() + qi + 1,
                          queue.end());
          break;
        }
      }
      chunk_of_block[nb++] = q;
      queue.swap(deferred);
    }
    k = k2;
  }
  return nb;
}

}  // extern "C"
