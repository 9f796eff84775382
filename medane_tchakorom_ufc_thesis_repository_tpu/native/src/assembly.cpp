// Native assembly kernels: Poisson stencil -> ELL/DIA planes, COO packing.
//
// The native counterpart of the reference's C assembly layer
// (poisson2DMatrix src/utils/utils.c:247-293, poisson3DMatrix
// utils.c:30-121, MatSetValues-based AIJ fill).  Host-side problem
// construction is the one part of this framework that is not device
// compute; for production-size grids (8192^2 ~ 6.7e7 rows) the Python
// loop-free numpy path still burns seconds and transient memory, so the
// builders here fill caller-allocated buffers in one parallel pass.
//
// Exposed C ABI (ctypes-friendly):
//   poisson2d_ell / poisson3d_ell  — direct ELL planes (width 5 / 7)
//   poisson2d_dia / poisson3d_dia  — direct DIA planes (5 / 7 diagonals)
//   coo_to_ell                     — general COO -> ELL packing
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC assembly.cpp

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// 2D 5-point: row i*n+j; slots [self, north, south, west, east]
// (padded slots: index 0, value 0 — same convention as core.poisson)
// ---------------------------------------------------------------------
void poisson2d_ell(int64_t m, int64_t n, double diag, double off,
                   int32_t* indices, double* values) {
    const int64_t w = 5;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t j = 0; j < n; ++j) {
            const int64_t row = i * n + j;
            int32_t* idx = indices + row * w;
            double* val = values + row * w;
            int64_t k = 0;
            // entries ordered by column index (lexsort parity with
            // core.poisson.coo_to_ell)
            if (i > 0)     { idx[k] = (int32_t)(row - n); val[k++] = off; }
            if (j > 0)     { idx[k] = (int32_t)(row - 1); val[k++] = off; }
            idx[k] = (int32_t)row; val[k++] = diag;
            if (j < n - 1) { idx[k] = (int32_t)(row + 1); val[k++] = off; }
            if (i < m - 1) { idx[k] = (int32_t)(row + n); val[k++] = off; }
            for (; k < w; ++k) { idx[k] = 0; val[k] = 0.0; }
        }
    }
}

// ---------------------------------------------------------------------
// 3D 7-point: row ix*ny*nz + iy*nz + iz (x slowest, matching the
// reference's depth-loop unknown order)
// ---------------------------------------------------------------------
void poisson3d_ell(int64_t nx, int64_t ny, int64_t nz, double diag,
                   double off, int32_t* indices, double* values) {
    const int64_t w = 7;
    const int64_t sx = ny * nz;
#pragma omp parallel for schedule(static)
    for (int64_t ix = 0; ix < nx; ++ix) {
        for (int64_t iy = 0; iy < ny; ++iy) {
            for (int64_t iz = 0; iz < nz; ++iz) {
                const int64_t row = ix * sx + iy * nz + iz;
                int32_t* idx = indices + row * w;
                double* val = values + row * w;
                int64_t k = 0;
                if (ix > 0)      { idx[k] = (int32_t)(row - sx); val[k++] = off; }
                if (iy > 0)      { idx[k] = (int32_t)(row - nz); val[k++] = off; }
                if (iz > 0)      { idx[k] = (int32_t)(row - 1);  val[k++] = off; }
                idx[k] = (int32_t)row; val[k++] = diag;
                if (iz < nz - 1) { idx[k] = (int32_t)(row + 1);  val[k++] = off; }
                if (iy < ny - 1) { idx[k] = (int32_t)(row + nz); val[k++] = off; }
                if (ix < nx - 1) { idx[k] = (int32_t)(row + sx); val[k++] = off; }
                for (; k < w; ++k) { idx[k] = 0; val[k] = 0.0; }
            }
        }
    }
}

// ---------------------------------------------------------------------
// DIA builders: offsets fixed-order; data row-aligned (data[d*n + i] =
// A[i, i+off_d], zero when out of band/boundary-truncated)
// 2D offsets: [-n, -1, 0, 1, n]; 3D: [-ny*nz, -nz, -1, 0, 1, nz, ny*nz]
// ---------------------------------------------------------------------
void poisson2d_dia(int64_t m, int64_t n, double diag, double off,
                   double* data /* (5, m*n) */) {
    const int64_t size = m * n;
    std::memset(data, 0, sizeof(double) * 5 * size);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t j = 0; j < n; ++j) {
            const int64_t row = i * n + j;
            if (i > 0)     data[0 * size + row] = off;   // -n
            if (j > 0)     data[1 * size + row] = off;   // -1
            data[2 * size + row] = diag;                 //  0
            if (j < n - 1) data[3 * size + row] = off;   // +1
            if (i < m - 1) data[4 * size + row] = off;   // +n
        }
    }
}

void poisson3d_dia(int64_t nx, int64_t ny, int64_t nz, double diag,
                   double off, double* data /* (7, nx*ny*nz) */) {
    const int64_t size = nx * ny * nz;
    const int64_t sx = ny * nz;
    std::memset(data, 0, sizeof(double) * 7 * size);
#pragma omp parallel for schedule(static)
    for (int64_t ix = 0; ix < nx; ++ix) {
        for (int64_t iy = 0; iy < ny; ++iy) {
            for (int64_t iz = 0; iz < nz; ++iz) {
                const int64_t row = ix * sx + iy * nz + iz;
                if (ix > 0)      data[0 * size + row] = off;  // -sx
                if (iy > 0)      data[1 * size + row] = off;  // -nz
                if (iz > 0)      data[2 * size + row] = off;  // -1
                data[3 * size + row] = diag;                  //  0
                if (iz < nz - 1) data[4 * size + row] = off;  // +1
                if (iy < ny - 1) data[5 * size + row] = off;  // +nz
                if (ix < nx - 1) data[6 * size + row] = off;  // +sx
            }
        }
    }
}

// ---------------------------------------------------------------------
// General COO -> ELL.  Requires entries pre-sorted by (row, col) — the
// Python wrapper lexsorts.  Returns 0 on success, -1 if a row exceeds
// the ELL width.
// ---------------------------------------------------------------------
int32_t coo_to_ell(int64_t nnz, int64_t nrows, int64_t width,
                   const int64_t* rows, const int64_t* cols,
                   const double* vals,
                   int32_t* indices, double* values) {
    std::memset(indices, 0, sizeof(int32_t) * nrows * width);
    std::memset(values, 0, sizeof(double) * nrows * width);
    int64_t slot = 0;
    int64_t prev_row = -1;
    for (int64_t k = 0; k < nnz; ++k) {
        const int64_t r = rows[k];
        slot = (r == prev_row) ? slot + 1 : 0;
        prev_row = r;
        if (slot >= width) return -1;
        indices[r * width + slot] = (int32_t)cols[k];
        values[r * width + slot] = vals[k];
    }
    return 0;
}

// ---------------------------------------------------------------------
// BSR (block-ELL) pack: COO -> per-block-row slots.  The numpy
// reference (`core.operators._bsr_pack_np`) spends its time in a
// sort-based np.unique over 64-bit keys (~24 s at 42M nnz on this
// host); here a counting-sort bucket by block row + per-row small
// sorts, OpenMP over block rows (~10-20x).
//
// Phase 1 (bsr_pack_plan): bucket entry ids by block row (counting
// sort into `order`), sort each row's segment by block column, assign
// slot ids (position-aligned with `order`), return the max distinct
// block count (the shared padded width), or -1 on bad input.
// Phase 2 (bsr_pack_fill): scatter block-column ids and TRANSPOSED
// values (values[r, w, c%bs, r%bs] — the layout BSR._blockmv
// contracts over) using the phase-1 plan.  Parallel over
// block rows — each row's slots are touched by exactly one thread.
// ---------------------------------------------------------------------
int64_t bsr_pack_plan(int64_t nnz, int64_t nrows, int64_t ncols,
                      int64_t bs, const int64_t* rows,
                      const int64_t* cols, int64_t* order,
                      int64_t* rowptr, int32_t* slot) {
    if (bs <= 0 || nrows <= 0 || ncols <= 0) return -1;
    const int64_t nbr = (nrows + bs - 1) / bs;
    std::vector<int64_t> counts(nbr, 0);
    for (int64_t e = 0; e < nnz; ++e) {
        // full bounds check on BOTH dimensions: a negative column
        // would make `cols[e] % bs` negative in the fill phase — an
        // out-of-bounds heap write
        if (rows[e] < 0 || rows[e] >= nrows
            || cols[e] < 0 || cols[e] >= ncols) return -1;
        counts[rows[e] / bs]++;
    }
    rowptr[0] = 0;
    for (int64_t r = 0; r < nbr; ++r) rowptr[r + 1] = rowptr[r] + counts[r];
    std::vector<int64_t> pos(rowptr, rowptr + nbr);
    for (int64_t e = 0; e < nnz; ++e) order[pos[rows[e] / bs]++] = e;

    int64_t width = 1;
#pragma omp parallel for schedule(dynamic, 16) reduction(max : width)
    for (int64_t r = 0; r < nbr; ++r) {
        const int64_t lo = rowptr[r], hi = rowptr[r + 1];
        std::sort(order + lo, order + hi,
                  [&](int64_t a, int64_t b) {
                      return cols[a] / bs < cols[b] / bs;
                  });
        int64_t distinct = 0;
        int64_t prev_bc = -1;
        for (int64_t k = lo; k < hi; ++k) {
            const int64_t bc = cols[order[k]] / bs;
            if (bc != prev_bc) {
                distinct++;
                prev_bc = bc;
            }
            slot[k] = (int32_t)(distinct - 1);
        }
        if (distinct > width) width = distinct;
    }
    return width;
}

void bsr_pack_fill(int64_t nnz, int64_t nrows, int64_t bs, int64_t width,
                   const int64_t* rows, const int64_t* cols,
                   const double* vals, const int64_t* order,
                   const int64_t* rowptr, const int32_t* slot,
                   int32_t* indices, double* values) {
    (void)nnz;
    const int64_t nbr = (nrows + bs - 1) / bs;
    std::memset(indices, 0, sizeof(int32_t) * nbr * width);
    std::memset(values, 0, sizeof(double) * nbr * width * bs * bs);
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t r = 0; r < nbr; ++r) {
        for (int64_t k = rowptr[r]; k < rowptr[r + 1]; ++k) {
            const int64_t e = order[k];
            const int64_t s = slot[k];
            const int64_t bc = cols[e] / bs;
            indices[r * width + s] = (int32_t)bc;
            // stored transposed: [j = c%bs][i = r%bs]
            values[((r * width + s) * bs + (cols[e] % bs)) * bs
                   + (rows[e] % bs)] += vals[e];
        }
    }
}

}  // extern "C"
