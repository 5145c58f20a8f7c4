// Native host kernels for ginkgo_tpu.
//
// The reference implements its runtime tier in C++; the TPU build keeps the
// compute path in XLA/Pallas, and this library provides the C++ host tier
// for the work that stays on the CPU and is too slow in Python:
//   * MatrixMarket coordinate parsing (mtx_io.hpp read_raw analog)
//   * triangular level-set computation (sparsity analysis of
//     cuda/solver/common_trs_kernels.cuh's level scheduling)
//   * ILU contribution-pair enumeration (csr_lookup-style symbolics feeding
//     the ParILU/ParILUT device sweeps)
//   * COO canonicalization (sort_row_major + sum_duplicates kernels of
//     core/base/device_matrix_data_kernels.hpp)
//
// Exposed as a plain C ABI consumed via ctypes; every entry point has a
// numpy fallback on the Python side, so the library is an accelerator, not
// a hard dependency.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <numeric>
#include <type_traits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MatrixMarket coordinate reader.
// Pass 1: gt_mtx_open parses the header and returns dims + nnz (and keeps
// no state); pass 2: gt_mtx_read re-opens and fills caller-allocated arrays.
// Returns 0 on success, negative error codes otherwise.
// ---------------------------------------------------------------------------

static int parse_header(FILE* f, char* fmt, char* field, char* symm,
                        int64_t* nrows, int64_t* ncols, int64_t* nnz) {
    char line[1024];
    if (!fgets(line, sizeof line, f)) return -2;
    char banner[64], object[64];
    if (sscanf(line, "%63s %63s %63s %63s %63s", banner, object, fmt, field,
               symm) != 5)
        return -3;
    if (strcmp(banner, "%%MatrixMarket") != 0 || strcmp(object, "matrix"))
        return -3;
    for (char* p = fmt; *p; ++p) *p = (char)tolower(*p);
    for (char* p = field; *p; ++p) *p = (char)tolower(*p);
    for (char* p = symm; *p; ++p) *p = (char)tolower(*p);
    // skip comments
    do {
        if (!fgets(line, sizeof line, f)) return -4;
    } while (line[0] == '%' || line[0] == '\n' || line[0] == '\r');
    if (strcmp(fmt, "coordinate") == 0) {
        if (sscanf(line, "%ld %ld %ld", (long*)nrows, (long*)ncols,
                   (long*)nnz) != 3)
            return -5;
    } else {
        if (sscanf(line, "%ld %ld", (long*)nrows, (long*)ncols) != 2)
            return -5;
        *nnz = (*nrows) * (*ncols);
    }
    return 0;
}

int gt_mtx_header(const char* path, int64_t* nrows, int64_t* ncols,
                  int64_t* nnz, int32_t* is_complex, int32_t* is_pattern,
                  int32_t* symmetry /*0 gen,1 sym,2 herm,3 skew*/,
                  int32_t* is_coordinate) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char fmt[64], field[64], symm[64];
    int rc = parse_header(f, fmt, field, symm, nrows, ncols, nnz);
    fclose(f);
    if (rc) return rc;
    *is_coordinate = strcmp(fmt, "coordinate") == 0;
    *is_complex = strcmp(field, "complex") == 0;
    *is_pattern = strcmp(field, "pattern") == 0;
    *symmetry = strcmp(symm, "symmetric") == 0    ? 1
                : strcmp(symm, "hermitian") == 0  ? 2
                : strcmp(symm, "skew-symmetric") == 0 ? 3
                                                      : 0;
    return 0;
}

// strtod-based fast line scanning; fills rows/cols (0-based) and values
// (interleaved re/im when complex).
int gt_mtx_read_coord(const char* path, int64_t nnz, int32_t is_complex,
                      int32_t is_pattern, int64_t* rows, int64_t* cols,
                      double* vals) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char fmt[64], field[64], symm[64];
    int64_t nr, nc, nz;
    int rc = parse_header(f, fmt, field, symm, &nr, &nc, &nz);
    if (rc) {
        fclose(f);
        return rc;
    }
    // stream entries with strtol/strtod (much faster than Python splits)
    std::vector<char> buf(1 << 20);
    setvbuf(f, buf.data(), _IOFBF, buf.size());
    char line[1024];
    for (int64_t k = 0; k < nnz; ++k) {
        if (!fgets(line, sizeof line, f)) {
            fclose(f);
            return -6;
        }
        char* p = line;
        char* q = p;
        rows[k] = strtol(p, &q, 10) - 1;
        if (q == p) {   // malformed/blank line: strtol consumed nothing
            fclose(f);
            return -7;
        }
        p = q;
        cols[k] = strtol(p, &q, 10) - 1;
        if (q == p) {
            fclose(f);
            return -7;
        }
        p = q;
        if (rows[k] < 0 || rows[k] >= nr || cols[k] < 0 || cols[k] >= nc) {
            fclose(f);
            return -8;  // index out of the declared dimensions
        }
        if (is_pattern) {
            vals[k] = 1.0;
        } else if (is_complex) {
            vals[2 * k] = strtod(p, &q);
            if (q == p) { fclose(f); return -7; }
            p = q;
            vals[2 * k + 1] = strtod(p, &q);
            if (q == p) { fclose(f); return -7; }
        } else {
            vals[k] = strtod(p, &q);
            if (q == p) { fclose(f); return -7; }
        }
    }
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// Triangular level sets: level[r] = 1 + max(level[deps]) over the rows'
// off-diagonal entries.  rows must be sorted ascending; ptr is the CSR-style
// row pointer into (rows, cols).
// ---------------------------------------------------------------------------
int gt_compute_levels(int64_t n, const int64_t* ptr, const int64_t* cols,
                      int32_t lower, int64_t* level) {
    if (lower) {
        for (int64_t r = 0; r < n; ++r) {
            int64_t lv = 0;
            for (int64_t e = ptr[r]; e < ptr[r + 1]; ++e) {
                int64_t c = cols[e];
                if (c < r && level[c] + 1 > lv) lv = level[c] + 1;
            }
            level[r] = lv;
        }
    } else {
        for (int64_t r = n - 1; r >= 0; --r) {
            int64_t lv = 0;
            for (int64_t e = ptr[r]; e < ptr[r + 1]; ++e) {
                int64_t c = cols[e];
                if (c > r && level[c] + 1 > lv) lv = level[c] + 1;
            }
            level[r] = lv;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// ILU contribution pairs: for every output entry (i,j) in L (i>j, first
// nl outputs) or U (i<=j), enumerate (l_idx, u_idx) with
// lc[l_idx] == ur[u_idx] == k and k < min(i, j).
// Two-phase: count, then fill (caller allocates).
// L entries are sorted by row; U entries sorted by column via a CSC-style
// permutation built here.
// ---------------------------------------------------------------------------
static int64_t ilu_pairs_impl(int64_t n, int64_t nl, const int64_t* lr,
                              const int64_t* lc, int64_t nu,
                              const int64_t* ur, const int64_t* uc,
                              int64_t* out_l, int64_t* out_u,
                              int64_t* out_o) {
    // group L entries by row, U entries by column
    std::vector<int64_t> lptr(n + 1, 0), uptr(n + 1, 0);
    for (int64_t e = 0; e < nl; ++e) lptr[lr[e] + 1]++;
    for (int64_t e = 0; e < nu; ++e) uptr[uc[e] + 1]++;
    for (int64_t i = 0; i < n; ++i) {
        lptr[i + 1] += lptr[i];
        uptr[i + 1] += uptr[i];
    }
    std::vector<int64_t> lidx(nl), uidx(nu), lpos(lptr.begin(),
                                                  lptr.end() - 1),
        upos(uptr.begin(), uptr.end() - 1);
    for (int64_t e = 0; e < nl; ++e) lidx[lpos[lr[e]]++] = e;
    for (int64_t e = 0; e < nu; ++e) uidx[upos[uc[e]]++] = e;
    // U-row lookup per column entry: map (k -> u_idx) per column j via a
    // scratch array indexed by k
    std::vector<int64_t> urow_of(n, -1);
    int64_t count = 0;
    bool fill = out_l != nullptr;
    // process outputs column-by-... we need per (i, j). Iterate outputs:
    // for L entry o at (i, j): pairs = L-row(i) ∩ U-col(j) with k < j.
    // Build per-column map on demand: group outputs by their column.
    // Simpler O(total * log)-free approach: for each column j, mark U-col(j)
    // entries in urow_of, then scan all outputs with that column.
    // Outputs with column j: L entries (i > j) and U entries (i <= j).
    // Group both by column:
    std::vector<int64_t> lcol_ptr(n + 1, 0), ucol_ptr = uptr;
    for (int64_t e = 0; e < nl; ++e) lcol_ptr[lc[e] + 1]++;
    for (int64_t i = 0; i < n; ++i) lcol_ptr[i + 1] += lcol_ptr[i];
    std::vector<int64_t> lcol_idx(nl),
        lcpos(lcol_ptr.begin(), lcol_ptr.end() - 1);
    for (int64_t e = 0; e < nl; ++e) lcol_idx[lcpos[lc[e]]++] = e;

    for (int64_t j = 0; j < n; ++j) {
        // mark U column j: k -> u_idx
        for (int64_t t = uptr[j]; t < uptr[j + 1]; ++t) {
            int64_t e = uidx[t];
            urow_of[ur[e]] = e;
        }
        // L outputs in column j
        for (int64_t t = lcol_ptr[j]; t < lcol_ptr[j + 1]; ++t) {
            int64_t o = lcol_idx[t];
            int64_t i = lr[o];
            int64_t lim = i < j ? i : j;
            for (int64_t s = lptr[i]; s < lptr[i + 1]; ++s) {
                int64_t le = lidx[s];
                int64_t k = lc[le];
                if (k < lim && urow_of[k] >= 0) {
                    if (fill) {
                        out_l[count] = le;
                        out_u[count] = urow_of[k];
                        out_o[count] = o;
                    }
                    ++count;
                }
            }
        }
        // U outputs in column j
        for (int64_t t = uptr[j]; t < uptr[j + 1]; ++t) {
            int64_t o = uidx[t];
            int64_t i = ur[o];
            int64_t lim = i < j ? i : j;
            for (int64_t s = lptr[i]; s < lptr[i + 1]; ++s) {
                int64_t le = lidx[s];
                int64_t k = lc[le];
                if (k < lim && urow_of[k] >= 0) {
                    if (fill) {
                        out_l[count] = le;
                        out_u[count] = urow_of[k];
                        out_o[count] = nl + o;
                    }
                    ++count;
                }
            }
        }
        // unmark
        for (int64_t t = uptr[j]; t < uptr[j + 1]; ++t)
            urow_of[ur[uidx[t]]] = -1;
    }
    return count;
}

int64_t gt_ilu_pairs_count(int64_t n, int64_t nl, const int64_t* lr,
                           const int64_t* lc, int64_t nu, const int64_t* ur,
                           const int64_t* uc) {
    return ilu_pairs_impl(n, nl, lr, lc, nu, ur, uc, nullptr, nullptr,
                          nullptr);
}

int64_t gt_ilu_pairs_fill(int64_t n, int64_t nl, const int64_t* lr,
                          const int64_t* lc, int64_t nu, const int64_t* ur,
                          const int64_t* uc, int64_t* out_l, int64_t* out_u,
                          int64_t* out_o) {
    return ilu_pairs_impl(n, nl, lr, lc, nu, ur, uc, out_l, out_u, out_o);
}

// ---------------------------------------------------------------------------
// Row-major restricted-product pair enumeration for the fixed-universe
// device ParILUT (the packed-slot analog of the reference's on-device
// sweep kernels, common/cuda_hip/factorization/par_ilut_sweep_kernels.cpp).
// Inputs are the ROW-MAJOR-SORTED strictly-lower (L) and upper-with-diag
// (U) halves of the slot universe.  Output slot o (an index into the
// concatenated [L; U] arrays) at matrix position (i, j) gets one pair
// per k in L-row(i) ∩ U-col(j) with k < min(i, j): out_l -> L slot of
// (i, k), out_u -> U slot of (k, j), out_o -> o.  Pairs are emitted
// sorted by (out_o asc, out_u asc) — U is row-major so the U-slot index
// grows with k — which is exactly the canonical order the packed-layout
// planner wants; no host lexsort over the O(flops) pair list is needed.
// int32 outputs halve the plan footprint; a count above `cap` (or 2^31)
// returns -1 and the caller falls back.
static int64_t ilut_pairs_rowmajor_impl(
    int64_t n, int64_t nl, const int64_t* lr, const int64_t* lc, int64_t nu,
    const int64_t* ur, const int64_t* uc, int32_t* out_l, int32_t* out_u,
    int32_t* out_o, int64_t cap) {
    // CSR row pointers for L (rows sorted) and CSC for U (cols; the
    // per-column slot lists are row-ascending because U is row-major).
    std::vector<int64_t> lptr(n + 1, 0), ucp(n + 1, 0);
    for (int64_t e = 0; e < nl; ++e) lptr[lr[e] + 1]++;
    for (int64_t e = 0; e < nu; ++e) ucp[uc[e] + 1]++;
    for (int64_t i = 0; i < n; ++i) {
        lptr[i + 1] += lptr[i];
        ucp[i + 1] += ucp[i];
    }
    std::vector<int64_t> ucol_slot(nu), ucol_row(nu),
        upos(ucp.begin(), ucp.end() - 1);
    for (int64_t e = 0; e < nu; ++e) {
        int64_t p = upos[uc[e]]++;
        ucol_slot[p] = e;
        ucol_row[p] = ur[e];
    }
    bool fill = out_l != nullptr;
    int64_t count = 0;
    auto emit = [&](int64_t i, int64_t j, int64_t o) -> bool {
        int64_t lim = i < j ? i : j;
        int64_t a = lptr[i], aEnd = lptr[i + 1];
        int64_t b = ucp[j], bEnd = ucp[j + 1];
        while (a < aEnd && b < bEnd) {
            int64_t ka = lc[a];
            if (ka >= lim) break;
            int64_t kb = ucol_row[b];
            if (ka < kb) {
                ++a;
            } else if (kb < ka) {
                if (kb >= lim) break;
                ++b;
            } else {
                if (fill) {
                    if (count >= cap) return false;
                    out_l[count] = (int32_t)a;
                    out_u[count] = (int32_t)ucol_slot[b];
                    out_o[count] = (int32_t)o;
                }
                ++count;
                ++a;
                ++b;
            }
        }
        return true;
    };
    for (int64_t o = 0; o < nl; ++o)
        if (!emit(lr[o], lc[o], o)) return -1;
    for (int64_t o = 0; o < nu; ++o)
        if (!emit(ur[o], uc[o], nl + o)) return -1;
    if (count > cap || count > (int64_t)INT32_MAX || nl > INT32_MAX ||
        nu + nl > INT32_MAX)
        return -1;
    return count;
}

int64_t gt_ilut_pairs_rowmajor_count(int64_t n, int64_t nl,
                                     const int64_t* lr, const int64_t* lc,
                                     int64_t nu, const int64_t* ur,
                                     const int64_t* uc, int64_t cap) {
    return ilut_pairs_rowmajor_impl(n, nl, lr, lc, nu, ur, uc, nullptr,
                                    nullptr, nullptr, cap);
}

int64_t gt_ilut_pairs_rowmajor_fill(int64_t n, int64_t nl, const int64_t* lr,
                                    const int64_t* lc, int64_t nu,
                                    const int64_t* ur, const int64_t* uc,
                                    int32_t* out_l, int32_t* out_u,
                                    int32_t* out_o, int64_t cap) {
    return ilut_pairs_rowmajor_impl(n, nl, lr, lc, nu, ur, uc, out_l, out_u,
                                    out_o, cap);
}

// Same enumeration for ParICT's tril(L L^H): output slot o at (i, j)
// (i >= j, both in the row-major lower universe incl. the diagonal) gets
// one pair per k in L-row(i) ∩ L-row(j), k < j: out_1 -> slot of (i, k),
// out_2 -> slot of (j, k) (to be conjugated), out_o -> o.  Row-major L
// makes out_2 ascend with k, so pairs are (o, out_2)-sorted.
static int64_t ict_pairs_rowmajor_impl(int64_t n, int64_t nl,
                                       const int64_t* lr, const int64_t* lc,
                                       int32_t* out_1, int32_t* out_2,
                                       int32_t* out_o, int64_t cap) {
    std::vector<int64_t> lptr(n + 1, 0);
    for (int64_t e = 0; e < nl; ++e) lptr[lr[e] + 1]++;
    for (int64_t i = 0; i < n; ++i) lptr[i + 1] += lptr[i];
    bool fill = out_1 != nullptr;
    int64_t count = 0;
    for (int64_t o = 0; o < nl; ++o) {
        int64_t i = lr[o], j = lc[o];
        int64_t a = lptr[i], aEnd = lptr[i + 1];
        int64_t b = lptr[j], bEnd = lptr[j + 1];
        while (a < aEnd && b < bEnd) {
            int64_t ka = lc[a], kb = lc[b];
            if (ka >= j || kb >= j) break;
            if (ka < kb) {
                ++a;
            } else if (kb < ka) {
                ++b;
            } else {
                if (fill) {
                    if (count >= cap) return -1;
                    out_1[count] = (int32_t)a;
                    out_2[count] = (int32_t)b;
                    out_o[count] = (int32_t)o;
                }
                ++count;
                ++a;
                ++b;
            }
        }
    }
    if (count > cap || count > (int64_t)INT32_MAX || nl > INT32_MAX)
        return -1;
    return count;
}

int64_t gt_ict_pairs_rowmajor_count(int64_t n, int64_t nl, const int64_t* lr,
                                    const int64_t* lc, int64_t cap) {
    return ict_pairs_rowmajor_impl(n, nl, lr, lc, nullptr, nullptr, nullptr,
                                   cap);
}

int64_t gt_ict_pairs_rowmajor_fill(int64_t n, int64_t nl, const int64_t* lr,
                                   const int64_t* lc, int32_t* out_1,
                                   int32_t* out_2, int32_t* out_o,
                                   int64_t cap) {
    return ict_pairs_rowmajor_impl(n, nl, lr, lc, out_1, out_2, out_o, cap);
}

// ---------------------------------------------------------------------------
// COO canonicalization: stable sort by (row, col) + duplicate summation.
// Returns the deduplicated count; arrays are compacted in place.
// ---------------------------------------------------------------------------
int64_t gt_coo_canonicalize(int64_t nnz, int64_t* rows, int64_t* cols,
                            double* vals, int32_t is_complex) {
    std::vector<int64_t> order(nnz);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                         if (rows[a] != rows[b]) return rows[a] < rows[b];
                         return cols[a] < cols[b];
                     });
    std::vector<int64_t> r2(nnz), c2(nnz);
    int64_t vw = is_complex ? 2 : 1;
    std::vector<double> v2(nnz * vw);
    for (int64_t k = 0; k < nnz; ++k) {
        r2[k] = rows[order[k]];
        c2[k] = cols[order[k]];
        for (int64_t w = 0; w < vw; ++w)
            v2[k * vw + w] = vals[order[k] * vw + w];
    }
    int64_t out = -1;
    for (int64_t k = 0; k < nnz; ++k) {
        if (out >= 0 && r2[k] == rows[out] && c2[k] == cols[out]) {
            for (int64_t w = 0; w < vw; ++w) vals[out * vw + w] += v2[k * vw + w];
        } else {
            ++out;
            rows[out] = r2[k];
            cols[out] = c2[k];
            for (int64_t w = 0; w < vw; ++w) vals[out * vw + w] = v2[k * vw + w];
        }
    }
    return out + 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ParILU(T) Gauss-Seidel sweep — the reference's compute_l_u_factors
// (reference/factorization/par_ilut_kernels.cpp:239): row-major in-place
// updates (sequential asynchronous Chow-Patel, which converges where the
// synchronous Jacobi form diverges).
//   L: strict-lower CSR (unit diagonal implicit), values updated in place
//   U: stored ONCE as U^T CSR (per column, rows ascending, diag last);
//      iteration follows U's row-major order via the u2ut position map
//   A: CSR for the a(row, col) lookups (pattern may exceed A's)
// ---------------------------------------------------------------------------
namespace {

template <class V>
void parilut_sweep_impl(int64_t n, const int64_t* a_ptr,
                        const int64_t* a_cols, const V* a_vals,
                        const int64_t* l_ptr, const int64_t* l_cols,
                        V* l_vals, const int64_t* u_ptr,
                        const int64_t* u_cols, const int64_t* u2ut,
                        const int64_t* ut_ptr, const int64_t* ut_rows,
                        V* ut_vals, int64_t iterations) {
    auto a_at = [&](int64_t row, int64_t col) -> V {
        const int64_t* b = a_cols + a_ptr[row];
        const int64_t* e = a_cols + a_ptr[row + 1];
        const int64_t* it = std::lower_bound(b, e, col);
        if (it != e && *it == col) return a_vals[it - a_cols];
        return V(0);
    };
    auto dot = [&](int64_t row, int64_t col) -> V {
        // sum_{k < min(row, col)} l(row, k) * u(k, col), merge walk
        V sum(0);
        int64_t lim = row < col ? row : col;
        int64_t s = l_ptr[row], se = l_ptr[row + 1];
        int64_t t = ut_ptr[col], te = ut_ptr[col + 1];
        while (s < se && t < te) {
            int64_t k = l_cols[s], k2 = ut_rows[t];
            if (k == k2) {
                if (k < lim) sum += l_vals[s] * ut_vals[t];
                ++s;
                ++t;
            } else if (k < k2) {
                ++s;
            } else {
                ++t;
            }
        }
        return sum;
    };
    auto finite = [](V v) {
        double re, im = 0;
        if constexpr (std::is_same_v<V, std::complex<double>>) {
            re = v.real();
            im = v.imag();
        } else {
            re = v;
        }
        return std::isfinite(re) && std::isfinite(im);
    };
    for (int64_t it = 0; it < iterations; ++it) {
        for (int64_t row = 0; row < n; ++row) {
            for (int64_t p = l_ptr[row]; p < l_ptr[row + 1]; ++p) {
                int64_t col = l_cols[p];
                V u_diag = ut_vals[ut_ptr[col + 1] - 1];
                V nv = (a_at(row, col) - dot(row, col)) / u_diag;
                if (finite(nv)) l_vals[p] = nv;
            }
            for (int64_t p = u_ptr[row]; p < u_ptr[row + 1]; ++p) {
                int64_t col = u_cols[p];
                V nv = a_at(row, col) - dot(row, col);
                if (finite(nv)) ut_vals[u2ut[p]] = nv;
            }
        }
    }
}

}  // namespace

extern "C" int gt_parilut_sweep(int64_t n, const int64_t* a_ptr, const int64_t* a_cols,
                     const double* a_vals, const int64_t* l_ptr,
                     const int64_t* l_cols, double* l_vals,
                     const int64_t* u_ptr, const int64_t* u_cols,
                     const int64_t* u2ut, const int64_t* ut_ptr,
                     const int64_t* ut_rows, double* ut_vals,
                     int64_t iterations, int32_t is_complex) {
    if (is_complex) {
        parilut_sweep_impl<std::complex<double>>(
            n, a_ptr, a_cols,
            reinterpret_cast<const std::complex<double>*>(a_vals), l_ptr,
            l_cols, reinterpret_cast<std::complex<double>*>(l_vals), u_ptr,
            u_cols, u2ut, ut_ptr, ut_rows,
            reinterpret_cast<std::complex<double>*>(ut_vals), iterations);
    } else {
        parilut_sweep_impl<double>(n, a_ptr, a_cols, a_vals, l_ptr, l_cols,
                                   l_vals, u_ptr, u_cols, u2ut, ut_ptr,
                                   ut_rows, ut_vals, iterations);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// MC64 maximum-weight bipartite matching (core/reorder/mc64.cpp analog):
// sparse shortest-augmenting-path assignment (Duff-Koster / sparse
// Jonker-Volgenant) with column dual potentials.
//   c:        nonnegative minimization weights (row_max - log2|a|),
//             +inf marks a structural hole (zero entry)
//   dual_u:   in: initial column duals (min over rows of c), out: final
//   p/ip:     row->col and col->row matching (-1 while unmatched)
//   midx:     matched CSR edge index per row (for the scaling recovery)
// Returns 0, or -1 when the matrix is structurally singular.
// ---------------------------------------------------------------------------
#include <limits>
#include <queue>

extern "C" int gt_mc64_match(int64_t n, const int64_t* ptr,
                             const int64_t* cols, const double* c,
                             double* dual_u, int64_t* p, int64_t* ip,
                             int64_t* midx, double tol) {
    const double inf = std::numeric_limits<double>::infinity();
    for (int64_t i = 0; i < n; ++i) p[i] = ip[i] = midx[i] = -1;

    // initial matching: greedy on zero reduced cost (v implicit 0)
    for (int64_t r = 0; r < n; ++r) {
        for (int64_t e = ptr[r]; e < ptr[r + 1]; ++e) {
            int64_t j = cols[e];
            if (ip[j] < 0 && std::abs(c[e] - dual_u[j]) < tol) {
                p[r] = j;
                ip[j] = r;
                midx[r] = e;
                break;
            }
        }
    }

    std::vector<double> dist(n);
    std::vector<int64_t> pred_row(n), pred_edge(n);
    std::vector<uint8_t> done(n);
    std::vector<int64_t> touched;
    using QE = std::pair<double, int64_t>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;

    for (int64_t r0 = 0; r0 < n; ++r0) {
        if (p[r0] >= 0) continue;
        // Dijkstra over alternating paths from the free row r0.  The
        // implicit row dual of a matched row i is c(i, p(i)) - u(p(i));
        // the root's is 0, so edge (r0, j) relaxes to c - u directly.
        touched.clear();
        while (!pq.empty()) pq.pop();
        double lsap = inf;
        int64_t sink = -1;
        auto relax = [&](int64_t i, double base, double vi) {
            for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e) {
                int64_t j = cols[e];
                if (done[j]) continue;
                double w = c[e];
                if (w == inf) continue;
                double nd = base + (w - dual_u[j]) - vi;
                if (nd < dist[j]) {
                    dist[j] = nd;
                    pred_row[j] = i;
                    pred_edge[j] = e;
                    pq.emplace(nd, j);
                }
            }
        };
        std::vector<int64_t>& tl = touched;
        for (int64_t j = 0; j < n; ++j) {
            dist[j] = inf;
            done[j] = 0;
        }
        relax(r0, 0.0, 0.0);
        while (!pq.empty()) {
            auto [dj, j] = pq.top();
            pq.pop();
            if (done[j] || dj > dist[j]) continue;
            if (dj >= lsap) break;
            done[j] = 1;
            tl.push_back(j);
            if (ip[j] < 0) {
                lsap = dj;
                sink = j;
                break;
            }
            int64_t i = ip[j];
            double vi = c[midx[i]] - dual_u[p[i]];
            relax(i, dj, vi);
        }
        if (sink < 0) return -1;       // structurally singular
        // dual update on finalized columns
        for (int64_t j : tl)
            if (j != sink) dual_u[j] += dist[j] - lsap;
        // augment along the predecessor chain
        int64_t j = sink;
        while (true) {
            int64_t i = pred_row[j];
            int64_t e = pred_edge[j];
            int64_t jprev = p[i];      // -1 when i == r0
            p[i] = j;
            ip[j] = i;
            midx[i] = e;
            if (i == r0) break;
            j = jprev;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// AMD — approximate minimum degree ordering (core/reorder/amd.cpp goal;
// clean-room implementation of the Amestoy-Davis-Duff algorithm):
// quotient graph where eliminated pivots become elements, approximate
// external degrees via the one-pass |Le \ Lp| w-trick, supervariable
// merging by adjacency hashing, and aggressive element absorption.
// Input: symmetric pattern CSR (diagonal ignored).  Output: perm such
// that perm[k] = k-th eliminated original index.
// ---------------------------------------------------------------------------
#include <unordered_map>

extern "C" int gt_amd_order(int64_t n, const int64_t* ptr,
                            const int64_t* adj, int64_t* perm) {
    if (n == 0) return 0;
    std::vector<std::vector<int32_t>> vadj(n), eadj(n), evars(n);
    std::vector<int64_t> nv(n, 1), degree(n), esize(n, 0);
    std::vector<uint8_t> is_elem(n, 0), dead_elem(n, 0);
    std::vector<int32_t> child_head(n, -1), child_next(n, -1);
    std::vector<int64_t> mark(n, -1), wtag(n, -1), w(n, 0);

    for (int64_t i = 0; i < n; ++i) {
        auto& a = vadj[i];
        for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e) {
            int32_t j = (int32_t)adj[e];
            if (j != i) a.push_back(j);
        }
        degree[i] = (int64_t)a.size();
    }

    // degree buckets (doubly linked, FIFO: append at tail — the
    // tie-break order measurably affects fill quality)
    std::vector<int32_t> dhead(n + 1, -1), dtail(n + 1, -1), dnext(n, -1),
        dprev(n, -1);
    auto deg_insert = [&](int32_t i) {
        int64_t d = degree[i] < n ? degree[i] : n;
        dnext[i] = -1;
        dprev[i] = dtail[d];
        if (dtail[d] >= 0)
            dnext[dtail[d]] = i;
        else
            dhead[d] = (int32_t)i;
        dtail[d] = (int32_t)i;
    };
    auto deg_remove = [&](int32_t i) {
        int64_t d = degree[i] < n ? degree[i] : n;
        if (dprev[i] >= 0)
            dnext[dprev[i]] = dnext[i];
        else if (dhead[d] == i)
            dhead[d] = dnext[i];
        if (dnext[i] >= 0)
            dprev[dnext[i]] = dprev[i];
        else if (dtail[d] == i)
            dtail[d] = dprev[i];
        dnext[i] = dprev[i] = -1;
    };
    for (int64_t i = 0; i < n; ++i) deg_insert((int32_t)i);

    std::vector<int32_t> Lp;
    std::vector<int32_t> touched_elems;
    int64_t gen = 0;
    int64_t out = 0;
    int64_t mindeg = 0;

    auto emit = [&](int32_t p, auto&& self) -> void {
        perm[out++] = p;
        for (int32_t c = child_head[p]; c >= 0; c = child_next[c])
            self(c, self);
    };

    while (out < n) {
        // pivot: lowest-degree live principal variable
        int32_t p = -1;
        while (mindeg <= n) {
            p = dhead[mindeg];
            if (p >= 0) break;
            ++mindeg;
        }
        if (p < 0) break;   // defensive; should not happen
        deg_remove(p);

        // ---- build Lp = union of pivot's vars + element vars
        ++gen;
        Lp.clear();
        mark[p] = gen;
        for (int32_t j : vadj[p])
            if (nv[j] > 0 && mark[j] != gen) {
                mark[j] = gen;
                Lp.push_back(j);
            }
        for (int32_t e : eadj[p]) {
            if (dead_elem[e] || !is_elem[e]) continue;
            for (int32_t j : evars[e])
                if (nv[j] > 0 && mark[j] != gen) {
                    mark[j] = gen;
                    Lp.push_back(j);
                }
            dead_elem[e] = 1;            // absorbed into p
            evars[e].clear();
            evars[e].shrink_to_fit();
        }
        int64_t lpw = 0;
        for (int32_t j : Lp) lpw += nv[j];

        int64_t pweight = nv[p];
        nv[p] = 0;                        // p leaves the variable set
        is_elem[p] = 1;
        evars[p] = Lp;
        esize[p] = lpw;
        vadj[p].clear();
        vadj[p].shrink_to_fit();

        // ---- one-pass w computation: w[e] = |Le \ Lp| (by weight)
        touched_elems.clear();
        for (int32_t i : Lp)
            for (int32_t e : eadj[i]) {
                if (dead_elem[e] || !is_elem[e] || e == p) continue;
                if (wtag[e] != gen) {
                    wtag[e] = gen;
                    w[e] = esize[e];
                    touched_elems.push_back(e);
                }
                w[e] -= nv[i];
            }

        // ---- per-variable update
        for (int32_t i : Lp) {
            deg_remove(i);
            // prune vadj: keep live vars outside Lp (inside-Lp ones are
            // represented by the new element p)
            auto& va = vadj[i];
            size_t kept = 0;
            int64_t dv = 0;
            for (int32_t j : va)
                if (nv[j] > 0 && mark[j] != gen) {
                    va[kept++] = j;
                    dv += nv[j];
                }
            va.resize(kept);
            // prune eadj: live, unabsorbed elements; aggressive
            // absorption of w[e] == 0 elements (Le subset of Lp)
            auto& ea = eadj[i];
            kept = 0;
            int64_t de = 0;
            for (int32_t e : ea) {
                if (dead_elem[e] || !is_elem[e] || e == p) continue;
                if (wtag[e] == gen && w[e] == 0) {
                    dead_elem[e] = 1;
                    evars[e].clear();
                    evars[e].shrink_to_fit();
                    continue;
                }
                ea[kept++] = e;
                de += (wtag[e] == gen) ? w[e] : esize[e];
            }
            ea.resize(kept);
            // mass elimination: adjacency entirely inside the new
            // element -> eliminating i with p causes zero extra fill
            if (kept == 0 && va.empty()) {
                esize[p] -= nv[i];
                lpw -= nv[i];
                nv[i] = 0;
                child_next[i] = child_head[p];
                child_head[p] = i;
                continue;
            }
            ea.push_back(p);
            int64_t d = dv + de + (lpw - nv[i]);
            // AMD's approximate-degree bound: also no worse than the
            // previous degree grown by the new element's contribution
            int64_t dalt = degree[i] + (lpw - nv[i]);
            if (dalt < d) d = dalt;
            int64_t cap = n - out;
            degree[i] = d < 1 ? 1 : (d > cap ? cap : d);
            deg_insert(i);
            if (degree[i] < mindeg) mindeg = degree[i];
        }

        // ---- supervariable detection within Lp (hash + exact compare)
        if (Lp.size() > 1) {
            std::unordered_map<uint64_t, std::vector<int32_t>> buckets;
            buckets.reserve(Lp.size());
            for (int32_t i : Lp) {
                if (nv[i] <= 0) continue;
                // commutative hash: adjacency list ORDER differs
                // between otherwise-identical nodes
                uint64_t h = 0;
                for (int32_t e : eadj[i])
                    h += (uint64_t)(e + 1) * 1099511628211ull;
                for (int32_t j : vadj[i])
                    h += (uint64_t)(j + 1) * 14695981039ull;
                buckets[h].push_back(i);
            }
            std::vector<int32_t> sa, sb;
            for (auto& kv : buckets) {
                auto& grp = kv.second;
                for (size_t a = 0; a < grp.size(); ++a) {
                    int32_t i = grp[a];
                    if (nv[i] <= 0) continue;
                    for (size_t b = a + 1; b < grp.size(); ++b) {
                        int32_t j = grp[b];
                        if (nv[j] <= 0) continue;
                        if (eadj[i].size() != eadj[j].size() ||
                            vadj[i].size() != vadj[j].size())
                            continue;
                        sa = eadj[i]; sb = eadj[j];
                        std::sort(sa.begin(), sa.end());
                        std::sort(sb.begin(), sb.end());
                        if (sa != sb) continue;
                        sa = vadj[i]; sb = vadj[j];
                        std::sort(sa.begin(), sa.end());
                        std::sort(sb.begin(), sb.end());
                        // adjacency may contain each other (i~j edge)
                        bool eq = true;
                        size_t xa = 0, xb = 0;
                        while (xa < sa.size() && xb < sb.size()) {
                            int32_t va_ = sa[xa], vb_ = sb[xb];
                            if (va_ == j) { ++xa; continue; }
                            if (vb_ == i) { ++xb; continue; }
                            if (va_ != vb_) { eq = false; break; }
                            ++xa; ++xb;
                        }
                        while (xa < sa.size() && sa[xa] == j) ++xa;
                        while (xb < sb.size() && sb[xb] == i) ++xb;
                        if (!eq || xa != sa.size() || xb != sb.size())
                            continue;
                        // merge j into i
                        deg_remove(j);
                        nv[i] += nv[j];
                        nv[j] = 0;
                        child_next[j] = child_head[i];
                        child_head[i] = j;
                        vadj[j].clear(); vadj[j].shrink_to_fit();
                        eadj[j].clear(); eadj[j].shrink_to_fit();
                    }
                }
            }
        }

        (void)pweight;
        emit(p, emit);
    }
    return out == n ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Sparse LU / Cholesky numeric with fill (core/factorization/{lu,
// cholesky}.cpp goal): same elimination orders as the Python reference
// implementations in factorization/direct.py (IKJ row elimination with
// on-the-fly fill; left-looking Cholesky with a finalized-column index),
// in C++ hash-row storage.  Results are staged in a process-global
// holder fetched by a second call (single-threaded generate-time use).
// ---------------------------------------------------------------------------
#include <unordered_map>

namespace {

struct TripletHold {
    std::vector<int64_t> r, c;
    std::vector<std::complex<double>> v;
};
TripletHold g_hold_l, g_hold_u;

template <class V>
void store_hold(TripletHold& h, std::vector<std::int64_t>&& r,
                std::vector<int64_t>&& c, std::vector<V>&& v) {
    h.r = std::move(r);
    h.c = std::move(c);
    h.v.assign(v.begin(), v.end());
}

template <class V>
int64_t lu_factor_impl(int64_t n, int64_t nnz, const int64_t* rows,
                       const int64_t* cols, const V* vals) {
    std::vector<std::unordered_map<int64_t, V>> rw(n);
    std::vector<std::vector<int64_t>> col_rows(n);
    for (int64_t e = 0; e < nnz; ++e) {
        rw[rows[e]][cols[e]] += vals[e];
    }
    for (int64_t i = 0; i < n; ++i)
        for (auto& kv : rw[i]) col_rows[kv.first].push_back(i);
    for (int64_t k = 0; k < n; ++k) {
        V dk = V(0);
        auto it = rw[k].find(k);
        if (it != rw[k].end()) dk = it->second;
        if (dk == V(0)) {
            dk = V(1);
            rw[k][k] = dk;
        }
        std::vector<std::pair<int64_t, V>> urow;
        for (auto& kv : rw[k])
            if (kv.first > k) urow.emplace_back(kv.first, kv.second);
        auto& cr = col_rows[k];
        std::sort(cr.begin(), cr.end());
        cr.erase(std::unique(cr.begin(), cr.end()), cr.end());
        for (int64_t i : cr) {
            if (i <= k) continue;
            auto ai = rw[i].find(k);
            if (ai == rw[i].end() || ai->second == V(0)) continue;
            V lik = ai->second / dk;
            ai->second = lik;
            for (auto& [j, ukj] : urow) {
                auto [slot, inserted] = rw[i].try_emplace(j, V(0));
                if (inserted) col_rows[j].push_back(i);
                slot->second -= lik * ukj;
            }
        }
    }
    std::vector<int64_t> lr, lc, ur, uc;
    std::vector<V> lv, uv;
    for (int64_t i = 0; i < n; ++i)
        for (auto& kv : rw[i]) {
            if (kv.second == V(0)) continue;
            if (kv.first < i) {
                lr.push_back(i);
                lc.push_back(kv.first);
                lv.push_back(kv.second);
            } else {
                ur.push_back(i);
                uc.push_back(kv.first);
                uv.push_back(kv.second);
            }
        }
    int64_t total = (int64_t)lr.size() + (int64_t)ur.size();
    store_hold(g_hold_l, std::move(lr), std::move(lc), std::move(lv));
    store_hold(g_hold_u, std::move(ur), std::move(uc), std::move(uv));
    return total;
}

template <class V>
int64_t chol_factor_impl(int64_t n, int64_t nnz, const int64_t* rows,
                         const int64_t* cols, const V* vals) {
    std::vector<std::unordered_map<int64_t, V>> colm(n);
    std::vector<std::vector<int64_t>> row_cols(n);
    for (int64_t e = 0; e < nnz; ++e)
        if (rows[e] >= cols[e]) colm[cols[e]][rows[e]] += vals[e];
    for (int64_t j = 0; j < n; ++j) {
        for (int64_t k : row_cols[j]) {
            auto lj = colm[k].find(j);
            if (lj == colm[k].end() || lj->second == V(0)) continue;
            V ljk = lj->second;
            V cjk;
            if constexpr (std::is_same_v<V, std::complex<double>>)
                cjk = std::conj(ljk);
            else
                cjk = ljk;
            for (auto& kv : colm[k])
                if (kv.first >= j) colm[j][kv.first] -= kv.second * cjk;
        }
        V dj = V(0);
        auto it = colm[j].find(j);
        if (it != colm[j].end()) dj = it->second;
        double mag = std::sqrt(std::abs(dj));
        V ljj = (mag == 0) ? V(1) : V(mag);
        colm[j][j] = ljj;
        for (auto& kv : colm[j])
            if (kv.first > j) {
                kv.second /= ljj;
                row_cols[kv.first].push_back(j);
            }
    }
    std::vector<int64_t> lr, lc;
    std::vector<V> lv;
    for (int64_t j = 0; j < n; ++j)
        for (auto& kv : colm[j])
            if (kv.second != V(0)) {
                lr.push_back(kv.first);
                lc.push_back(j);
                lv.push_back(kv.second);
            }
    int64_t total = (int64_t)lr.size();
    store_hold(g_hold_l, std::move(lr), std::move(lc), std::move(lv));
    g_hold_u = TripletHold{};
    return total;
}

void fetch_hold(const TripletHold& h, int64_t* r, int64_t* c, double* v,
                int32_t is_complex) {
    std::memcpy(r, h.r.data(), h.r.size() * sizeof(int64_t));
    std::memcpy(c, h.c.data(), h.c.size() * sizeof(int64_t));
    if (is_complex) {
        std::memcpy(v, h.v.data(),
                    h.v.size() * sizeof(std::complex<double>));
    } else {
        for (size_t k = 0; k < h.v.size(); ++k) v[k] = h.v[k].real();
    }
}

}  // namespace

extern "C" int64_t gt_lu_factor(int64_t n, int64_t nnz,
                                const int64_t* rows, const int64_t* cols,
                                const double* vals, int32_t is_complex,
                                int64_t* l_nnz, int64_t* u_nnz) {
    int64_t tot;
    if (is_complex)
        tot = lu_factor_impl<std::complex<double>>(
            n, nnz, rows, cols,
            reinterpret_cast<const std::complex<double>*>(vals));
    else
        tot = lu_factor_impl<double>(n, nnz, rows, cols, vals);
    *l_nnz = (int64_t)g_hold_l.r.size();
    *u_nnz = (int64_t)g_hold_u.r.size();
    return tot;
}

extern "C" int64_t gt_chol_factor(int64_t n, int64_t nnz,
                                  const int64_t* rows,
                                  const int64_t* cols, const double* vals,
                                  int32_t is_complex) {
    if (is_complex)
        return chol_factor_impl<std::complex<double>>(
            n, nnz, rows, cols,
            reinterpret_cast<const std::complex<double>*>(vals));
    return chol_factor_impl<double>(n, nnz, rows, cols, vals);
}

extern "C" int gt_factor_fetch(int32_t which /*0=L,1=U*/, int64_t* r,
                               int64_t* c, double* v, int32_t is_complex) {
    const TripletHold& h = which ? g_hold_u : g_hold_l;
    fetch_hold(h, r, c, v, is_complex);
    if (which) g_hold_u = TripletHold{};
    else g_hold_l = TripletHold{};
    return 0;
}

// ---------------------------------------------------------------------------
// ParICT Gauss-Seidel sweep (reference/factorization/par_ict_kernels.cpp
// compute_factor semantics): in-place row-major sweeps over a lower-
// triangular pattern L:
//     l_jj = sqrt(a_jj - sum_{k<j} |l_jk|^2)
//     l_ij = (a_ij - sum_{k<j} l_ik conj(l_jk)) / l_jj     (i > j)
// The k-sum is a merge over rows i and j of L (CSR, cols ascending).
// ---------------------------------------------------------------------------
namespace {

template <class V>
void parict_sweep_impl(int64_t n, const int64_t* a_ptr,
                       const int64_t* a_cols, const V* a_vals,
                       const int64_t* l_ptr, const int64_t* l_cols,
                       V* l_vals, int64_t iterations) {
    auto a_at = [&](int64_t row, int64_t col) -> V {
        const int64_t* b = a_cols + a_ptr[row];
        const int64_t* e = a_cols + a_ptr[row + 1];
        const int64_t* it = std::lower_bound(b, e, col);
        if (it != e && *it == col) return a_vals[it - a_cols];
        return V(0);
    };
    auto cj = [](V x) {
        if constexpr (std::is_same_v<V, std::complex<double>>)
            return std::conj(x);
        else
            return x;
    };
    auto dot = [&](int64_t i, int64_t j, int64_t lim) -> V {
        V sum(0);
        int64_t s = l_ptr[i], se = l_ptr[i + 1];
        int64_t t = l_ptr[j], te = l_ptr[j + 1];
        while (s < se && t < te) {
            int64_t k = l_cols[s], k2 = l_cols[t];
            if (k == k2) {
                if (k < lim) sum += l_vals[s] * cj(l_vals[t]);
                ++s;
                ++t;
            } else if (k < k2) {
                ++s;
            } else {
                ++t;
            }
        }
        return sum;
    };
    for (int64_t it = 0; it < iterations; ++it) {
        for (int64_t i = 0; i < n; ++i) {
            for (int64_t p = l_ptr[i]; p < l_ptr[i + 1]; ++p) {
                int64_t j = l_cols[p];
                if (j > i) continue;
                V s = a_at(i, j) - dot(i, j, j);
                if (j == i) {
                    double mag = std::sqrt(std::abs(s));
                    if (std::isfinite(mag) && mag != 0) l_vals[p] = V(mag);
                } else {
                    // diag of row j is its last entry (cols ascending)
                    V djj = l_vals[l_ptr[j + 1] - 1];
                    V nv = s / djj;
                    bool fin;
                    if constexpr (std::is_same_v<V, std::complex<double>>)
                        fin = std::isfinite(nv.real())
                              && std::isfinite(nv.imag());
                    else
                        fin = std::isfinite(nv);
                    if (fin) l_vals[p] = nv;
                }
            }
        }
    }
}

}  // namespace

extern "C" int gt_parict_sweep(int64_t n, const int64_t* a_ptr,
                               const int64_t* a_cols, const double* a_vals,
                               const int64_t* l_ptr, const int64_t* l_cols,
                               double* l_vals, int64_t iterations,
                               int32_t is_complex) {
    if (is_complex)
        parict_sweep_impl<std::complex<double>>(
            n, a_ptr, a_cols,
            reinterpret_cast<const std::complex<double>*>(a_vals), l_ptr,
            l_cols, reinterpret_cast<std::complex<double>*>(l_vals),
            iterations);
    else
        parict_sweep_impl<double>(n, a_ptr, a_cols, a_vals, l_ptr, l_cols,
                                  l_vals, iterations);
    return 0;
}

// ---------------------------------------------------------------------------
// Multilevel nested dissection (core/reorder/nested_dissection.cpp is a
// METIS wrapper; METIS is absent here, so this is a self-contained
// METIS-style multilevel ND: heavy-edge-matching coarsening, greedy
// graph-growing initial bisection, boundary FM refinement on every
// uncoarsening level, vertex separator via greedy cover of the refined
// cut, AMD (gt_amd_order) on leaf blocks).

namespace nd {

struct Graph {
    int64_t nv = 0;
    std::vector<int64_t> ptr;   // nv+1
    std::vector<int32_t> adj;
    std::vector<int32_t> ewt;   // edge weights
    std::vector<int32_t> vwt;   // vertex weights
};

// Heavy-edge matching coarsening; cmap[v] = coarse id.
static Graph coarsen(const Graph& g, std::vector<int32_t>& cmap,
                     uint64_t* seed) {
    const int64_t n = g.nv;
    cmap.assign(n, -1);
    std::vector<int32_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = (int32_t)i;
    // cheap xorshift shuffle for matching fairness
    for (int64_t i = n - 1; i > 0; --i) {
        *seed ^= *seed << 13; *seed ^= *seed >> 7; *seed ^= *seed << 17;
        std::swap(order[i], order[*seed % (uint64_t)(i + 1)]);
    }
    int32_t nc = 0;
    std::vector<int32_t> match(n, -1);
    for (int32_t v : order) {
        if (match[v] >= 0) continue;
        int32_t best = -1, bw = -1;
        for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e) {
            int32_t u = g.adj[e];
            if (u != v && match[u] < 0 && g.ewt[e] > bw) {
                bw = g.ewt[e]; best = u;
            }
        }
        match[v] = (best >= 0) ? best : v;
        if (best >= 0) match[best] = v;
        cmap[v] = nc;
        if (best >= 0) cmap[best] = nc;
        ++nc;
    }
    Graph c;
    c.nv = nc;
    c.vwt.assign(nc, 0);
    for (int64_t v = 0; v < n; ++v) c.vwt[cmap[v]] += g.vwt[v];
    // build coarse adjacency with a scatter buffer
    std::vector<int64_t> pos(nc, -1);
    std::vector<int32_t> cols;
    std::vector<int32_t> wts;
    c.ptr.assign(nc + 1, 0);
    std::vector<std::pair<int32_t, int32_t>> row;  // (col, w)
    // first pass: count via building rows (nc is small enough to do 1 pass)
    std::vector<std::vector<std::pair<int32_t, int32_t>>> rows(nc);
    for (int64_t v = 0; v < n; ++v) {
        int32_t cv = cmap[v];
        for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e) {
            int32_t cu = cmap[g.adj[e]];
            if (cu != cv) rows[cv].push_back({cu, g.ewt[e]});
        }
    }
    for (int32_t i = 0; i < nc; ++i) {
        auto& r = rows[i];
        std::sort(r.begin(), r.end());
        int64_t w = 0;
        for (size_t k = 0; k < r.size(); ) {
            size_t j = k;
            int32_t sum = 0;
            while (j < r.size() && r[j].first == r[k].first) sum += r[j++].second;
            c.adj.push_back(r[k].first);
            c.ewt.push_back(sum);
            k = j;
            ++w;
        }
        c.ptr[i + 1] = (int64_t)c.adj.size();
    }
    (void)pos; (void)cols; (void)wts; (void)row;
    return c;
}

// One FM pass over boundary vertices; side in {0,1}; returns new cut.
static int64_t fm_refine(const Graph& g, std::vector<int8_t>& side,
                         int64_t max_passes) {
    const int64_t n = g.nv;
    int64_t wt[2] = {0, 0};
    for (int64_t v = 0; v < n; ++v) wt[side[v]] += g.vwt[v];
    const int64_t total = wt[0] + wt[1];
    const int64_t lo = (int64_t)(0.42 * total), hi = total - lo;
    auto cutsize = [&]() {
        int64_t c = 0;
        for (int64_t v = 0; v < n; ++v)
            for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e)
                if (side[g.adj[e]] != side[v]) c += g.ewt[e];
        return c / 2;
    };
    int64_t cut = cutsize();
    std::vector<int64_t> gain(n);
    std::vector<uint8_t> locked(n), in_cand(n);
    for (int64_t pass = 0; pass < max_passes; ++pass) {
        std::fill(locked.begin(), locked.end(), 0);
        std::fill(in_cand.begin(), in_cand.end(), 0);
        // boundary-restricted FM: only boundary vertices (and, as the
        // sequence evolves, neighbors of moved vertices) are candidates —
        // the selection scan is O(|boundary|), not O(n)
        std::vector<int32_t> cand;
        for (int64_t v = 0; v < n; ++v) {
            int64_t gv = 0;
            bool bnd = false;
            for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e) {
                bool cutedge = side[g.adj[e]] != side[v];
                gv += cutedge ? g.ewt[e] : -g.ewt[e];
                bnd |= cutedge;
            }
            gain[v] = gv;
            if (bnd) { cand.push_back((int32_t)v); in_cand[v] = 1; }
        }
        // lazy max-heaps per source side: entries are (gain, v) snapshots,
        // stale ones (gain or side changed, or locked) discarded at pop
        using entry = std::pair<int64_t, int32_t>;
        std::priority_queue<entry> heap[2];
        for (int32_t v : cand) heap[side[v]].push({gain[v], v});
        // move sequence with rollback to the best prefix
        std::vector<int32_t> moves;
        int64_t best_cut = cut, run_cut = cut, best_k = 0;
        const int64_t max_moves = (int64_t)cand.size() * 2 + 16;
        std::vector<entry> stash;
        for (int64_t step = 0; step < max_moves; ++step) {
            int32_t best = -1;
            int64_t bg = INT64_MIN;
            stash.clear();
            int32_t top_v[2] = {-1, -1};
            int64_t top_g[2] = {INT64_MIN, INT64_MIN};
            for (int s = 0; s < 2; ++s) {
                while (!heap[s].empty()) {
                    auto [gv, v] = heap[s].top();
                    heap[s].pop();
                    if (locked[v] || side[v] != s || gain[v] != gv)
                        continue;               // stale snapshot
                    if (wt[s] - g.vwt[v] < lo || wt[1 - s] + g.vwt[v] > hi) {
                        stash.push_back({gv, v});   // infeasible only now
                        continue;
                    }
                    top_v[s] = v;
                    top_g[s] = gv;
                    break;
                }
            }
            for (auto& e : stash) heap[side[e.second]].push(e);
            int sbest = top_g[0] >= top_g[1] ? 0 : 1;
            best = top_v[sbest];
            bg = top_g[sbest];
            if (top_v[1 - sbest] >= 0)          // loser stays available
                heap[1 - sbest].push({top_g[1 - sbest], top_v[1 - sbest]});
            if (best < 0 || (bg < 0 && run_cut > best_cut + cut / 4)) break;
            int8_t s = side[best];
            side[best] = 1 - s;
            wt[s] -= g.vwt[best];
            wt[1 - s] += g.vwt[best];
            locked[best] = 1;
            run_cut -= bg;
            moves.push_back(best);
            for (int64_t e = g.ptr[best]; e < g.ptr[best + 1]; ++e) {
                int32_t u = g.adj[e];
                // u's gain wrt best flipped sign
                gain[u] += (side[u] != side[best]) ? 2 * g.ewt[e]
                                                   : -2 * g.ewt[e];
                if (!in_cand[u]) { in_cand[u] = 1; cand.push_back(u); }
                if (!locked[u]) heap[side[u]].push({gain[u], u});
            }
            if (run_cut < best_cut) { best_cut = run_cut; best_k = (int64_t)moves.size(); }
        }
        for (int64_t k = (int64_t)moves.size() - 1; k >= best_k; --k) {
            int32_t v = moves[k];
            int8_t s = side[v];
            side[v] = 1 - s;
            wt[s] -= g.vwt[v];
            wt[1 - s] += g.vwt[v];
        }
        if (best_cut >= cut) break;
        cut = best_cut;
    }
    return cut;
}

// Greedy graph-growing bisection on the coarsest graph.
static void initial_bisect(const Graph& g, std::vector<int8_t>& side,
                           uint64_t* seed) {
    const int64_t n = g.nv;
    side.assign(n, 1);
    int64_t total = 0;
    for (int64_t v = 0; v < n; ++v) total += g.vwt[v];
    int64_t grown = 0;
    std::vector<uint8_t> seen(n, 0);
    std::vector<int32_t> frontier;
    while (grown * 2 < total) {
        int32_t start = -1;
        *seed ^= *seed << 13; *seed ^= *seed >> 7; *seed ^= *seed << 17;
        int64_t probe = (int64_t)(*seed % (uint64_t)n);
        for (int64_t k = 0; k < n && start < 0; ++k)
            if (!seen[(probe + k) % n]) start = (int32_t)((probe + k) % n);
        if (start < 0) break;
        frontier.assign(1, start);
        seen[start] = 1;
        while (!frontier.empty() && grown * 2 < total) {
            std::vector<int32_t> nxt;
            for (int32_t u : frontier) {
                if (grown * 2 >= total) break;
                side[u] = 0;
                grown += g.vwt[u];
                for (int64_t e = g.ptr[u]; e < g.ptr[u + 1]; ++e) {
                    int32_t v2 = g.adj[e];
                    if (!seen[v2]) { seen[v2] = 1; nxt.push_back(v2); }
                }
            }
            frontier.swap(nxt);
        }
    }
}

static void bisect_ml(const Graph& g, std::vector<int8_t>& side,
                      uint64_t* seed) {
    if (g.nv <= 96) {
        initial_bisect(g, side, seed);
        fm_refine(g, side, 6);
        return;
    }
    std::vector<int32_t> cmap;
    Graph c = coarsen(g, cmap, seed);
    if (c.nv > g.nv * 9 / 10) {       // matching stalled
        initial_bisect(g, side, seed);
        fm_refine(g, side, 6);
        return;
    }
    std::vector<int8_t> cside;
    bisect_ml(c, cside, seed);
    side.resize(g.nv);
    for (int64_t v = 0; v < g.nv; ++v) side[v] = cside[cmap[v]];
    fm_refine(g, side, 3);
}

// Vertex separator from the refined edge cut: greedy cover preferring the
// endpoint with larger cut-degree.
static void vertex_separator(const Graph& g, const std::vector<int8_t>& side,
                             std::vector<uint8_t>& insep) {
    const int64_t n = g.nv;
    insep.assign(n, 0);
    std::vector<int32_t> cutdeg(n, 0);
    for (int64_t v = 0; v < n; ++v)
        for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e)
            if (side[g.adj[e]] != side[v]) ++cutdeg[v];
    // visit cut edges from the side-0 endpoint; cover greedily
    for (int64_t v = 0; v < n; ++v) {
        if (side[v] != 0) continue;
        for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e) {
            int32_t u = g.adj[e];
            if (side[u] == 0 || insep[v] || insep[u]) continue;
            insep[cutdeg[v] >= cutdeg[u] ? v : (int64_t)u] = 1;
        }
    }
}

// Recursive dissection over a sub-list of global vertices.
static void dissect(const int64_t* ptr, const int64_t* adj,
                    std::vector<int32_t>& verts, std::vector<int32_t>& scratch,
                    int64_t* perm, int64_t* out, uint64_t* seed) {
    const int64_t n = (int64_t)verts.size();
    if (n == 0) return;
    if (n <= 64) {
        // AMD on the leaf block (gt_amd_order wants its own CSR)
        std::vector<int64_t> lp(n + 1, 0), la, lperm(n);
        for (int64_t i = 0; i < n; ++i) scratch[verts[i]] = (int32_t)i;
        for (int64_t i = 0; i < n; ++i) {
            int32_t v = verts[i];
            for (int64_t e = ptr[v]; e < ptr[v + 1]; ++e) {
                int64_t u = adj[e];
                if (u != v && scratch[u] >= 0) la.push_back(scratch[u]);
            }
            lp[i + 1] = (int64_t)la.size();
        }
        gt_amd_order(n, lp.data(), la.data(), lperm.data());
        for (int64_t i = 0; i < n; ++i) perm[(*out)++] = verts[lperm[i]];
        for (int64_t i = 0; i < n; ++i) scratch[verts[i]] = -1;
        return;
    }
    // local graph
    Graph g;
    g.nv = n;
    g.ptr.assign(n + 1, 0);
    g.vwt.assign(n, 1);
    for (int64_t i = 0; i < n; ++i) scratch[verts[i]] = (int32_t)i;
    for (int64_t i = 0; i < n; ++i) {
        int32_t v = verts[i];
        for (int64_t e = ptr[v]; e < ptr[v + 1]; ++e) {
            int64_t u = adj[e];
            if (u != v && scratch[u] >= 0) {
                g.adj.push_back(scratch[u]);
                g.ewt.push_back(1);
            }
        }
        g.ptr[i + 1] = (int64_t)g.adj.size();
    }
    for (int64_t i = 0; i < n; ++i) scratch[verts[i]] = -1;

    std::vector<int8_t> side;
    bisect_ml(g, side, seed);
    std::vector<uint8_t> insep;
    vertex_separator(g, side, insep);

    std::vector<int32_t> left, right, sep;
    for (int64_t i = 0; i < n; ++i) {
        if (insep[i]) sep.push_back(verts[i]);
        else if (side[i] == 0) left.push_back(verts[i]);
        else right.push_back(verts[i]);
    }
    if (left.empty() || right.empty()) {
        // no usable split (e.g. complete graph): AMD the whole block
        std::vector<int64_t> lp(n + 1, 0), la, lperm(n);
        for (int64_t i = 0; i < n; ++i) scratch[verts[i]] = (int32_t)i;
        for (int64_t i = 0; i < n; ++i) {
            int32_t v = verts[i];
            for (int64_t e = ptr[v]; e < ptr[v + 1]; ++e) {
                int64_t u = adj[e];
                if (u != v && scratch[u] >= 0) la.push_back(scratch[u]);
            }
            lp[i + 1] = (int64_t)la.size();
        }
        gt_amd_order(n, lp.data(), la.data(), lperm.data());
        for (int64_t i = 0; i < n; ++i) perm[(*out)++] = verts[lperm[i]];
        for (int64_t i = 0; i < n; ++i) scratch[verts[i]] = -1;
        return;
    }
    dissect(ptr, adj, left, scratch, perm, out, seed);
    dissect(ptr, adj, right, scratch, perm, out, seed);
    for (int32_t s : sep) perm[(*out)++] = s;
}

}  // namespace nd

// perm[k] = source row of output row k (the Permutation convention used
// throughout: output i = input perm[i]).
extern "C" int gt_nd_order(int64_t n, const int64_t* ptr, const int64_t* adj,
                           int64_t* perm) {
    if (n == 0) return 0;
    std::vector<int32_t> verts(n);
    for (int64_t i = 0; i < n; ++i) verts[i] = (int32_t)i;
    std::vector<int32_t> scratch(n, -1);
    int64_t out = 0;
    uint64_t seed = 0x9e3779b97f4a7c15ull;
    nd::dissect(ptr, adj, verts, scratch, perm, &out, &seed);
    return (out == n) ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Exact ILU(0) / IC(0) on the given sparsity pattern (CSR, columns sorted,
// values in-place) — the reference's par_ilu "exact" baseline
// (core/factorization/par_ilu.cpp factorize on A's pattern).  IKJ with a
// per-row position-scatter array: O(sum_i |row_i| * |lower(row_i)|).
// The Python fallbacks in factorization/par_ilu.py are dict-based and
// (for IC0) O(n^2) — unusable beyond toy sizes.

extern "C" int gt_ilu0(int64_t n, const int64_t* ptr, const int64_t* cols,
                       double* vals, int32_t is_complex) {
    const int64_t w = is_complex ? 2 : 1;
    std::vector<int64_t> pos(n, -1), dpos(n, -1);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e)
            if (cols[e] == i) dpos[i] = e;
    auto cmul = [&](const double* a, const double* b, double* out) {
        if (is_complex) {
            double re = a[0] * b[0] - a[1] * b[1];
            double im = a[0] * b[1] + a[1] * b[0];
            out[0] = re; out[1] = im;
        } else out[0] = a[0] * b[0];
    };
    auto cdiv = [&](double* a, const double* b) {
        if (is_complex) {
            double d = b[0] * b[0] + b[1] * b[1];
            if (d == 0) return;
            double re = (a[0] * b[0] + a[1] * b[1]) / d;
            double im = (a[1] * b[0] - a[0] * b[1]) / d;
            a[0] = re; a[1] = im;
        } else if (b[0] != 0) a[0] /= b[0];
    };
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e) pos[cols[e]] = e;
        for (int64_t e = ptr[i]; e < ptr[i + 1] && cols[e] < i; ++e) {
            int64_t k = cols[e];
            if (dpos[k] < 0) continue;
            cdiv(&vals[e * w], &vals[dpos[k] * w]);   // l_ik = a_ik / u_kk
            for (int64_t f = ptr[k]; f < ptr[k + 1]; ++f) {
                int64_t j = cols[f];
                if (j <= k) continue;
                int64_t p = pos[j];
                if (p >= 0) {
                    double t[2];
                    cmul(&vals[e * w], &vals[f * w], t);
                    vals[p * w] -= t[0];
                    if (is_complex) vals[p * w + 1] -= t[1];
                }
            }
        }
        for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e) pos[cols[e]] = -1;
    }
    return 0;
}

// IC(0) on the LOWER pattern (ptr/cols cover j <= i, sorted); values
// in-place become L with L L^H ~= A on the pattern.
extern "C" int gt_ic0(int64_t n, const int64_t* ptr, const int64_t* cols,
                      double* vals, int32_t is_complex) {
    const int64_t w = is_complex ? 2 : 1;
    std::vector<int64_t> pos(n, -1);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e) pos[cols[e]] = e;
        for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e) {
            int64_t j = cols[e];
            // s = a_ij - sum_{k<j, k in row_i ^ row_j} l_ik conj(l_jk)
            double s[2] = {vals[e * w], is_complex ? vals[e * w + 1] : 0.0};
            for (int64_t f = ptr[j]; f < ptr[j + 1] && cols[f] < j; ++f) {
                int64_t p = pos[cols[f]];
                if (p < 0) continue;
                // s -= l_ik * conj(l_jk)
                double a0 = vals[p * w];
                double a1 = is_complex ? vals[p * w + 1] : 0.0;
                double b0 = vals[f * w];
                double b1 = is_complex ? -vals[f * w + 1] : 0.0;
                s[0] -= a0 * b0 - a1 * b1;
                s[1] -= a0 * b1 + a1 * b0;
            }
            if (j < i) {
                // l_ij = s / l_jj  (l_jj real>0 by construction, but allow
                // complex-safe divide)
                int64_t dj = ptr[j + 1] - 1;   // diagonal is last in row j
                bool has_diag = dj >= ptr[j] && cols[dj] == j;
                double d0 = has_diag ? vals[dj * w] : 1.0;
                double d1 = (is_complex && has_diag) ? vals[dj * w + 1]
                                                     : 0.0;
                double den = d0 * d0 + d1 * d1;
                if (den != 0) {
                    double re = (s[0] * d0 + s[1] * d1) / den;
                    double im = (s[1] * d0 - s[0] * d1) / den;
                    vals[e * w] = re;
                    if (is_complex) vals[e * w + 1] = im;
                } else {
                    vals[e * w] = 0;
                    if (is_complex) vals[e * w + 1] = 0;
                }
            } else {   // diagonal: l_jj = sqrt(|s|)
                double mag = std::sqrt(std::hypot(s[0], s[1]));
                vals[e * w] = (mag != 0) ? mag : 1.0;
                if (is_complex) vals[e * w + 1] = 0;
            }
        }
        for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e) pos[cols[e]] = -1;
    }
    return 0;
}

// ISAI batched-block fill (reference: the per-row gather half of
// common/cuda_hip/preconditioner/isai_kernels.cpp generate_*_inverse —
// here only the A(J,J)^T gather; the batched solve itself runs on the
// MXU).  For every row i with pattern columns J[0..m): write
// subs[i, a, b] = A(J[b], J[a]) by a sorted two-pointer merge of J with
// A's row J[b] (both ascending) — O(sum_b (m + deg(J[b]))) total, no
// hashing.  subs must arrive identity-initialized ((n, S, S), row-major,
// w doubles per value); rhs (n, S) zero-initialized gets e_i(J).
extern "C" int gt_isai_fill(int64_t n, int64_t S,
                            const int64_t* a_ptr, const int64_t* a_cols,
                            const double* a_vals,
                            const int64_t* p_ptr, const int64_t* p_cols,
                            double* subs, double* rhs,
                            int32_t is_complex) {
    const int64_t w = is_complex ? 2 : 1;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t ps = p_ptr[i], pe = p_ptr[i + 1], m = pe - ps;
        if (m > S) return 1;
        double* block = subs + i * S * S * w;
        // clear the live (m, m) region (identity base stays in padding)
        for (int64_t a = 0; a < m; ++a)
            for (int64_t b = 0; b < m; ++b)
                for (int64_t c = 0; c < w; ++c)
                    block[(a * S + b) * w + c] = 0.0;
        for (int64_t b = 0; b < m; ++b) {
            const int64_t jb = p_cols[ps + b];
            int64_t e = a_ptr[jb];
            const int64_t ee = a_ptr[jb + 1];
            for (int64_t a = 0; a < m && e < ee; ++a) {
                const int64_t ja = p_cols[ps + a];
                while (e < ee && a_cols[e] < ja) ++e;
                if (e < ee && a_cols[e] == ja)
                    for (int64_t c = 0; c < w; ++c)
                        block[(a * S + b) * w + c] = a_vals[e * w + c];
            }
            if (jb == i) rhs[(i * S + b) * w] = 1.0;
        }
    }
    return 0;
}

// ISAI device-fill pair list (the symbolic half of gt_isai_fill, for
// the device-resident scatter path): the same sorted two-pointer merge
// of each pattern row J with A's rows J[b], but emitting
// (dest = (i*S + a)*S + b, loc = A value index, hit) triples for A hits
// plus hit=0 entries for valid DIAGONAL slots (a == b) with no A entry
// (the device slab is identity-initialized; those must be cleared).
// Two-pass: count then fill into caller buffers.
template <class EMIT>
static void isai_pairs_walk(int64_t n, int64_t S, const int64_t* a_ptr,
                            const int64_t* a_cols, const int64_t* p_ptr,
                            const int64_t* p_cols, EMIT&& emit) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t ps = p_ptr[i], pe = p_ptr[i + 1], m = pe - ps;
        for (int64_t b = 0; b < m; ++b) {
            const int64_t jb = p_cols[ps + b];
            int64_t e = a_ptr[jb];
            const int64_t ee = a_ptr[jb + 1];
            for (int64_t a = 0; a < m; ++a) {
                const int64_t ja = p_cols[ps + a];
                while (e < ee && a_cols[e] < ja) ++e;
                const bool hit = e < ee && a_cols[e] == ja;
                if (hit || a == b)
                    emit((i * S + a) * S + b, hit ? e : 0, hit);
            }
        }
    }
}

extern "C" int64_t gt_isai_pairs_count(int64_t n, int64_t S,
                                       const int64_t* a_ptr,
                                       const int64_t* a_cols,
                                       const int64_t* p_ptr,
                                       const int64_t* p_cols) {
    int64_t cnt = 0;
    isai_pairs_walk(n, S, a_ptr, a_cols, p_ptr, p_cols,
                    [&](int64_t, int64_t, bool) { ++cnt; });
    return cnt;
}

extern "C" int64_t gt_isai_pairs_fill(int64_t n, int64_t S,
                                      const int64_t* a_ptr,
                                      const int64_t* a_cols,
                                      const int64_t* p_ptr,
                                      const int64_t* p_cols,
                                      int64_t* dest, int64_t* loc,
                                      uint8_t* hit, int64_t cap) {
    int64_t cnt = 0;
    isai_pairs_walk(n, S, a_ptr, a_cols, p_ptr, p_cols,
                    [&](int64_t d, int64_t l, bool h) {
                        if (cnt < cap) {
                            dest[cnt] = d;
                            loc[cnt] = l;
                            hit[cnt] = h ? 1 : 0;
                        }
                        ++cnt;
                    });
    return cnt;
}

// ---------------------------------------------------------------------------
// ParILUT fused candidates (core/factorization/par_ilut.cpp:262
// add_candidates + the repo's fused-Jacobi seeding, one pass):
// per row i accumulate (I+L)@U into a dense workspace, merge with A's
// row, and emit the union with
//     seed = old + r/u_jj   (col < i)      seed = old + r   (col >= i)
// where r = a - (LU) and old is the current l/u iterate (0 for new
// entries) — exactly one Jacobi Chow-Patel sweep evaluated on the
// enlarged pattern.  Emits (rows, cols, seed) into g_hold_l and
// (rows, cols, a_value) into g_hold_u (same order); fetch both with
// gt_factor_fetch.  L is strict lower (unit diag implicit), U upper
// with full diagonal; all CSR row-major with ascending columns.
// ---------------------------------------------------------------------------
namespace {

template <class V>
int64_t parilut_candidates_impl(
    int64_t n, const int64_t* a_ptr, const int64_t* a_cols, const V* a_vals,
    const int64_t* l_ptr, const int64_t* l_cols, const V* l_vals,
    const int64_t* u_ptr, const int64_t* u_cols, const V* u_vals,
    int64_t cap, int64_t* out_r, int64_t* out_c, V* out_seed, V* out_a) {
    std::vector<V> acc(n, V(0));       // LU row accumulator
    std::vector<V> oldv(n, V(0));      // current iterate on row i
    std::vector<uint8_t> touched(n, 0);
    std::vector<int64_t> touch_list;
    touch_list.reserve(256);
    // u diagonal (first entry of each U row by construction: upper CSR
    // with ascending cols has the diagonal first when present)
    std::vector<V> udiag(n, V(1));
    for (int64_t j = 0; j < n; ++j) {
        int64_t e = u_ptr[j];
        if (e < u_ptr[j + 1] && u_cols[e] == j && u_vals[e] != V(0))
            udiag[j] = u_vals[e];
    }
    int64_t total = 0;

    auto touch = [&](int64_t j) {
        if (!touched[j]) { touched[j] = 1; touch_list.push_back(j); }
    };
    for (int64_t i = 0; i < n; ++i) {
        touch_list.clear();
        // (I + L) @ U row i: U row i ...
        for (int64_t e = u_ptr[i]; e < u_ptr[i + 1]; ++e) {
            touch(u_cols[e]);
            acc[u_cols[e]] += u_vals[e];
            oldv[u_cols[e]] += u_vals[e];       // old u value
        }
        // ... plus l_ik * U row k
        for (int64_t e = l_ptr[i]; e < l_ptr[i + 1]; ++e) {
            const int64_t k = l_cols[e];
            const V lik = l_vals[e];
            touch(k);
            oldv[k] += lik;                     // old l value
            for (int64_t f = u_ptr[k]; f < u_ptr[k + 1]; ++f) {
                touch(u_cols[f]);
                acc[u_cols[f]] += lik * u_vals[f];
            }
        }
        // union with A's row
        for (int64_t e = a_ptr[i]; e < a_ptr[i + 1]; ++e) touch(a_cols[e]);
        std::sort(touch_list.begin(), touch_list.end());
        int64_t ae = a_ptr[i];
        const int64_t aend = a_ptr[i + 1];
        for (int64_t j : touch_list) {
            while (ae < aend && a_cols[ae] < j) ++ae;
            const V a = (ae < aend && a_cols[ae] == j) ? a_vals[ae] : V(0);
            const V r = a - acc[j];
            if (total < cap) {
                out_r[total] = i;
                out_c[total] = j;
                out_seed[total] = oldv[j] + (j < i ? r / udiag[j] : r);
                out_a[total] = a;
            }
            ++total;                 // past cap: keep counting, stop writing
            acc[j] = V(0); oldv[j] = V(0); touched[j] = 0;
        }
    }
    return total;
}

// ParICT fused candidates (core/factorization/par_ict.cpp
// add_candidates): per row i accumulate tril(L @ L^H) via a CSC view of
// L, merge with tril(A)'s row, emit the union with the fused Jacobi-IC
// sweep seed:
//     seed = old + r / l_jj         (j < i)
//     seed = sqrt(max(old^2 + r, 0)) (j == i; falls back to old when
//                                     the sqrt argument is <= 0)
// where r = a - (L L^H)_ij.
template <class V>
int64_t parict_candidates_impl(
    int64_t n, const int64_t* a_ptr, const int64_t* a_cols, const V* a_vals,
    const int64_t* l_ptr, const int64_t* l_cols, const V* l_vals,
    int64_t cap, int64_t* out_r, int64_t* out_c, V* out_seed, V* out_a) {
    // CSC of L (strict order preserved)
    std::vector<int64_t> csc_ptr(n + 1, 0), csc_row(l_ptr[n]);
    std::vector<V> csc_val(l_ptr[n]);
    for (int64_t e = 0; e < l_ptr[n]; ++e) ++csc_ptr[l_cols[e] + 1];
    for (int64_t j = 0; j < n; ++j) csc_ptr[j + 1] += csc_ptr[j];
    {
        std::vector<int64_t> w(csc_ptr.begin(), csc_ptr.end() - 1);
        for (int64_t i = 0; i < n; ++i)
            for (int64_t e = l_ptr[i]; e < l_ptr[i + 1]; ++e) {
                int64_t j = l_cols[e];
                csc_row[w[j]] = i;
                csc_val[w[j]++] = l_vals[e];
            }
    }
    std::vector<V> acc(n, V(0)), oldv(n, V(0));
    std::vector<uint8_t> touched(n, 0);
    std::vector<int64_t> touch_list;
    std::vector<V> ldiag(n, V(1));
    for (int64_t i = 0; i < n; ++i) {
        int64_t e = l_ptr[i + 1] - 1;   // diag last in row (ascending)
        if (e >= l_ptr[i] && l_cols[e] == i && l_vals[e] != V(0))
            ldiag[i] = l_vals[e];
    }
    int64_t total = 0;
    auto touch = [&](int64_t j) {
        if (!touched[j]) { touched[j] = 1; touch_list.push_back(j); }
    };
    auto conj_v = [](V x) {
        if constexpr (std::is_same_v<V, std::complex<double>>)
            return std::conj(x);
        else
            return x;
    };
    for (int64_t i = 0; i < n; ++i) {
        touch_list.clear();
        // tril(L L^H) row i: for k in L row i, walk CSC col k (rows j),
        // keep j <= i
        for (int64_t e = l_ptr[i]; e < l_ptr[i + 1]; ++e) {
            const int64_t k = l_cols[e];
            const V lik = l_vals[e];
            oldv[k] += lik;
            touch(k);
            for (int64_t f = csc_ptr[k]; f < csc_ptr[k + 1]; ++f) {
                const int64_t j = csc_row[f];
                if (j > i) break;              // rows ascending in col
                touch(j);
                acc[j] += lik * conj_v(csc_val[f]);
            }
        }
        for (int64_t e = a_ptr[i]; e < a_ptr[i + 1]; ++e) touch(a_cols[e]);
        std::sort(touch_list.begin(), touch_list.end());
        int64_t ae = a_ptr[i];
        const int64_t aend = a_ptr[i + 1];
        for (int64_t j : touch_list) {
            while (ae < aend && a_cols[ae] < j) ++ae;
            const V a = (ae < aend && a_cols[ae] == j) ? a_vals[ae] : V(0);
            const V r = a - acc[j];
            V seed;
            if (j == i) {
                V s = oldv[j] * conj_v(oldv[j]) + r;
                double mag = std::sqrt(std::abs(s));
                seed = (mag > 0 && std::isfinite(mag)) ? V(mag) : oldv[j];
            } else {
                seed = oldv[j] + r / ldiag[j];
            }
            if (!(std::abs(seed) < std::numeric_limits<double>::infinity()))
                seed = oldv[j];
            if (total < cap) {
                out_r[total] = i;
                out_c[total] = j;
                out_seed[total] = seed;
                out_a[total] = a;
            }
            ++total;
            acc[j] = V(0); oldv[j] = V(0); touched[j] = 0;
        }
    }
    return total;
}

}  // namespace

extern "C" int64_t gt_parilut_candidates(
    int64_t n, const int64_t* a_ptr, const int64_t* a_cols,
    const double* a_vals, const int64_t* l_ptr, const int64_t* l_cols,
    const double* l_vals, const int64_t* u_ptr, const int64_t* u_cols,
    const double* u_vals, int64_t cap, int64_t* out_r, int64_t* out_c,
    double* out_seed, double* out_a, int32_t is_complex) {
    if (is_complex)
        return parilut_candidates_impl<std::complex<double>>(
            n, a_ptr, a_cols,
            reinterpret_cast<const std::complex<double>*>(a_vals),
            l_ptr, l_cols,
            reinterpret_cast<const std::complex<double>*>(l_vals),
            u_ptr, u_cols,
            reinterpret_cast<const std::complex<double>*>(u_vals),
            cap, out_r, out_c,
            reinterpret_cast<std::complex<double>*>(out_seed),
            reinterpret_cast<std::complex<double>*>(out_a));
    return parilut_candidates_impl<double>(n, a_ptr, a_cols, a_vals, l_ptr,
                                           l_cols, l_vals, u_ptr, u_cols,
                                           u_vals, cap, out_r, out_c,
                                           out_seed, out_a);
}

extern "C" int64_t gt_parict_candidates(
    int64_t n, const int64_t* a_ptr, const int64_t* a_cols,
    const double* a_vals, const int64_t* l_ptr, const int64_t* l_cols,
    const double* l_vals, int64_t cap, int64_t* out_r, int64_t* out_c,
    double* out_seed, double* out_a, int32_t is_complex) {
    if (is_complex)
        return parict_candidates_impl<std::complex<double>>(
            n, a_ptr, a_cols,
            reinterpret_cast<const std::complex<double>*>(a_vals),
            l_ptr, l_cols,
            reinterpret_cast<const std::complex<double>*>(l_vals),
            cap, out_r, out_c,
            reinterpret_cast<std::complex<double>*>(out_seed),
            reinterpret_cast<std::complex<double>*>(out_a));
    return parict_candidates_impl<double>(n, a_ptr, a_cols, a_vals, l_ptr,
                                          l_cols, l_vals, cap, out_r,
                                          out_c, out_seed, out_a);
}

// Row-major-U convenience wrapper around the GS sweep: builds U^T (CSC,
// rows ascending per column, diag last) and the u2ut map in-kernel at
// memcpy speed, runs parilut_sweep_impl, and scatters the updated
// values back into the caller's row-major u_vals — replaces the host
// lexsort + three staging copies per sweep call.
namespace {
template <class V>
void parilut_sweep_csr_impl(int64_t n, const int64_t* a_ptr,
                            const int64_t* a_cols, const V* a_vals,
                            const int64_t* l_ptr, const int64_t* l_cols,
                            V* l_vals, const int64_t* u_ptr,
                            const int64_t* u_cols, V* u_vals,
                            int64_t iterations) {
    const int64_t nnzu = u_ptr[n];
    std::vector<int64_t> ut_ptr(n + 1, 0), ut_rows(nnzu), u2ut(nnzu);
    std::vector<V> ut_vals(nnzu);
    for (int64_t e = 0; e < nnzu; ++e) ++ut_ptr[u_cols[e] + 1];
    for (int64_t j = 0; j < n; ++j) ut_ptr[j + 1] += ut_ptr[j];
    {
        std::vector<int64_t> w(ut_ptr.begin(), ut_ptr.end() - 1);
        for (int64_t i = 0; i < n; ++i)
            for (int64_t e = u_ptr[i]; e < u_ptr[i + 1]; ++e) {
                const int64_t pos = w[u_cols[e]]++;
                ut_rows[pos] = i;
                ut_vals[pos] = u_vals[e];
                u2ut[e] = pos;
            }
    }
    parilut_sweep_impl<V>(n, a_ptr, a_cols, a_vals, l_ptr, l_cols, l_vals,
                          u_ptr, u_cols, u2ut.data(), ut_ptr.data(),
                          ut_rows.data(), ut_vals.data(), iterations);
    for (int64_t e = 0; e < nnzu; ++e) u_vals[e] = ut_vals[u2ut[e]];
}
}  // namespace

extern "C" int gt_parilut_sweep_csr(
    int64_t n, const int64_t* a_ptr, const int64_t* a_cols,
    const double* a_vals, const int64_t* l_ptr, const int64_t* l_cols,
    double* l_vals, const int64_t* u_ptr, const int64_t* u_cols,
    double* u_vals, int64_t iterations, int32_t is_complex) {
    if (is_complex)
        parilut_sweep_csr_impl<std::complex<double>>(
            n, a_ptr, a_cols,
            reinterpret_cast<const std::complex<double>*>(a_vals), l_ptr,
            l_cols, reinterpret_cast<std::complex<double>*>(l_vals), u_ptr,
            u_cols, reinterpret_cast<std::complex<double>*>(u_vals),
            iterations);
    else
        parilut_sweep_csr_impl<double>(n, a_ptr, a_cols, a_vals, l_ptr,
                                       l_cols, l_vals, u_ptr, u_cols,
                                       u_vals, iterations);
    return 0;
}

// SpGEMM symbolic finisher (csr_lookup analog,
// common/cuda_hip/matrix/csr_kernels.template.cpp:1247 — the reference
// builds per-row hash tables; here a per-row dense-scratch unique):
// given the contribution pairs grouped by output row (pair_ptr) and each
// pair's output column (pair_j), assign every pair its slot in the
// row-major-sorted output pattern WITHOUT the global O(flops log flops)
// sort+unique.  Writes inv (pair -> output slot), rows/cols (the output
// pattern, capacity `cap`; counting continues past cap so the caller can
// retry exactly).  Returns nnz_c.
extern "C" int64_t gt_pairs_unique(int64_t n, const int64_t* pair_ptr,
                                   const int64_t* pair_j, int64_t* inv,
                                   int64_t cap, int64_t* rows,
                                   int64_t* cols) {
    std::vector<int64_t> slot;       // cols touched this row (unsorted)
    std::vector<int64_t> scratch;    // col -> local slot id (+1), lazy
    int64_t maxj = 0;
    for (int64_t e = 0; e < pair_ptr[n]; ++e)
        maxj = std::max(maxj, pair_j[e]);
    scratch.assign(maxj + 1, 0);
    std::vector<int64_t> order, remap;
    int64_t nnz_c = 0;
    for (int64_t i = 0; i < n; ++i) {
        slot.clear();
        const int64_t ps = pair_ptr[i], pe = pair_ptr[i + 1];
        for (int64_t e = ps; e < pe; ++e) {
            const int64_t j = pair_j[e];
            if (!scratch[j]) {
                slot.push_back(j);
                scratch[j] = (int64_t)slot.size();
            }
            inv[e] = scratch[j] - 1;          // local id for now
        }
        const int64_t m = (int64_t)slot.size();
        order.resize(m);
        for (int64_t t = 0; t < m; ++t) order[t] = t;
        std::sort(order.begin(), order.end(),
                  [&](int64_t x, int64_t y) { return slot[x] < slot[y]; });
        remap.resize(m);
        for (int64_t t = 0; t < m; ++t) remap[order[t]] = t;
        for (int64_t e = ps; e < pe; ++e) inv[e] = nnz_c + remap[inv[e]];
        for (int64_t t = 0; t < m; ++t) {
            if (nnz_c + t < cap) {
                rows[nnz_c + t] = i;
                cols[nnz_c + t] = slot[order[t]];
            }
        }
        for (int64_t j : slot) scratch[j] = 0;
        nnz_c += m;
    }
    return nnz_c;
}

// ---------------------------------------------------------------------------
// Streaming Gustavson SpGEMM: C = A @ B on row-major CSR, bounded memory.
// The reference builds per-row hash lookups on device
// (common/cuda_hip/matrix/csr_kernels.template.cpp:1247-1290) and its OMP
// tier merges row heaps (omp/matrix/csr_kernels.cpp:457-520); this is the
// host-tier equivalent: one dense marker/accumulator pair of size ncols(B)
// reused across rows — O(ncols) workspace, O(nnz_C) output, never an
// O(flops) pair list.  Two-phase (count then fill) so the caller owns the
// allocations; columns within each output row are emitted sorted.
template <typename V>
static int64_t spgemm_csr_impl(int64_t n, int64_t m, const int64_t* a_ptr,
                               const int64_t* a_cols, const V* a_vals,
                               const int64_t* b_ptr, const int64_t* b_cols,
                               const V* b_vals, int64_t* c_ptr,
                               int64_t* c_cols, V* c_vals) {
    std::vector<int64_t> mark(m, -1);
    std::vector<V> acc;
    std::vector<int64_t> slot;
    bool fill = c_cols != nullptr;
    if (fill) acc.assign(m, V(0));
    int64_t nnz = 0;
    if (c_ptr) c_ptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        slot.clear();
        for (int64_t e = a_ptr[i]; e < a_ptr[i + 1]; ++e) {
            const int64_t k = a_cols[e];
            const V av = a_vals ? a_vals[e] : V(0);
            for (int64_t t = b_ptr[k]; t < b_ptr[k + 1]; ++t) {
                const int64_t j = b_cols[t];
                if (mark[j] != i) {
                    mark[j] = i;
                    slot.push_back(j);
                    if (fill) acc[j] = V(0);
                }
                if (fill) acc[j] += av * b_vals[t];
            }
        }
        if (fill) {
            std::sort(slot.begin(), slot.end());
            for (int64_t j : slot) {
                c_cols[nnz] = j;
                c_vals[nnz] = acc[j];
                ++nnz;
            }
        } else {
            nnz += (int64_t)slot.size();
        }
        if (c_ptr) c_ptr[i + 1] = nnz;
    }
    return nnz;
}

extern "C" int64_t gt_spgemm_count(int64_t n, int64_t m,
                                   const int64_t* a_ptr,
                                   const int64_t* a_cols,
                                   const int64_t* b_ptr,
                                   const int64_t* b_cols) {
    return spgemm_csr_impl<double>(n, m, a_ptr, a_cols, nullptr, b_ptr,
                                   b_cols, nullptr, nullptr, nullptr,
                                   nullptr);
}

extern "C" int64_t gt_spgemm_fill(int64_t n, int64_t m, const int64_t* a_ptr,
                                  const int64_t* a_cols,
                                  const double* a_vals,
                                  const int64_t* b_ptr,
                                  const int64_t* b_cols,
                                  const double* b_vals, int64_t* c_ptr,
                                  int64_t* c_cols, double* c_vals,
                                  int32_t is_complex) {
    if (is_complex) {
        return spgemm_csr_impl<std::complex<double>>(
            n, m, a_ptr, a_cols,
            reinterpret_cast<const std::complex<double>*>(a_vals), b_ptr,
            b_cols, reinterpret_cast<const std::complex<double>*>(b_vals),
            c_ptr, c_cols, reinterpret_cast<std::complex<double>*>(c_vals));
    }
    return spgemm_csr_impl<double>(n, m, a_ptr, a_cols, a_vals, b_ptr,
                                   b_cols, b_vals, c_ptr, c_cols, c_vals);
}

// ---------------------------------------------------------------------------
// Packed pair-contraction planner (native tier of
// ops/pair_contract.plan_pair_contract).  The numpy planner is ~10
// O(npairs) passes (lexsort, segmented ranks, window analysis, stream
// scatter) over pair lists that reach 3.5e8 at n=262k level-3 universes
// — ~25 min on this host class.  Pairs arrive sorted by po (the native
// emitters guarantee (po, pu) order), so tile segments are contiguous:
// one per-tile sort by (ublock, lblock) plus two linear walks build the
// same plan in one pass over memory.  Semantics mirror the numpy
// planner exactly: vregs split groups every 1024 pairs, per-tile median
// block anchors the gather windows, vregs outside the window or past
// the per-tile vreg budget spill their pairs to the COO tail.
// Two-phase: build stages the streams (NV is unknowable to the caller
// beforehand), fetch copies into caller allocations and frees.
// ---------------------------------------------------------------------------
namespace {
constexpr int64_t PP_OW = 1024;

struct PairVreg {
    int32_t lb, ub;     // pl>>10 / pu>>10 block of every pair in the vreg
    int32_t count;      // pairs in this vreg (<= 1024)
    int32_t rank;       // index among window-ok vregs of the tile
    uint8_t live;
};

struct PairPlanStage {
    std::vector<int16_t> pls, pus, pos, pes, pesp;
    std::vector<int32_t> lq, uq, nv, lbase, ubase;
    std::vector<int32_t> tail_l, tail_u, tail_o;
    int64_t T = 0, NV = 0, WLr = 0, WUr = 0;
};
PairPlanStage* g_pair_plan = nullptr;

int64_t pp_pow2ceil(int64_t x) {
    int64_t p = 1;
    while (p < x) p <<= 1;
    return p;
}
}  // namespace

extern "C" int gt_pair_plan_build(int64_t npairs, const int32_t* pl,
                                  const int32_t* pu, const int32_t* po,
                                  int64_t n_out, int32_t nv_cap,
                                  int32_t win_rows_cap, double max_tail,
                                  int32_t sl, int32_t su,
                                  int64_t* out_meta) {
    if (npairs <= 0 || n_out <= 0) return -1;
    if (sl < 0 || sl > 5 || su < 0 || su > 5) return -1;
    for (int64_t i = 1; i < npairs; ++i)
        if (po[i] < po[i - 1]) return -2;   // unsorted: numpy fallback
    const int64_t T = (n_out + PP_OW - 1) / PP_OW;
    // per-vreg gather windows of gwl/gwu rows (coarse blocks of
    // 128*gw elements); the window caps below are in coarse units
    const int32_t gwl = 8 << sl, gwu = 8 << su;
    const int32_t capb_l = win_rows_cap / gwl;
    const int32_t capb_u = win_rows_cap / gwu;
    const int32_t shl = 10 + sl, shu = 10 + su;
    const int32_t mkl = gwl * 128 - 1, mku = gwu * 128 - 1;

    // phase 1: per-tile (ub, lb) sort; vreg segmentation
    std::vector<int32_t> ord(npairs);       // tile-major sorted pair ids
    std::vector<PairVreg> vregs;
    vregs.reserve(npairs / PP_OW + T + 8);
    std::vector<int64_t> voff(T + 1, 0);
    std::vector<uint64_t> keys;
    int64_t p = 0;
    for (int64_t t = 0; t < T; ++t) {
        int64_t e = p;
        while (e < npairs && (po[e] >> 10) == t) ++e;
        const int64_t m = e - p;
        if (m > 0 && m < (int64_t(1) << 22)) {
            keys.resize(m);
            for (int64_t k = 0; k < m; ++k)
                keys[k] = ((uint64_t)(uint32_t)(pu[p + k] >> shu) << 43) |
                          ((uint64_t)(uint32_t)(pl[p + k] >> shl) << 22) |
                          (uint64_t)k;
            std::sort(keys.begin(), keys.end());
            for (int64_t k = 0; k < m; ++k)
                ord[p + k] = (int32_t)(p + (int64_t)(keys[k] & 0x3FFFFF));
        } else if (m > 0) {                 // huge segment: comparator sort
            for (int64_t k = 0; k < m; ++k) ord[p + k] = (int32_t)(p + k);
            // original-index tiebreak keeps the sort stable over the
            // emitters' (po, pu) order — the cumsum-difference pes/pesp
            // scatter requires in-vreg po-ascending order, matching the
            // small-segment path's embedded-index key.
            std::sort(ord.begin() + p, ord.begin() + e,
                      [&](int32_t a, int32_t b) {
                          const int32_t ua = pu[a] >> shu, ub = pu[b] >> shu;
                          if (ua != ub) return ua < ub;
                          const int32_t la = pl[a] >> shl, lb = pl[b] >> shl;
                          if (la != lb) return la < lb;
                          return a < b;
                      });
        }
        int32_t cl = -1, cu = -1, cnt = 0;
        for (int64_t k = p; k < e; ++k) {
            const int32_t lb = pl[ord[k]] >> shl, ub = pu[ord[k]] >> shu;
            if (lb != cl || ub != cu || cnt == (int32_t)PP_OW) {
                vregs.push_back({lb, ub, 0, 0, 0});
                cl = lb; cu = ub; cnt = 0;
            }
            ++vregs.back().count;
            ++cnt;
        }
        voff[t + 1] = (int64_t)vregs.size();
        p = e;
    }
    if (p != npairs) return -1;             // po out of [0, n_out)

    // phase 2: median-anchored windows, ranks, global NV, tail budget
    std::vector<int32_t> blocks;
    int32_t max_rank = -1;
    for (int64_t t = 0; t < T; ++t) {
        const int64_t vs = voff[t], ve = voff[t + 1];
        if (vs == ve) continue;
        const int64_t cnt = ve - vs;
        int32_t med[2];
        for (int side = 0; side < 2; ++side) {
            blocks.resize(cnt);
            for (int64_t v = 0; v < cnt; ++v)
                blocks[v] = side ? vregs[vs + v].ub : vregs[vs + v].lb;
            std::nth_element(blocks.begin(), blocks.begin() + cnt / 2,
                             blocks.end());
            med[side] = blocks[cnt / 2];
        }
        const int32_t lo_l = std::max(med[0] - capb_l / 2, 0);
        const int32_t lo_u = std::max(med[1] - capb_u / 2, 0);
        int32_t rank = 0;
        for (int64_t v = vs; v < ve; ++v) {
            PairVreg& r = vregs[v];
            const int32_t bl = r.lb - lo_l, bu = r.ub - lo_u;
            if (bl >= 0 && bl < capb_l && bu >= 0 && bu < capb_u) {
                r.rank = rank++;
                if (r.rank > max_rank) max_rank = r.rank;
            } else {
                r.rank = -1;
            }
        }
    }
    if (max_rank < 0) return -1;
    const int64_t NV = std::min<int64_t>(max_rank + 1, nv_cap);
    int64_t n_live_pairs = 0;
    for (auto& r : vregs) {
        r.live = (r.rank >= 0 && r.rank < NV) ? 1 : 0;
        if (r.live) n_live_pairs += r.count;
    }
    const int64_t n_tail = npairs - n_live_pairs;
    if ((double)n_tail > max_tail * (double)npairs) return -1;

    // phase 3: window bases over live vregs, stream scatter
    auto* st = new PairPlanStage();
    st->T = T;
    st->NV = NV;
    st->lbase.assign(T, INT32_MAX);
    st->ubase.assign(T, INT32_MAX);
    std::vector<int32_t> lmax(T, -1), umax(T, -1);
    for (int64_t t = 0; t < T; ++t)
        for (int64_t v = voff[t]; v < voff[t + 1]; ++v) {
            const PairVreg& r = vregs[v];
            if (!r.live) continue;
            st->lbase[t] = std::min(st->lbase[t], r.lb * gwl);
            lmax[t] = std::max(lmax[t], r.lb * gwl + gwl);
            st->ubase[t] = std::min(st->ubase[t], r.ub * gwu);
            umax[t] = std::max(umax[t], r.ub * gwu + gwu);
        }
    int64_t wl = gwl, wu = gwu;
    for (int64_t t = 0; t < T; ++t) {
        if (lmax[t] < 0) {
            st->lbase[t] = 0; st->ubase[t] = 0;
            continue;
        }
        wl = std::max<int64_t>(wl, lmax[t] - st->lbase[t]);
        wu = std::max<int64_t>(wu, umax[t] - st->ubase[t]);
    }
    st->WLr = pp_pow2ceil(wl);
    st->WUr = pp_pow2ceil(wu);
    if (st->WLr > win_rows_cap || st->WUr > win_rows_cap) {
        delete st;
        return -1;
    }
    st->pls.assign(T * NV * PP_OW, 0);
    st->pus.assign(T * NV * PP_OW, 0);
    st->pos.assign(T * NV * PP_OW, (int16_t)PP_OW);
    st->lq.assign(T * NV, 0);
    st->uq.assign(T * NV, 0);
    st->nv.assign(T, 0);
    st->tail_l.reserve(n_tail);
    st->tail_u.reserve(n_tail);
    st->tail_o.reserve(n_tail);
    p = 0;
    for (int64_t t = 0; t < T; ++t) {
        int64_t e = p;
        while (e < npairs && (po[e] >> 10) == t) ++e;
        int64_t vcur = voff[t] - 1;
        int32_t cl = -1, cu = -1, cnt = 0, slot = 0;
        const PairVreg* r = nullptr;
        int64_t base = 0;
        for (int64_t k = p; k < e; ++k) {
            const int32_t id = ord[k];
            const int32_t lb = pl[id] >> shl, ub = pu[id] >> shu;
            if (lb != cl || ub != cu || cnt == (int32_t)PP_OW) {
                ++vcur;
                r = &vregs[vcur];
                cl = lb; cu = ub; cnt = 0; slot = 0;
                if (r->live) {
                    st->lq[t * NV + r->rank] =
                        lb * gwl - st->lbase[t];
                    st->uq[t * NV + r->rank] =
                        ub * gwu - st->ubase[t];
                    ++st->nv[t];
                    base = (t * NV + r->rank) * PP_OW;
                }
            }
            ++cnt;
            if (r->live) {
                st->pls[base + slot] = (int16_t)(pl[id] & mkl);
                st->pus[base + slot] = (int16_t)(pu[id] & mku);
                st->pos[base + slot] = (int16_t)(po[id] & 1023);
                ++slot;
            } else {
                st->tail_l.push_back(pl[id]);
                st->tail_u.push_back(pu[id]);
                st->tail_o.push_back(po[id]);
            }
        }
        p = e;
    }
    // pes: per-vreg cumulative pair count per output slot (the
    // cumsum-difference scatter's gather positions).  pos rows are
    // po-ascending within each vreg — the group sort is stable over
    // po-sorted emitter input — with the PP_OW sentinel padding the
    // tail, so one monotone walk per row suffices.
    st->pes.assign(T * NV * PP_OW, 0);
    st->pesp.assign(T * NV * PP_OW, 0);
    for (int64_t r = 0; r < T * NV; ++r) {
        const int16_t* pr = &st->pos[r * PP_OW];
        int16_t* qe = &st->pes[r * PP_OW];
        int16_t* qp = &st->pesp[r * PP_OW];
        int64_t k = 0;
        for (int64_t o = 0; o < PP_OW; ++o) {
            qp[o] = (int16_t)k;          // pes of the previous slot
            while (k < PP_OW && pr[k] <= o) ++k;
            qe[o] = (int16_t)k;
        }
    }
    delete g_pair_plan;
    g_pair_plan = st;
    out_meta[0] = T;
    out_meta[1] = NV;
    out_meta[2] = st->WLr;
    out_meta[3] = st->WUr;
    out_meta[4] = (int64_t)st->tail_l.size();
    return 0;
}

extern "C" int gt_pair_plan_fetch(int16_t* pls, int16_t* pus, int16_t* pos,
                                  int16_t* pes, int16_t* pesp,
                                  int32_t* lq, int32_t* uq,
                                  int32_t* nv, int32_t* lbase,
                                  int32_t* ubase, int32_t* tail_l,
                                  int32_t* tail_u, int32_t* tail_o) {
    PairPlanStage* st = g_pair_plan;
    if (!st) return -1;
    auto cp = [](auto& v, auto* dst) {
        if (!v.empty()) std::memcpy(dst, v.data(),
                                    v.size() * sizeof(v[0]));
    };
    cp(st->pls, pls);
    cp(st->pus, pus);
    cp(st->pos, pos);
    cp(st->pes, pes);
    cp(st->pesp, pesp);
    cp(st->lq, lq);
    cp(st->uq, uq);
    cp(st->nv, nv);
    cp(st->lbase, lbase);
    cp(st->ubase, ubase);
    cp(st->tail_l, tail_l);
    cp(st->tail_u, tail_u);
    cp(st->tail_o, tail_o);
    delete st;
    g_pair_plan = nullptr;
    return 0;
}
