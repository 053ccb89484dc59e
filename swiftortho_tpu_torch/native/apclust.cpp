// Reference-faithful affinity propagation (streaming-quirk emulation).
//
// Replicates bin/find_cluster.py apclust_blk (:406-513) with its numba
// helpers max_row/update_R/sum_col/update_A/get_change (:310-397) run
// through the plain-Python @jit shim, single chunk (edge count < the -b
// default 25e6), bit-for-bit:
//
//  - diag[:, 0..3] (row max / 2nd max + args) are NEVER reset: they
//    accumulate monotonically across iterations, and within one pass the
//    2nd max is never demoted when a new max arrives (the classic
//    streaming-2nd-max bug).  Both are order-dependent over the data rows.
//  - data rows are float32 on disk; each pass copies them into a float64
//    block, computes in doubles, and update_R/update_A truncate R/A back
//    to float32 at pass end.  diag[i, 5] (R_kk) keeps the UN-truncated
//    double from inside update_R.
//  - mconv is passed by value into get_change and never propagates back
//    (:509-510), so the convergence early-exit is dead and the loop always
//    runs the full `itr` iterations.
//  - exemplars: ras is reset per iteration; lab[i] updates streaming on
//    strict ras improvement.
//
// The textbook (order-independent) update lives in cluster/apc.py; this
// kernel exists so `--faithful` runs match the runnable reference exactly
// (measured r4: the textbook path differs on 7.5% of groups at the shared
// parity corpus — near-tie splits).

#include <cstdint>
#include <cmath>
#include <vector>
#include <limits>

extern "C" void apclust_ref(
    const int64_t* ei, const int64_t* ek, const float* s,
    int64_t n_rows, int64_t n_nodes,
    double damp, int32_t itr, int64_t* lab_out)
{
    const double beta = 1.0 - damp;
    const double NEG_INF = -std::numeric_limits<double>::infinity();

    std::vector<float> R(n_rows, 0.0f), A(n_rows, 0.0f);
    // diag[i*6 + c]: 0 row max, 1 its k, 2 2nd max, 3 its k, 4 col sum,
    // 5 R_kk (un-truncated double)
    std::vector<double> diag(static_cast<size_t>(n_nodes) * 6, 0.0);
    std::vector<double> ras(n_nodes);
    for (int64_t i = 0; i < n_nodes; ++i) lab_out[i] = i;

    for (int32_t it = 0; it < itr; ++it) {
        // pass 1: streaming row max / 2nd max (never reset, never demoted)
        for (int64_t n = 0; n < n_rows; ++n) {
            const int64_t i = ei[n];
            const double ra = (double)R[n] + (double)A[n];
            double* d = &diag[(size_t)i * 6];
            if (d[0] < ra) { d[0] = ra; d[1] = (double)ek[n]; }
            else if (d[2] < ra) { d[2] = ra; d[3] = (double)ek[n]; }
        }
        // pass 2: R update (doubles), float32 store, R_kk keeps the double
        for (int64_t n = 0; n < n_rows; ++n) {
            const int64_t i = ei[n], k = ek[n];
            const double* d = &diag[(size_t)i * 6];
            const double r = (double)s[n] - ((double)k != d[1] ? d[0] : d[2]);
            const double r3 = (double)R[n] * damp + beta * r;
            if (i == k) diag[(size_t)i * 6 + 5] = r3;
            R[n] = (float)r3;
        }
        // pass 3: column sums of max(0, R) over off-diagonal rows
        for (int64_t i = 0; i < n_nodes; ++i) diag[(size_t)i * 6 + 4] = 0.0;
        for (int64_t n = 0; n < n_rows; ++n) {
            if (ei[n] != ek[n]) {
                const double r = (double)R[n];
                if (r > 0.0) diag[(size_t)ek[n] * 6 + 4] += r;
            }
        }
        // pass 4: A update (doubles), float32 store
        for (int64_t n = 0; n < n_rows; ++n) {
            const int64_t i = ei[n], k = ek[n];
            const double* d = &diag[(size_t)k * 6];
            double a4 = (double)A[n] * damp;
            if (i != k) {
                double v = d[5] + d[4];
                const double rmax = (double)R[n] > 0.0 ? (double)R[n] : 0.0;
                v -= rmax;
                if (v > 0.0) v = 0.0;
                a4 += beta * v;
            } else {
                a4 += beta * d[4];
            }
            A[n] = (float)a4;
        }
        // pass 5: exemplar per row (streaming strict improvement)
        for (int64_t i = 0; i < n_nodes; ++i) ras[i] = NEG_INF;
        for (int64_t n = 0; n < n_rows; ++n) {
            const int64_t i = ei[n];
            const double ra = (double)R[n] + (double)A[n];
            if (ras[i] < ra) {
                ras[i] = ra;
                if (lab_out[i] != ek[n]) lab_out[i] = ek[n];
            }
        }
        // (reference convergence check is dead code: mconv never updates)
    }
}
