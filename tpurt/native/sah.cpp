// Native binned-SAH split — a bit-exact port of tpurt/bvh._sah_partition.
//
// The BVH topology feeds byte-exact golden images, so this port must
// reproduce the NumPy implementation EXACTLY, not just approximately:
//   * bin assignment is computed in float32 with the same expression
//     order ((c - cb_lo) / ext * 16) and the same trunc-toward-zero
//     int cast as ndarray.astype(int64);
//   * per-bin bounds and the prefix/suffix sweeps run in float64, like
//     the np.float64 accumulator arrays (min/max are exact in any
//     order; the float32 -> float64 conversion is exact);
//   * the SAH cost uses the same expression shape
//     e0*e1 + e1*e2 + e2*e0 and aL*nl + aR*nr in float64;
//   * ties resolve exactly like np.argmin (leftmost) and the
//     cross-axis comparison is strict (earlier axis wins ties);
//   * both NumPy fallbacks are replicated: all-centroids-coincide
//     (arbitrary halves) and the empty-side median split (stable sort
//     by the widest-axis centroid).
// tests/test_native_sah.py asserts bit-identical outputs against the
// NumPy reference on random and adversarial inputs, and the golden
// tests cover it end-to-end.
//
// Build: g++ -O2 -shared -fPIC -o _sah.so sah.cpp  (tpurt/native
// compiles this lazily on first use; any failure falls back to NumPy).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

inline double area3(const double* lo, const double* hi) {
    double e0 = std::max(hi[0] - lo[0], 0.0);
    double e1 = std::max(hi[1] - lo[1], 0.0);
    double e2 = std::max(hi[2] - lo[2], 0.0);
    return e0 * e1 + e1 * e2 + e2 * e0;
}

}  // namespace

extern "C" {

// Partition idx (length n) by the binned-SAH split.
// tlo/thi/centroid: (ntotal, 3) float32, C-contiguous.
// out_left/out_right: caller buffers of length n (int64).
// Writes *out_nleft; returns the split axis (>= 0) on success.
long long sah_partition(const float* tlo, const float* thi,
                        const float* centroid, const long long* idx,
                        long long n, long long sah_bins,
                        long long* out_left, long long* out_right,
                        long long* out_nleft) {
    const long long B = sah_bins;
    const double INF = std::numeric_limits<double>::infinity();

    // centroid bounds over the selection (float32 min/max — exact)
    float cb_lo[3], cb_hi[3];
    for (int k = 0; k < 3; ++k) {
        cb_lo[k] = std::numeric_limits<float>::infinity();
        cb_hi[k] = -std::numeric_limits<float>::infinity();
    }
    for (long long i = 0; i < n; ++i) {
        const float* c = centroid + idx[i] * 3;
        for (int k = 0; k < 3; ++k) {
            cb_lo[k] = std::min(cb_lo[k], c[k]);
            cb_hi[k] = std::max(cb_hi[k], c[k]);
        }
    }
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = cb_hi[k] - cb_lo[k];

    double best_cost = INF;
    int best_axis = -1;
    long long best_k = -1;

    std::vector<double> blo(B * 3), bhi(B * 3);
    std::vector<double> plo(B * 3), phi(B * 3), slo(B * 3), shi(B * 3);
    std::vector<long long> counts(B);

    for (int axis = 0; axis < 3; ++axis) {
        // np predicate mirrored exactly: skip only when ext < 1e-12 —
        // NaN compares false on BOTH sides there, so NaN extents stay on
        // the non-skip branch just like NumPy.
        if ((double)ext[axis] < 1e-12) continue;
        std::fill(blo.begin(), blo.end(), INF);
        std::fill(bhi.begin(), bhi.end(), -INF);
        std::fill(counts.begin(), counts.end(), 0LL);
        for (long long i = 0; i < n; ++i) {
            long long t = idx[i];
            // float32 expression order matches the NumPy line exactly
            float w = (centroid[t * 3 + axis] - cb_lo[axis]) / ext[axis]
                      * (float)B;
            long long b = (long long)w;  // astype(int64): trunc toward 0
            if (b < 0) b = 0;
            if (b > B - 1) b = B - 1;
            counts[b] += 1;
            for (int k = 0; k < 3; ++k) {
                blo[b * 3 + k] = std::min(blo[b * 3 + k],
                                          (double)tlo[t * 3 + k]);
                bhi[b * 3 + k] = std::max(bhi[b * 3 + k],
                                          (double)thi[t * 3 + k]);
            }
        }
        // prefix/suffix cumulative bounds
        for (int k = 0; k < 3; ++k) {
            plo[k] = blo[k];
            phi[k] = bhi[k];
            slo[(B - 1) * 3 + k] = blo[(B - 1) * 3 + k];
            shi[(B - 1) * 3 + k] = bhi[(B - 1) * 3 + k];
        }
        for (long long b = 1; b < B; ++b)
            for (int k = 0; k < 3; ++k) {
                plo[b * 3 + k] = std::min(plo[(b - 1) * 3 + k],
                                          blo[b * 3 + k]);
                phi[b * 3 + k] = std::max(phi[(b - 1) * 3 + k],
                                          bhi[b * 3 + k]);
            }
        for (long long b = B - 2; b >= 0; --b)
            for (int k = 0; k < 3; ++k) {
                slo[b * 3 + k] = std::min(slo[(b + 1) * 3 + k],
                                          blo[b * 3 + k]);
                shi[b * 3 + k] = std::max(shi[(b + 1) * 3 + k],
                                          bhi[b * 3 + k]);
            }
        double axis_best = INF;
        long long axis_k = -1;
        long long nl = 0;
        for (long long s = 0; s < B - 1; ++s) {
            nl += counts[s];
            long long nr = n - nl;
            double cost;
            if (nl == 0 || nr == 0) {
                cost = INF;  // np.where((nl==0)|(nr==0), inf, cost)
            } else {
                cost = area3(&plo[s * 3], &phi[s * 3]) * (double)nl
                       + area3(&slo[(s + 1) * 3], &shi[(s + 1) * 3])
                             * (double)nr;
            }
            if (cost < axis_best) {  // np.argmin: strict < keeps leftmost
                axis_best = cost;
                axis_k = s;
            }
        }
        // strict <, like `if cost[k] < best_cost`: earlier axis wins
        // ties, and an all-inf cost row (everything in one bin) leaves
        // best unset exactly as NumPy's `best = None` does.
        if (axis_best < best_cost) {
            best_cost = axis_best;
            best_axis = axis;
            best_k = axis_k;
        }
    }

    if (best_axis < 0) {
        // all centroids coincide (or every axis all-inf): arbitrary halves
        long long half = n / 2;
        for (long long i = 0; i < half; ++i) out_left[i] = idx[i];
        for (long long i = half; i < n; ++i) out_right[i - half] = idx[i];
        *out_nleft = half;
        return 0;
    }

    long long nl = 0, nr = 0;
    for (long long i = 0; i < n; ++i) {
        long long t = idx[i];
        float w = (centroid[t * 3 + best_axis] - cb_lo[best_axis])
                  / ext[best_axis] * (float)B;
        long long b = (long long)w;
        if (b < 0) b = 0;
        if (b > B - 1) b = B - 1;
        if (b <= best_k)
            out_left[nl++] = t;
        else
            out_right[nr++] = t;
    }
    if (nl == 0 || nr == 0) {
        // degenerate: median split on the widest axis, stable by centroid
        int axis = 0;
        for (int k = 1; k < 3; ++k)
            if (ext[k] > ext[axis]) axis = k;  // np.argmax: leftmost max
        std::vector<long long> pos(n);
        for (long long i = 0; i < n; ++i) pos[i] = i;
        std::stable_sort(pos.begin(), pos.end(),
                         [&](long long a, long long b2) {
                             return centroid[idx[a] * 3 + axis]
                                    < centroid[idx[b2] * 3 + axis];
                         });
        long long half = n / 2;
        for (long long i = 0; i < half; ++i) out_left[i] = idx[pos[i]];
        for (long long i = half; i < n; ++i)
            out_right[i - half] = idx[pos[i]];
        *out_nleft = half;
        return axis;
    }
    *out_nleft = nl;
    return best_axis;
}

}  // extern "C"
