// Native host-side calibration solvers.
//
// C++ equivalents of the reference's host solver components
// (ppq/csrc/cpu/hist_mse.cc compute_mse_loss, ppq/csrc/cuda/isotone.cc
// Isotone_T, and the python KL search of observer/range.py:191-283) —
// exact ports of ppq_tpu/quantization/solvers.py's numpy semantics so the
// two paths are bit-identical and property-testable against each other.
//
// Built by ppq_tpu/utils/native.py via `g++ -O3 -shared -fPIC`, loaded with
// ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ------------------------------------------------------------------ KL ----
// Returns the clip-bin index minimizing KL(P || quantized Q).
int kl_search(const double* hist, int n, int levels, int interval) {
    const double eps = 1e-12;
    int best_bin = n - 1;
    double best_kl = INFINITY;

    double total_tail = 0.0;  // recomputed per i below (kept simple/exact)
    (void)total_tail;

    std::vector<double> sums(levels), nonzero(levels);
    for (int i = levels; i <= n; i += interval) {
        // p = hist[:i]; p[i-1] += sum(hist[i:])
        double tail = 0.0;
        for (int j = i; j < n; ++j) tail += hist[j];

        double p_sum = tail;
        for (int j = 0; j < i; ++j) p_sum += hist[j];
        if (p_sum <= 0.0) continue;

        // group g(j) = (j * levels) / i
        std::fill(sums.begin(), sums.end(), 0.0);
        std::fill(nonzero.begin(), nonzero.end(), 0.0);
        for (int j = 0; j < i; ++j) {
            int g = (int)(((int64_t)j * levels) / i);
            sums[g] += hist[j];
            if (hist[j] > 0.0) nonzero[g] += 1.0;
        }
        // q[j] = hist[j]>0 ? sums[g]/max(nonzero[g],1) : 0
        double q_sum = 0.0;
        for (int j = 0; j < i; ++j) {
            if (hist[j] > 0.0) {
                int g = (int)(((int64_t)j * levels) / i);
                double nz = nonzero[g] > 1.0 ? nonzero[g] : 1.0;
                q_sum += (nonzero[g] > 0.0) ? sums[g] / nz : 0.0;
            }
        }
        if (q_sum <= 0.0) continue;

        double kl = 0.0;
        for (int j = 0; j < i; ++j) {
            double p_j = hist[j];
            if (j == i - 1) p_j += tail;
            if (p_j <= 0.0) continue;
            double p_n = p_j / p_sum;
            double q_j = 0.0;
            if (hist[j] > 0.0) {
                int g = (int)(((int64_t)j * levels) / i);
                double nz = nonzero[g] > 1.0 ? nonzero[g] : 1.0;
                q_j = (nonzero[g] > 0.0) ? sums[g] / nz : 0.0;
            }
            double q_n = q_j / q_sum;
            kl += p_n * std::log((p_n + eps) / (q_n + eps));
        }
        if (kl < best_kl) {
            best_kl = kl;
            best_bin = i - 1;
        }
    }
    return best_bin;
}

// ----------------------------------------------------------------- MSE ----
// reference: csrc/cpu/hist_mse.cc compute_mse_loss semantics.
int mse_search(const double* hist, int n, double hist_scale, int levels,
               int interval) {
    int best_bin = n - 1;
    double best_mse = INFINITY;

    // prefix sums for O(1) inside mass
    std::vector<double> prefix(n + 1, 0.0);
    for (int j = 0; j < n; ++j) prefix[j + 1] = prefix[j] + hist[j];

    for (int i = levels; i <= n; i += interval) {
        double clip_val = (i - 0.5) * hist_scale;
        double step = clip_val / levels;
        double mse = prefix[i] * (step * step) / 12.0;
        for (int j = i; j < n; ++j) {
            double center = (j + 0.5) * hist_scale;
            double over = center - clip_val;
            mse += hist[j] * over * over;
        }
        if (mse < best_mse) {
            best_mse = mse;
            best_bin = i - 1;
        }
    }
    return best_bin;
}

// ------------------------------------------------------------- isotone ----
// Pool-adjacent-violators isotonic regression (least squares,
// non-decreasing). out must have n doubles.
void isotone_solve(const double* values, int n, double* out) {
    std::vector<double> vals, wts;
    std::vector<int> sizes;
    vals.reserve(n); wts.reserve(n); sizes.reserve(n);
    for (int i = 0; i < n; ++i) {
        vals.push_back(values[i]);
        wts.push_back(1.0);
        sizes.push_back(1);
        while (vals.size() > 1 && vals[vals.size() - 2] > vals.back()) {
            double v2 = vals.back(), w2 = wts.back();
            int s2 = sizes.back();
            vals.pop_back(); wts.pop_back(); sizes.pop_back();
            double v1 = vals.back(), w1 = wts.back();
            int s1 = sizes.back();
            vals.pop_back(); wts.pop_back(); sizes.pop_back();
            double wt = w1 + w2;
            vals.push_back((v1 * w1 + v2 * w2) / wt);
            wts.push_back(wt);
            sizes.push_back(s1 + s2);
        }
    }
    int idx = 0;
    for (size_t b = 0; b < vals.size(); ++b) {
        for (int k = 0; k < sizes[b]; ++k) out[idx++] = vals[b];
    }
}

// ---------------------------------------------------- hist-MSE loss only ---
// direct equivalent of csrc/cpu/hist_mse.cc compute_mse_loss(hist, start,
// step, end): loss of clipping at `end` with `step`-wide quant bins.
double compute_mse_loss(const double* hist, int n, int start, int step,
                        int end) {
    double loss = 0.0;
    for (int j = 0; j < n; ++j) {
        double center = j + 0.5;
        double err;
        if (j < start) {
            err = 0.0;
        } else if (j >= end) {
            err = center - end;
        } else {
            double rel = std::fmod(center - start, (double)step);
            err = rel - step / 2.0;
        }
        loss += hist[j] * err * err;
    }
    return loss;
}

}  // extern "C"
