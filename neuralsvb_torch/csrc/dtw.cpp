// Host DTW dynamic program and pitch Viterbi of the PyTorch port, loaded
// with ctypes by neuralsvb_torch/native.py (g++ -O3 -shared -fPIC
// -std=c++17). The same code as neuralsvb_tpu/native/dtw.cpp, which the JAX
// package builds with the same flags; the port keeps its own copy.
//
// The DP recurrence and backtrace are sequential, so they run on the host;
// the O(S*T*M) cost matrix comes from the card (ops/chi2.py), already in the
// [rows, cols] layout read here (reference: the numba-JIT loop of
// modules/voice_conversion/dtw/align.py:8-37).
//
// Semantics match align_from_distances exactly:
//   dtw[0, 1:] = inf; dtw[1:, 0] = inf
//   dtw[i, j]  = cost[i, j] + min(dtw[i-1,j], dtw[i,j-1], dtw[i-1,j-1])
//   backtrace from (R-1, C-1); ties prefer (i-1,j), then (i,j-1), then
//   (i-1,j-1) (Python min() keeps the first minimal element);
//   results[i] = last j visited in row i; row 0 stays 0.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// cost: row-major [rows, cols]; path_out: [rows] best column per row.
// Returns total alignment cost at (rows-1, cols-1).
double dtw_align(const float* cost, int64_t rows, int64_t cols, int32_t* path_out) {
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<double> prev(cols), cur(cols);

    // row 0: dtw[0,0] = 0 (reference leaves the zeros_like value); dtw[0,1:] = inf
    prev[0] = 0.0;
    for (int64_t j = 1; j < cols; ++j) prev[j] = INF;

    // Full DP table is needed for the backtrace; keep a compact row-major
    // copy of the argmin direction instead of the doubles (4x smaller).
    // dir: 0 = up (i-1,j), 1 = left (i,j-1), 2 = diag (i-1,j-1)
    std::vector<uint8_t> dir((size_t)rows * cols, 0);

    for (int64_t i = 1; i < rows; ++i) {
        const float* crow = cost + i * cols;
        uint8_t* drow = dir.data() + (size_t)i * cols;
        cur[0] = INF;
        for (int64_t j = 1; j < cols; ++j) {
            double up = prev[j], left = cur[j - 1], diag = prev[j - 1];
            double best = up;
            uint8_t d = 0;
            if (left < best) { best = left; d = 1; }
            if (diag < best) { best = diag; d = 2; }
            cur[j] = crow[j] + best;
            drow[j] = d;
        }
        std::swap(prev, cur);
    }
    double total = prev[cols - 1];

    // Backtrace; matches the reference's "results[i] = j then move" loop.
    std::memset(path_out, 0, sizeof(int32_t) * rows);
    int64_t i = rows - 1, j = cols - 1;
    while (i > 0 && j > 0) {
        path_out[i] = (int32_t)j;
        uint8_t d = dir[(size_t)i * cols + j];
        if (d == 0) { i -= 1; }
        else if (d == 1) { j -= 1; }
        else { i -= 1; j -= 1; }
    }
    return total;
}

// Viterbi path for the pitch tracker (ops/pitch.py track_pitch):
// score/backptr DP over T frames x K candidates with octave-jump and
// voiced/unvoiced transition costs, then backtrace. Matches the numpy
// reference implementation bit-for-bit in float64 accumulation.
void pitch_viterbi(const float* freqs, const float* strengths,
                   int64_t T, int64_t K, double octave_jump_cost,
                   double vuv_cost, int32_t* path_out) {
    std::vector<double> score(K), next_score(K);
    std::vector<int32_t> backptr((size_t)T * K, 0);
    for (int64_t k = 0; k < K; ++k) score[k] = strengths[k];
    for (int64_t t = 1; t < T; ++t) {
        const float* pf = freqs + (t - 1) * K;
        const float* f = freqs + t * K;
        const float* st = strengths + t * K;
        for (int64_t j = 0; j < K; ++j) {
            double best = -1e30;
            int32_t arg = 0;
            for (int64_t i = 0; i < K; ++i) {
                double trans;
                bool vp = pf[i] > 0, vc = f[j] > 0;
                if (vp && vc) {
                    double a = pf[i] > 1e-6 ? pf[i] : 1e-6;
                    double b = f[j] > 1e-6 ? f[j] : 1e-6;
                    trans = octave_jump_cost * std::fabs(std::log2(a / b));
                } else if (vp != vc) {
                    trans = vuv_cost;
                } else {
                    trans = 0.0;
                }
                double v = score[i] - trans;
                if (v > best) { best = v; arg = (int32_t)i; }
            }
            backptr[(size_t)t * K + j] = arg;
            next_score[j] = best + st[j];
        }
        std::swap(score, next_score);
    }
    int32_t cur = 0;
    double best = -1e30;
    for (int64_t k = 0; k < K; ++k)
        if (score[k] > best) { best = score[k]; cur = (int32_t)k; }
    path_out[T - 1] = cur;
    for (int64_t t = T - 1; t > 0; --t) {
        cur = backptr[(size_t)t * K + cur];
        path_out[t - 1] = cur;
    }
}

}  // extern "C"
