// Native CPU Viterbi core (the port's copy of
// viterbi_spl_tpu/native/viterbi_native.cpp).
//
// C++ counterpart of the reference's only native component — the Numba
// AOT-compiled module (dcnet/aot_viterbi_core.py:141-198, exporting
// core(f4[:,::1], f4[:], f4[:,::1]) -> i8[:]), with identical DP semantics
// to hmm/oracle.py: log-domain max-plus recursion, float32 tables,
// first-max tie-breaking, tiny = FLT_MIN floor, backward pointer chase.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency):
//   viterbi_core(B, prob_init, probs, S, T, states_out)
//     B:        [S, S] row-major, B[s][s'] = A[s'][s] (transposed A)
//     probs:    [T, S] row-major observation probabilities
//     states:   [T] int64 output
//   viterbi_core_log(...) — same but inputs already in log domain
//   backtrace(T2 [T, S] int32 row-major, T, S, last_state, states_out)

#include <cstdint>
#include <cfloat>
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

static void forward_log(const float* logB, const float* log_init,
                        const float* log_obs, int64_t S, int64_t T,
                        std::vector<float>& T1, std::vector<int32_t>& T2) {
    T1.resize(S);
    std::vector<float> next(S);
    T2.resize(T * S);
    for (int64_t s = 0; s < S; ++s) T1[s] = log_init[s] + log_obs[s];
    for (int64_t t = 1; t < T; ++t) {
        const float* obs_t = log_obs + t * S;
        int32_t* bp_t = T2.data() + t * S;
        for (int64_t s = 0; s < S; ++s) {
            const float* Brow = logB + s * S;
            float best = T1[0] + Brow[0];
            int32_t arg = 0;
            for (int64_t sp = 1; sp < S; ++sp) {
                float v = T1[sp] + Brow[sp];
                if (v > best) { best = v; arg = (int32_t)sp; }
            }
            bp_t[s] = arg;
            next[s] = best + obs_t[s];
        }
        std::memcpy(T1.data(), next.data(), S * sizeof(float));
    }
}

// probabilities in, logs taken internally with the float32-tiny floor
int32_t viterbi_core(const float* B, const float* prob_init,
                     const float* probs, int64_t S, int64_t T,
                     int64_t* states_out) {
    if (S <= 0 || T <= 0) return -1;
    const float tiny = FLT_MIN;
    std::vector<float> logB((size_t)S * S), log_init(S), log_obs((size_t)T * S);
    for (int64_t i = 0; i < S * S; ++i) logB[i] = std::log(B[i] + tiny);
    for (int64_t s = 0; s < S; ++s) log_init[s] = std::log(prob_init[s] + tiny);
    for (int64_t i = 0; i < T * S; ++i) log_obs[i] = std::log(probs[i] + tiny);

    std::vector<float> T1;
    std::vector<int32_t> T2;
    forward_log(logB.data(), log_init.data(), log_obs.data(), S, T, T1, T2);

    int64_t s = 0;
    float best = T1[0];
    for (int64_t i = 1; i < S; ++i)
        if (T1[i] > best) { best = T1[i]; s = i; }
    states_out[T - 1] = s;
    for (int64_t t = T - 2; t >= 0; --t) {
        s = T2[(size_t)(t + 1) * S + s];
        states_out[t] = s;
    }
    return 0;
}

// log-domain inputs (the float32 log operands the decoders take)
int32_t viterbi_core_log(const float* logB, const float* log_init,
                         const float* log_obs, int64_t S, int64_t T,
                         int64_t* states_out) {
    if (S <= 0 || T <= 0) return -1;
    std::vector<float> T1;
    std::vector<int32_t> T2;
    forward_log(logB, log_init, log_obs, S, T, T1, T2);
    int64_t s = 0;
    float best = T1[0];
    for (int64_t i = 1; i < S; ++i)
        if (T1[i] > best) { best = T1[i]; s = i; }
    states_out[T - 1] = s;
    for (int64_t t = T - 2; t >= 0; --t) {
        s = T2[(size_t)(t + 1) * S + s];
        states_out[t] = s;
    }
    return 0;
}

// standalone pointer chase over a precomputed backpointer table
int32_t backtrace(const int32_t* T2, int64_t T, int64_t S,
                  int64_t last_state, int64_t* states_out) {
    if (S <= 0 || T <= 0 || last_state < 0 || last_state >= S) return -1;
    int64_t s = last_state;
    states_out[T - 1] = s;
    for (int64_t t = T - 2; t >= 0; --t) {
        s = T2[(size_t)(t + 1) * S + s];
        if (s < 0 || s >= S) return -2;
        states_out[t] = s;
    }
    return 0;
}

}  // extern "C"
