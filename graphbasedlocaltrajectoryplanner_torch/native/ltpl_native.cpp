// Native host-side runtime of the PyTorch/CUDA planner port.
//
// The port's own copy of the JAX package's native library: a fast
// track-CSV loader, the variable-step-size layer selection walk, and two
// scalar oracles (the min-plus DP with virtual-goal selection and the
// forward-backward velocity solver) used as independent goldens for the
// CUDA kernels and for log-replay validation without a device.
//
// C ABI, built with g++ at first use and loaded from Python via ctypes
// (see graphbasedlocaltrajectoryplanner_torch/native.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Track CSV loader: semicolon-separated, '#' comments, fixed column count.
// Returns number of rows parsed (<= max_rows), or -1 on error.
// ---------------------------------------------------------------------------
int ltpl_load_csv(const char* path, int n_cols, double* out, int max_rows) {
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    char line[8192];
    int rows = 0;
    while (std::fgets(line, sizeof(line), f)) {
        char* p = line;
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '#' || *p == '\n' || *p == '\0') continue;
        if (rows >= max_rows) break;
        int col = 0;
        char* tok = p;
        while (col < n_cols && tok) {
            char* end = nullptr;
            double v = std::strtod(tok, &end);
            if (end == tok) break;
            out[(int64_t)rows * n_cols + col] = v;
            ++col;
            tok = std::strchr(end, ';');
            if (tok) ++tok;
        }
        if (col == n_cols) ++rows;
    }
    std::fclose(f);
    return rows;
}

// ---------------------------------------------------------------------------
// Variable layer spacing walk (reference variable_step_size.py:31-57).
// Returns the number of selected indices written to out_idx.
// ---------------------------------------------------------------------------
int ltpl_variable_step_size(const double* kappa, const double* dist, int n,
                            double d_curve, double d_straight, double curve_th,
                            int force_last, int* out_idx) {
    double next_dist = 0.0, next_dist_min = 0.0, cur_dist = 0.0;
    int count = 0;
    for (int i = 0; i < n; ++i) {
        double dist_val = dist[i];
        if (cur_dist + dist_val > next_dist_min && std::fabs(kappa[i]) > curve_th)
            next_dist = cur_dist;
        if (cur_dist + dist_val > next_dist) {
            out_idx[count++] = i;
            next_dist += (std::fabs(kappa[i]) < curve_th) ? d_straight : d_curve;
            next_dist_min = cur_dist + d_curve;
        }
        cur_dist += dist_val;
    }
    if (force_last && (count == 0 || out_idx[count - 1] != n - 1))
        out_idx[count++] = n - 1;
    return count;
}

// ---------------------------------------------------------------------------
// Scalar min-plus DP oracle over a (H, N, N) cost window with virtual-goal
// selection — mirrors ops/search.search_window semantics.
//
//   w:        H*N*N row-major costs (>= inf_thresh means "no edge")
//   vg:       (H+1)*N virtual-goal costs
//   start:    start node in window layer 0
//   h_goal:   requested horizon
//   shrink:   1 = fall back to largest feasible h <= h_goal
//   out_nodes: H+1 ints, node chain (-1 beyond the effective horizon)
//
// Returns the effective horizon (0 = infeasible); *out_cost receives the
// total path cost.
// ---------------------------------------------------------------------------
int ltpl_minplus_dp(const float* w, const float* vg, int H, int N, int start,
                    int h_goal, int shrink, float inf_thresh,
                    int* out_nodes, float* out_cost) {
    std::vector<float> best((H + 1) * (size_t)N, 3e38f);
    std::vector<int> bp((H + 1) * (size_t)N, -1);
    best[start] = 0.0f;
    for (int h = 0; h < H; ++h) {
        const float* wl = w + (size_t)h * N * N;
        float* b0 = best.data() + (size_t)h * N;
        float* b1 = best.data() + (size_t)(h + 1) * N;
        int* p1 = bp.data() + (size_t)(h + 1) * N;
        for (int m = 0; m < N; ++m) {
            float bb = 3e38f;
            int pb = -1;
            for (int n = 0; n < N; ++n) {
                float c = b0[n] + wl[(size_t)n * N + m];
                if (c < bb) { bb = c; pb = n; }
            }
            b1[m] = bb;
            p1[m] = pb;
        }
    }
    // goal selection
    int h_eff = 0, goal = -1;
    float best_cost = 3e38f;
    int h_lo = shrink ? 1 : h_goal;
    for (int h = h_goal; h >= h_lo; --h) {
        float bc = 3e38f;
        int bn = -1;
        for (int m = 0; m < N; ++m) {
            float c = best[(size_t)h * N + m] + vg[(size_t)h * N + m];
            if (c < bc) { bc = c; bn = m; }
        }
        if (bc < inf_thresh) { h_eff = h; goal = bn; best_cost = bc; break; }
    }
    for (int h = 0; h <= H; ++h) out_nodes[h] = -1;
    if (h_eff >= 1) {
        out_nodes[h_eff] = goal;
        for (int h = h_eff; h >= 1; --h)
            out_nodes[h - 1] = bp[(size_t)h * N + out_nodes[h]];
    }
    *out_cost = best_cost;
    return h_eff;
}

// ---------------------------------------------------------------------------
// Forward-backward velocity solver oracle (diamond friction model,
// 2-step backward refinement — mirrors ops/velocity.calc_vel_profile_fb).
// machines: M rows [v, ax].  All arrays length P (el has P entries, last
// ignored).  Writes the profile into v_out.
// ---------------------------------------------------------------------------
static double interp_mach(const double* mach, int M, double v) {
    if (v <= mach[0]) return mach[1];
    for (int i = 1; i < M; ++i) {
        if (v <= mach[2 * i]) {
            double t = (v - mach[2 * (i - 1)]) /
                       (mach[2 * i] - mach[2 * (i - 1)]);
            return mach[2 * (i - 1) + 1] +
                   t * (mach[2 * i + 1] - mach[2 * (i - 1) + 1]);
        }
    }
    return mach[2 * (M - 1) + 1];
}

static double ax_tires(double v, double k_abs, double axm, double aym,
                       double exp_) {
    double ay_used = v * v * k_abs;
    double frac = ay_used / (aym > 1e-9 ? aym : 1e-9);
    if (frac > 1.0) frac = 1.0;
    if (frac < 0.0) frac = 0.0;
    double rad = 1.0 - std::pow(frac, exp_);
    return axm * std::pow(rad > 0.0 ? rad : 0.0, 1.0 / exp_);
}

void ltpl_fb_profile(const double* kappa, const double* el, const double* gg,
                     int P, const double* mach, int M, double v_max,
                     double v_start, double v_end, int use_v_end,
                     double dyn_exp, double drag, double mass, double* v_out) {
    std::vector<double> v(P);
    for (int i = 0; i < P; ++i) {
        double k_abs = std::fabs(kappa[i]);
        double vl = std::sqrt(gg[2 * i + 1] / (k_abs > 1e-9 ? k_abs : 1e-9));
        v[i] = vl < v_max ? vl : v_max;
    }
    if (use_v_end && v[P - 1] > v_end) v[P - 1] = v_end;
    if (v[0] > v_start) v[0] = v_start;
    for (int i = 0; i < P - 1; ++i) {
        double a_t = ax_tires(v[i], std::fabs(kappa[i]), gg[2 * i],
                              gg[2 * i + 1], dyn_exp);
        double a_m = interp_mach(mach, M, v[i]);
        double a = (a_t < a_m ? a_t : a_m) - v[i] * v[i] * drag / mass;
        double vn = std::sqrt(std::fmax(v[i] * v[i] + 2.0 * a * el[i], 0.0));
        if (vn < v[i + 1]) v[i + 1] = vn;
    }
    for (int i = P - 2; i >= 0; --i) {
        double a1 = ax_tires(v[i + 1], std::fabs(kappa[i + 1]), gg[2 * (i + 1)],
                             gg[2 * (i + 1) + 1], dyn_exp) +
                    v[i + 1] * v[i + 1] * drag / mass;
        double ve = std::sqrt(v[i + 1] * v[i + 1] + 2.0 * a1 * el[i]);
        double a2 = ax_tires(ve, std::fabs(kappa[i]), gg[2 * i],
                             gg[2 * i + 1], dyn_exp) + ve * ve * drag / mass;
        double a = a1 < a2 ? a1 : a2;
        double vp = std::sqrt(std::fmax(v[i + 1] * v[i + 1] + 2.0 * a * el[i],
                                        0.0));
        if (vp < v[i]) v[i] = vp;
    }
    std::memcpy(v_out, v.data(), sizeof(double) * P);
}

}  // extern "C"
