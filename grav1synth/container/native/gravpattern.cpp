// gravpattern: host-side AV1 film-grain pattern generator for grav1synth.
//
// Needs only the C++ standard library (no libav*), so the grain engine
// runs wherever a compiler is present, decoder libraries or not.
// Exposed as a flat C API loaded from Python via ctypes
// (ops/grain_native.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Host-side grain pattern generation (AV1 spec 7.18.3.2-7.18.3.3).
//
// The pattern arrays are tiny (73x82 + 2x chroma) but the AR filter is a
// sequential recurrence; generating them on host in native code and
// uploading ~26KB/frame is the production split: per-pixel work stays on
// the device, the scalar recurrence runs at native speed here. Bit-exact
// with ops/grain_ref.py (dav1d-validated).

extern "C" {

typedef struct GravGrainParams {
    int32_t seed;
    int32_t num_y_points, num_cb_points, num_cr_points;
    int32_t chroma_scaling_from_luma;
    int32_t ar_coeff_lag;       // 0..3
    int32_t ar_coeff_shift;     // 6..9
    int32_t grain_scale_shift;  // 0..3
    int32_t ar_coeffs_y[24];
    int32_t ar_coeffs_cb[25];
    int32_t ar_coeffs_cr[25];
} GravGrainParams;

}  // extern "C"

namespace {

struct Lfsr {
    uint16_t state;
    explicit Lfsr(uint16_t seed) : state(seed) {}
    int bits(int n) {
        uint16_t r = state;
        uint16_t bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
        r = (uint16_t)((r >> 1) | (bit << 15));
        state = r;
        return (r >> (16 - n)) & ((1 << n) - 1);
    }
};

inline int round2(int x, int shift) {
    if (shift == 0) return x;
    return (x + (1 << (shift - 1))) >> shift;
}

const int16_t* g_gaussian = nullptr;

void generate_plane(Lfsr lfsr, int h, int w, int shift, bool active,
                    int32_t* out) {
    if (!active) {
        std::memset(out, 0, sizeof(int32_t) * h * w);
        return;
    }
    for (int i = 0; i < h * w; i++) {
        out[i] = round2(g_gaussian[lfsr.bits(11)], shift);
    }
}

void ar_filter_luma(int32_t* g, int lag, const int32_t* coeffs, int ar_shift,
                    int gmin, int gmax) {
    if (lag == 0) return;
    const int w = 82, h = 73;
    for (int y = 3; y < h; y++) {
        for (int x = 3; x < w - 3; x++) {
            int64_t s = 0;
            int pos = 0;
            for (int dr = -lag; dr <= 0; dr++) {
                for (int dc = -lag; dc <= lag; dc++) {
                    if (dr == 0 && dc == 0) break;
                    s += (int64_t)coeffs[pos++] * g[(y + dr) * w + (x + dc)];
                }
            }
            int v = g[y * w + x] + round2((int)s, ar_shift);
            g[y * w + x] = v < gmin ? gmin : (v > gmax ? gmax : v);
        }
    }
}

void ar_filter_chroma(int32_t* g, const int32_t* luma, int cw, int ch, int lag,
                      const int32_t* coeffs, int ar_shift, int gmin, int gmax,
                      int subx, int suby, int num_y_points) {
    int n_spatial = 2 * lag * (lag + 1);
    for (int y = 3; y < ch; y++) {
        for (int x = 3; x < cw - 3; x++) {
            int64_t s = 0;
            int pos = 0;
            for (int dr = -lag; dr <= 0; dr++) {
                for (int dc = -lag; dc <= lag; dc++) {
                    if (dr == 0 && dc == 0) break;
                    s += (int64_t)coeffs[pos++] * g[(y + dr) * cw + (x + dc)];
                }
            }
            if (num_y_points > 0) {
                int lx = ((x - 3) << subx) + 3;
                int ly = ((y - 3) << suby) + 3;
                int acc = 0;
                for (int i = 0; i <= suby; i++)
                    for (int j = 0; j <= subx; j++)
                        acc += luma[(ly + i) * 82 + (lx + j)];
                acc = round2(acc, subx + suby);
                s += (int64_t)coeffs[n_spatial] * acc;
            }
            int v = g[y * cw + x] + round2((int)s, ar_shift);
            g[y * cw + x] = v < gmin ? gmin : (v > gmax ? gmax : v);
        }
    }
}

}  // namespace

extern "C" {

// The 2048-entry gaussian_sequence is passed in from Python once (the
// canonical copy lives with the spec tables in ops/tables_data.py).
void grav_set_gaussian_table(const int16_t* table) {
    static int16_t copy[2048];
    std::memcpy(copy, table, sizeof(copy));
    g_gaussian = copy;
}

static void grain_one_frame(const GravGrainParams& p, int bit_depth,
                            int subx, int suby, int monochrome,
                            int shift_base, int gmin, int gmax, int cw,
                            int ch, int32_t* luma, int32_t* cb,
                            int32_t* cr) {
    const int shift = shift_base + p.grain_scale_shift;
    generate_plane(Lfsr((uint16_t)p.seed), 73, 82, shift,
                   p.num_y_points > 0, luma);
    ar_filter_luma(luma, p.ar_coeff_lag, p.ar_coeffs_y, p.ar_coeff_shift,
                   gmin, gmax);
    if (monochrome || !cb) return;
    bool cb_active = p.num_cb_points > 0 || p.chroma_scaling_from_luma;
    bool cr_active = p.num_cr_points > 0 || p.chroma_scaling_from_luma;
    generate_plane(Lfsr((uint16_t)(p.seed ^ 0xb524)), ch, cw, shift,
                   cb_active, cb);
    generate_plane(Lfsr((uint16_t)(p.seed ^ 0x49d8)), ch, cw, shift,
                   cr_active, cr);
    if (cb_active)
        ar_filter_chroma(cb, luma, cw, ch, p.ar_coeff_lag, p.ar_coeffs_cb,
                         p.ar_coeff_shift, gmin, gmax, subx, suby,
                         p.num_y_points);
    if (cr_active)
        ar_filter_chroma(cr, luma, cw, ch, p.ar_coeff_lag, p.ar_coeffs_cr,
                         p.ar_coeff_shift, gmin, gmax, subx, suby,
                         p.num_y_points);
}

// Generates patterns for a batch of frames. Outputs int32, row-major:
// luma (n, 73, 82); cb/cr (n, ch, cw) where cw/ch follow subsampling
// (44/82, 38/73). cb/cr may be null when monochrome.
int grav_generate_grain_patterns(const GravGrainParams* params, int n,
                                 int bit_depth, int subx, int suby,
                                 int monochrome, int32_t* luma_out,
                                 int32_t* cb_out, int32_t* cr_out) {
    if (!g_gaussian) return -1;
    const int shift_base = 12 - bit_depth;
    const int grain_center = 128 << (bit_depth - 8);
    const int gmin = -grain_center, gmax = grain_center - 1;
    const int cw = subx ? 44 : 82;
    const int ch = suby ? 38 : 73;
    // frames are independent: split the batch across threads (the AR
    // recurrence is serial within a frame, ~0.2 ms each; a 32-64 frame
    // batch would otherwise serialize ahead of the device launch)
    int n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads > n) n_threads = n;
    if (n_threads > 16) n_threads = 16;
    if (n_threads > 1) {
        std::vector<std::thread> workers;
        std::atomic<int> next(0);
        auto run = [&]() {
            for (;;) {
                int i = next.fetch_add(1);
                if (i >= n) return;
                grain_one_frame(params[i], bit_depth, subx, suby, monochrome,
                                shift_base, gmin, gmax, cw, ch,
                                luma_out + (int64_t)i * 73 * 82,
                                cb_out ? cb_out + (int64_t)i * ch * cw : nullptr,
                                cr_out ? cr_out + (int64_t)i * ch * cw : nullptr);
            }
        };
        for (int t = 0; t < n_threads; t++) workers.emplace_back(run);
        for (auto& w : workers) w.join();
        return 0;
    }
    for (int i = 0; i < n; i++)
        grain_one_frame(params[i], bit_depth, subx, suby, monochrome,
                        shift_base, gmin, gmax, cw, ch,
                        luma_out + (int64_t)i * 73 * 82,
                        cb_out ? cb_out + (int64_t)i * ch * cw : nullptr,
                        cr_out ? cr_out + (int64_t)i * ch * cw : nullptr);
    return 0;
}

}  // extern "C"
