// Poisson (gradient-domain) seamless cloning — native host-side solver.
//
// The reference composites inversion results back into the original frame
// with OpenCV's C++ seamlessClone (pix2latent/utils/image.py:183-209). This
// is a self-contained equivalent: solve  lap(f) = lap(src)  inside the mask
// (translated so the mask centroid lands on `center`), with f = dst on the
// boundary — i.e. cv2.NORMAL_CLONE. Solved per channel with red-black
// Gauss-Seidel + SOR on the mask interior.
//
// Exposed as a C ABI for ctypes (pix2latent_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

namespace {

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// src, dst: H*W*3 uint8 (RGB); mask: H*W uint8 (nonzero = clone region,
// defined in src coordinates); center_x/center_y: where the mask centroid
// should land in dst; out: H*W*3 uint8.
// Returns 0 on success.
int seamless_clone(const uint8_t* src, const uint8_t* dst,
                   const uint8_t* mask, int h, int w,
                   int center_x, int center_y,
                   int iters, double omega, uint8_t* out) {
    const int n = h * w;

    // mask centroid + translation so it lands on (center_x, center_y)
    long long sum_x = 0, sum_y = 0, cnt = 0;
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            if (mask[y * w + x]) { sum_x += x; sum_y += y; ++cnt; }
    if (cnt == 0) {  // nothing to clone
        std::memcpy(out, dst, (size_t)n * 3);
        return 0;
    }
    const int mcx = (int)(sum_x / cnt), mcy = (int)(sum_y / cnt);
    const int tx = center_x - mcx, ty = center_y - mcy;

    // translated interior mask in dst coordinates (boundary ring excluded so
    // Dirichlet conditions come from dst)
    std::vector<uint8_t> m(n, 0);
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const int sx = x - tx, sy = y - ty;
            if (sx >= 1 && sx < w - 1 && sy >= 1 && sy < h - 1 &&
                y >= 1 && y < h - 1 && x >= 1 && x < w - 1 &&
                mask[sy * w + sx])
                m[y * w + x] = 1;
        }
    }

    std::vector<float> f(n), b(n);
    std::memcpy(out, dst, (size_t)n * 3);

    for (int ch = 0; ch < 3; ++ch) {
        // initial guess: dst; guidance laplacian from src (translated)
        for (int i = 0; i < n; ++i) f[i] = dst[i * 3 + ch];
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                const int i = y * w + x;
                if (!m[i]) { b[i] = 0.f; continue; }
                const int sx = clampi(x - tx, 1, w - 2);
                const int sy = clampi(y - ty, 1, h - 2);
                const int si = sy * w + sx;
                const float c = src[si * 3 + ch];
                const float l = src[(si - 1) * 3 + ch];
                const float r = src[(si + 1) * 3 + ch];
                const float u = src[(si - w) * 3 + ch];
                const float d = src[(si + w) * 3 + ch];
                b[i] = 4.f * c - l - r - u - d;  // -lap(src)
            }
        }

        // red-black SOR on  4 f_i - sum(f_nbr) = b_i
        for (int it = 0; it < iters; ++it) {
            float max_delta = 0.f;
            for (int parity = 0; parity < 2; ++parity) {
                for (int y = 1; y < h - 1; ++y) {
                    int x0 = 1 + ((y + parity) & 1);
                    for (int x = x0; x < w - 1; x += 2) {
                        const int i = y * w + x;
                        if (!m[i]) continue;
                        const float nb =
                            f[i - 1] + f[i + 1] + f[i - w] + f[i + w];
                        const float fnew = (nb + b[i]) * 0.25f;
                        const float delta = fnew - f[i];
                        f[i] += (float)omega * delta;
                        const float ad = std::fabs(delta);
                        if (ad > max_delta) max_delta = ad;
                    }
                }
            }
            if (max_delta < 2e-3f) break;
        }

        for (int i = 0; i < n; ++i) {
            if (m[i]) {
                const float v = std::min(255.f, std::max(0.f, f[i]));
                out[i * 3 + ch] = (uint8_t)std::lround(v);
            }
        }
    }
    return 0;
}

}  // extern "C"
