// Order-0 zoom and order-0 rotate of 2D host arrays, the two inner loops
// of the ACDC augmentation (RandomGenerator, the FixMatch pairs, the
// device bank's canonical resize), called through ctypes from
// icl_tpu_torch/native/__init__.py. scipy.ndimage's pixels, in scipy's
// arithmetic (double coordinates, then rounded to the nearest index):
//   zoom (grid_mode=False):  c = dst * ((in-1)/(out-1)), src = floor(c + 0.5);
//                            0 when out == 1
//   rotate (reshape=False):  c = R(dst - c0) + c0, c0 = (n-1)/2, nearest
// and in both cval 0 where the unrounded c lies outside [0, n-1]. For the
// zoom that happens where the product rounds the last c just past in-1
// (232 -> 224, 201 -> 384, 512 -> 224, ...): scipy writes 0 in that last
// row or column, and so does this code. The JAX package's helper, whose
// arithmetic this otherwise keeps, clamps there and copies the last input
// row or column.
//
// Built by icl_tpu_torch/ops/build.py:build_host_library with
//   g++ -std=c++17 -O3 -shared -fPIC -ffp-contract=off
// No -march=native (a cached build must run on any CPU of its
// architecture) and no FMA contraction (a fused multiply-add rounds the
// source coordinate of a near-tie differently from scipy's separate
// product and sum).
#include <cmath>
#include <cstdint>

namespace {

constexpr double kPi = 3.14159265358979323846;  // M_PI is not standard C++

// The source index of output index i, or -1 where scipy writes cval.
inline int zoom_index(int i, int in_size, int out_size) {
    if (out_size == 1) return 0;
    const double c = i * (double(in_size - 1) / double(out_size - 1));
    if (c > in_size - 1) return -1;
    return int(std::floor(c + 0.5));
}

template <typename T>
void zoom_nearest(const T* in, int h, int w, T* out, int oh, int ow) {
    // the column map once; rows on the fly
    int* col = new int[ow];
    for (int j = 0; j < ow; ++j) col[j] = zoom_index(j, w, ow);
    for (int i = 0; i < oh; ++i) {
        const int r = zoom_index(i, h, oh);
        T* orow = out + size_t(i) * ow;
        if (r < 0) {
            for (int j = 0; j < ow; ++j) orow[j] = T(0);
            continue;
        }
        const T* row = in + size_t(r) * w;
        for (int j = 0; j < ow; ++j) orow[j] = col[j] < 0 ? T(0) : row[col[j]];
    }
    delete[] col;
}

template <typename T>
void rotate_nearest(const T* in, int h, int w, float angle_deg, T* out) {
    // scipy.ndimage.rotate(order=0, reshape=False, mode='constant'):
    // output(o) = input(R^-1 (o - c) + c); for order 0 a nearest gather
    // that rounds the source coordinate.
    const double theta = -double(angle_deg) * kPi / 180.0;
    const double ct = std::cos(theta), st = std::sin(theta);
    const double cy = (h - 1) / 2.0, cx = (w - 1) / 2.0;
    for (int i = 0; i < h; ++i) {
        const double dy = i - cy;
        T* orow = out + size_t(i) * w;
        for (int j = 0; j < w; ++j) {
            const double dx = j - cx;
            const double sy = ct * dy - st * dx + cy;
            const double sx = st * dy + ct * dx + cx;
            // scipy's validity rule: the UNROUNDED coordinate must lie in
            // [0, size-1]; otherwise cval
            if (sy < 0.0 || sy > h - 1 || sx < 0.0 || sx > w - 1) {
                orow[j] = T(0);
            } else {
                const long iy = long(std::floor(sy + 0.5));
                const long ix = long(std::floor(sx + 0.5));
                orow[j] = in[size_t(iy) * w + ix];
            }
        }
    }
}

}  // namespace

extern "C" {

void zoom_nearest_f32(const float* in, int h, int w, float* out, int oh, int ow) {
    zoom_nearest<float>(in, h, w, out, oh, ow);
}

void zoom_nearest_u8(const uint8_t* in, int h, int w, uint8_t* out, int oh, int ow) {
    zoom_nearest<uint8_t>(in, h, w, out, oh, ow);
}

void rotate_nearest_f32(const float* in, int h, int w, float angle, float* out) {
    rotate_nearest<float>(in, h, w, angle, out);
}

void rotate_nearest_u8(const uint8_t* in, int h, int w, float angle, uint8_t* out) {
    rotate_nearest<uint8_t>(in, h, w, angle, out);
}

}  // extern "C"
