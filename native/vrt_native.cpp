// vrt_native — host-side native components of volumeraytracer_tpu.
//
// This package's analogue of the reference's host/native layer:
//
//  * vrt_march_float(_ex): the float eikonal march as plain scalar C++ — the
//    same role the reference's -DNCUDA build of cuda_volume_raytracer.cu
//    plays (Makefile:57-58): an independent host implementation of the
//    identical kernel semantics (trace_ray_function,
//    cuda_volume_raytracer.cu:317-374, float instantiation) used as a
//    test oracle against the XLA march.  OpenMP over rays mirrors
//    trace_rays_cpu (.cu:376-394).
//
//  * vrt_solve_harmonic: damped Jacobi sweeps of the edge-weighted grid
//    Laplacian (≙ solveHarmonic, solve_harmonic.cpp:54-117), OpenMP.
//
//  * vrt_pack_rays / vrt_unpack_rays: SoA↔AoS ray marshalling
//    (≙ fill_struct/read_struct, cuda_volume_raytracer.cu:468-516).
//
// Build: make -C native   (g++ -O2 -march=native -fopenmp -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <climits>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Trilinear interpolation of a channels-last (X, Y, Z, C) float field at a
// float voxel position (corner-anchored, matching ops/interp.py
// interp_linear and the reference interpolatef float semantics,
// cuda_volume_raytracer.cu:130-166).
static inline void interp4(const float* f, int X, int Y, int Z, int C,
                           float x, float y, float z, float* out) {
    int ix = (int)std::floor(x), iy = (int)std::floor(y), iz = (int)std::floor(z);
    ix = std::min(std::max(ix, 0), X - 2);
    iy = std::min(std::max(iy, 0), Y - 2);
    iz = std::min(std::max(iz, 0), Z - 2);
    float fx = x - (float)ix, fy = y - (float)iy, fz = z - (float)iz;
    const float gx = 1.f - fx, gy = 1.f - fy, gz = 1.f - fz;
    const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                        fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
    const long sx = (long)Y * Z * C, sy = (long)Z * C, sz = C;
    const float* base = f + (long)ix * sx + (long)iy * sy + (long)iz * sz;
    for (int c = 0; c < C; ++c) out[c] = 0.f;
    int o = 0;
    for (int dx = 0; dx <= 1; ++dx)
        for (int dy = 0; dy <= 1; ++dy)
            for (int dz = 0; dz <= 1; ++dz, ++o) {
                const float* p = base + dx * sx + dy * sy + dz * sz;
                for (int c = 0; c < C; ++c) out[c] += w[o] * p[c];
            }
}

}  // extern "C"

// One ray of the float eikonal march over a packed (dims..., NDIM+1) field,
// state updated in place.  Semantics identical to ops/march.py _float_step
// with opaque_when_positive=true, nearest=false (which itself mirrors
// trace_ray_function, cuda_volume_raytracer.cu:335-349): absorb, interp,
// break on opacity channel > 0, bend, inverse-speed step.  ``tr`` is the
// translucency on the packed grid (nullptr: fully transparent); returns the
// executed steps, budget - remaining.
template <int NDIM>
static uint32_t march_ray(const float* packed, const int* dims,
                          const uint32_t* tr, uint32_t min_brightness,
                          float* p, float* d, uint32_t* brightness,
                          uint32_t budget, const float* bend,
                          const float* step_scale) {
    constexpr int C = NDIM + 1;
    long stride[NDIM];
    stride[NDIM - 1] = C;
    for (int a = NDIM - 2; a >= 0; --a) stride[a] = stride[a + 1] * dims[a + 1];
    // budget-1: the reference consumes one slot for the start path entry
    // (cuda_volume_raytracer.cu:333)
    uint32_t remaining = budget > 0 ? budget - 1 : 0;
    uint32_t b = brightness ? *brightness : 0xFFFFFFFFu;
    for (;;) {
        bool inb = remaining > 0;
        for (int a = 0; a < NDIM; ++a)
            inb = inb && p[a] >= 0.f && p[a] < (float)(dims[a] - 1);
        if (!inb) break;
        int base[NDIM];
        float f[NDIM], g[NDIM];
        long off = 0, voff = 0;
        for (int a = 0; a < NDIM; ++a) {
            const int ia = (int)std::floor(p[a]);
            // absorption reads the voxel that holds the ray (clamped)
            voff += (long)std::min(std::max(ia, 0), dims[a] - 1) * (stride[a] / C);
            base[a] = std::min(std::max(ia, 0), dims[a] - 2);
            f[a] = p[a] - (float)base[a];
            g[a] = 1.f - f[a];
            off += (long)base[a] * stride[a];
        }
        if (tr) {
            b -= std::min(b, 0xFFFFFFFFu - tr[voff]);
            if (b < min_brightness) break;  // went dark (.cu:337-341)
        }
        // corners in itertools.product((0, 1), repeat=NDIM) order, weights
        // multiplied axis by axis (ops/interp.py interp_linear)
        float interp[NDIM + 1] = {};
        for (int o = 0; o < (1 << NDIM); ++o) {
            float w = 1.f;
            long co = off;
            for (int a = 0; a < NDIM; ++a) {
                const int bit = (o >> (NDIM - 1 - a)) & 1;
                w = w * (bit ? f[a] : g[a]);
                co += bit * stride[a];
            }
            for (int c = 0; c < C; ++c) interp[c] += w * packed[co + c];
        }
        if (interp[NDIM] > 0.f) break;  // opaque-surface hit (.cu:343)
        float len2 = 0.f;
        for (int a = 0; a < NDIM; ++a) {
            d[a] += interp[a] * bend[a];
            len2 += d[a] * d[a];
        }
        const float ilen = 1.0f / len2;
        for (int a = 0; a < NDIM; ++a) p[a] += d[a] * step_scale[a] * ilen;
        --remaining;
    }
    if (brightness) *brightness = b;
    return budget - remaining;
}

extern "C" {

// Generalised oracle: 2-D or 3-D packed field, optional translucency (on the
// packed grid) with a brightness floor, optional per-ray budgets.
// ``brightness`` (may be nullptr) returns the remaining light; ``budgets``
// (may be nullptr: every ray gets ``budget``) is per ray.
void vrt_march_float_ex(const float* packed, const int* dims, int ndim,
                        const uint32_t* translucency, uint32_t min_brightness,
                        float* pos, float* dir, uint32_t* iters,
                        uint32_t* brightness, const uint32_t* budgets,
                        int n_rays, uint32_t budget, const float* bend,
                        const float* step_scale, int nthreads) {
#if defined(_OPENMP)
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int i = 0; i < n_rays; ++i) {
        const uint32_t bi = budgets ? budgets[i] : budget;
        uint32_t* br = brightness ? brightness + i : nullptr;
        if (br) *br = 0xFFFFFFFFu;
        if (ndim == 2)
            iters[i] = march_ray<2>(packed, dims, translucency, min_brightness,
                                    pos + 2 * i, dir + 2 * i, br, bi, bend,
                                    step_scale);
        else
            iters[i] = march_ray<3>(packed, dims, translucency, min_brightness,
                                    pos + 3 * i, dir + 3 * i, br, bi, bend,
                                    step_scale);
    }
}

// Float eikonal march over a packed (X, Y, Z, 4) field: the 3-D,
// transparent, one-budget case of vrt_march_float_ex.  Per-ray state is
// updated in place; iters[i] returns executed steps.
void vrt_march_float(const float* packed, int X, int Y, int Z,
                     float* pos, float* dir, uint32_t* iters, int n_rays,
                     uint32_t budget, const float* bend, const float* step_scale,
                     int nthreads) {
    const int dims[3] = {X, Y, Z};
    vrt_march_float_ex(packed, dims, 3, nullptr, 0, pos, dir, iters, nullptr,
                       nullptr, n_rays, budget, bend, step_scale, nthreads);
}

// Damped Jacobi harmonic solve on an N-D grid flattened to (n, ) with
// row-major strides; edge weight 1/(1+dd²) (≙ solve_harmonic.cpp:54-62).
// values/divisor/fixed are length n; dims/strides length ndim.  Returns the
// number of sweeps executed.
int vrt_solve_harmonic(double* values, const double* divisor,
                       const uint8_t* fixed_mask, const int64_t* dims,
                       int ndim, int64_t n, int max_iterations,
                       double max_error, int nthreads) {
#if defined(_OPENMP)
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    int64_t strides[8];
    strides[ndim - 1] = 1;
    for (int a = ndim - 2; a >= 0; --a) strides[a] = strides[a + 1] * dims[a + 1];
    double* next = new double[n];
    int it = 0;
    for (; it < max_iterations; ++it) {
        double err = 0.0;
#if defined(_OPENMP)
#pragma omp parallel for reduction(+ : err) schedule(static)
#endif
        for (int64_t idx = 0; idx < n; ++idx) {
            if (fixed_mask[idx]) { next[idx] = values[idx]; continue; }
            double acc = 0.0, wsum = 0.0;
            int64_t rem = idx;
            for (int a = 0; a < ndim; ++a) {
                const int64_t coord = rem / strides[a];
                rem %= strides[a];
                if (coord > 0) {
                    const int64_t j = idx - strides[a];
                    const double dd = divisor[idx] - divisor[j];
                    const double w = 1.0 / (1.0 + dd * dd);
                    acc += w * values[j]; wsum += w;
                }
                if (coord < dims[a] - 1) {
                    const int64_t j = idx + strides[a];
                    const double dd = divisor[idx] - divisor[j];
                    const double w = 1.0 / (1.0 + dd * dd);
                    acc += w * values[j]; wsum += w;
                }
            }
            if (wsum <= 0.0) { next[idx] = values[idx]; continue; }
            // damped update: average with the middle value
            // (erg += add_middle; erg /= div_sum * 2, solve_harmonic.cpp:89-97)
            const double add_middle = wsum * values[idx];
            const double v = (acc + add_middle) / (2.0 * wsum);
            const double d = v - add_middle;  // reference error metric (:101-104)
            err += d * d;
            next[idx] = v;
        }
        std::memcpy(values, next, (size_t)n * sizeof(double));
        if (err < max_error) { ++it; break; }
    }
    delete[] next;
    return it;
}

// ---------------------------------------------------------------------------
// Scene-level C API — the second-language binding (≙ the reference's JNI
// entry points new_instance / trace_rays / delete_instance,
// java_binding.cpp:179-241,248-287,294-304): build the scene ONCE
// (preprocessing: log-index, {14,47,162}/0x100 smoothed gradients, opacity
// channel — RaytraceScene ctor, image_util.cpp:430-643 float semantics),
// then trace many ray batches in place.  Pure C ABI: callable from C, C++,
// Java (JNI/Panama), C#, Rust, ... — see vrt_native.h.

// Options block, get/set by integer key (≙ the reference Options struct
// exposed over JNI by key, java_binding.cpp:322-381; types.h:83-91).
struct vrt_options {
    int64_t loglevel = 0;        // negative = more verbose
    int64_t minimum_device = 0x80;  // ≙ _minimum_gpu
    int64_t max_cpu = 256;       // ≙ _max_cpu
};

vrt_options* vrt_options_new(void) { return new vrt_options; }
void vrt_options_free(vrt_options* opt) { delete opt; }

int vrt_options_set(vrt_options* opt, int key, int64_t value) {
    if (!opt) return -1;
    switch (key) {
        case 0: opt->loglevel = value; return 0;
        case 1: opt->minimum_device = value; return 0;
        case 2: opt->max_cpu = value; return 0;
        default: return -1;
    }
}

int64_t vrt_options_get(const vrt_options* opt, int key) {
    if (!opt) return INT64_MIN;
    switch (key) {
        case 0: return opt->loglevel;
        case 1: return opt->minimum_device;
        case 2: return opt->max_cpu;
        default: return INT64_MIN;
    }
}

struct vrt_scene {
    int X, Y, Z;    // ior grid bounds
    float* ior;     // copy of the (X, Y, Z) grid (|v| = n initialisation)
    float* packed;  // (X-2, Y-2, Z-2, 4) preprocessed field
    vrt_options opt;  // copy of the options used at build time
};

// 3x3 smoothing stamp perpendicular to the derivative axis and total
// |stencil| weight 2*sum = 812 (standart_3d_stamp, image_util.cpp:421-425)
static const float VRT_STAMP[3][3] = {
    {14.f, 47.f, 14.f}, {47.f, 162.f, 47.f}, {14.f, 47.f, 14.f}};
static const double VRT_STAMP_W = 812.0;

vrt_scene* vrt_scene_new_opt(const float* ior, int X, int Y, int Z,
                             const uint32_t* translucency,
                             const vrt_options* opt);

vrt_scene* vrt_scene_new(const float* ior, int X, int Y, int Z,
                         const uint32_t* translucency) {
    return vrt_scene_new_opt(ior, X, Y, Z, translucency, nullptr);
}

vrt_scene* vrt_scene_new_opt(const float* ior, int X, int Y, int Z,
                             const uint32_t* translucency,
                             const vrt_options* opt) {
    if (!ior || X < 3 || Y < 3 || Z < 3) return nullptr;
    const long nvox = (long)X * Y * Z;
    for (long i = 0; i < nvox; ++i)
        if (!(ior[i] > 0.f)) return nullptr;  // log() domain (fields.py)

    vrt_scene* s = new vrt_scene;
    s->X = X; s->Y = Y; s->Z = Z;
    if (opt) s->opt = *opt;
    s->ior = new float[nvox];
    std::memcpy(s->ior, ior, (size_t)nvox * sizeof(float));
    if (s->opt.loglevel < -1) {
        // field statistics at high verbosity (≙ image_util.cpp:562-573)
        float mn = ior[0], mx = ior[0];
        for (long i = 1; i < nvox; ++i) {
            mn = ior[i] < mn ? ior[i] : mn;
            mx = ior[i] > mx ? ior[i] : mx;
        }
        std::fprintf(stderr, "vrt_scene_new: bounds %dx%dx%d ior [%g, %g]\n",
                     X, Y, Z, (double)mn, (double)mx);
    }

    // ior_log = log(ior) * 0x420000 (image_util.cpp:611-614)
    float* L = new float[nvox];
    for (long i = 0; i < nvox; ++i)
        L[i] = std::log(ior[i]) * 4325376.0f;

    const int OX = X - 2, OY = Y - 2, OZ = Z - 2;
    s->packed = new float[(long)OX * OY * OZ * 4];
    const long sx = (long)Y * Z, sy = Z;
    const double div = VRT_STAMP_W * 256.0;  // weight * 0x100

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int i = 0; i < OX; ++i)
        for (int j = 0; j < OY; ++j)
            for (int k = 0; k < OZ; ++k) {
                float* out = s->packed + (((long)i * OY + j) * OZ + k) * 4;
                for (int a = 0; a < 3; ++a) {
                    // perp axes in ascending order (ops/fields.py _axis_diff)
                    int ea[3] = {0, 0, 0};
                    ea[a] = 1;
                    int u = (a == 0) ? 1 : 0, v = (a == 2) ? 1 : 2;
                    int eu[3] = {0, 0, 0}, ev[3] = {0, 0, 0};
                    eu[u] = 1; ev[v] = 1;
                    float acc = 0.f;
                    for (int p = 0; p < 3; ++p)
                        for (int q = 0; q < 3; ++q) {
                            const long xx = i + 2 * ea[0] + p * eu[0] + q * ev[0];
                            const long yy = j + 2 * ea[1] + p * eu[1] + q * ev[1];
                            const long zz = k + 2 * ea[2] + p * eu[2] + q * ev[2];
                            const long x0 = i + p * eu[0] + q * ev[0];
                            const long y0 = j + p * eu[1] + q * ev[1];
                            const long z0 = k + p * eu[2] + q * ev[2];
                            acc += VRT_STAMP[p][q] *
                                   (L[xx * sx + yy * sy + zz] -
                                    L[x0 * sx + y0 * sy + z0]);
                        }
                    out[a] = (float)(acc / div);
                }
                // opacity = trunc((0x7FFFFFFF - tr) / 0x10000)
                // (cuda_volume_raytracer.cu:654-658), translucency cropped
                // by one voxel per side (image_util.cpp:517-521)
                uint32_t tr = 0xFFFFFFFFu;
                if (translucency)
                    tr = translucency[((long)(i + 1) * Y + (j + 1)) * Z + (k + 1)];
                int32_t q = 0x7FFF - (int32_t)(tr >> 16);
                const int32_t r = 0xFFFF - (int32_t)(tr & 0xFFFFu);
                if (q < 0 && r > 0) ++q;  // trunc-toward-zero
                out[3] = (float)q;
            }
    delete[] L;
    return s;
}

void vrt_scene_trace(const vrt_scene* s, float* pos, float* dir,
                     uint32_t* iters, int n_rays, uint32_t budget,
                     const float* invscale, int normalize_length,
                     int nthreads) {
    if (nthreads <= 0 && s->opt.max_cpu < 256)
        nthreads = (int)s->opt.max_cpu;  // ≙ Options::_max_cpu cap
    if (s->opt.loglevel < 0)
        std::fprintf(stderr, "vrt_scene_trace: %d rays, budget %u\n",
                     n_rays, budget);
    float bend[3], step[3];
    for (int a = 0; a < 3; ++a) {
        bend[a] = invscale[a] / 65536.0f;
        step[a] = (float)((double)invscale[a] * (1107296256.0 / 65536.0 / 65536.0));
    }
    // pre-shift −0.5, |v| = n init, −0.5 again (image_util.cpp:692-710)
    for (int i = 0; i < n_rays; ++i) {
        float* p = pos + 3 * i;
        if (normalize_length) {
            p[0] -= 0.5f; p[1] -= 0.5f; p[2] -= 0.5f;
            float n0;
            interp4(s->ior, s->X, s->Y, s->Z, 1, p[0], p[1], p[2], &n0);
            dir[3 * i] *= n0; dir[3 * i + 1] *= n0; dir[3 * i + 2] *= n0;
            p[0] -= 0.5f; p[1] -= 0.5f; p[2] -= 0.5f;
        } else {
            p[0] -= 1.0f; p[1] -= 1.0f; p[2] -= 1.0f;
        }
    }
    vrt_march_float(s->packed, s->X - 2, s->Y - 2, s->Z - 2, pos, dir, iters,
                    n_rays, budget, bend, step, nthreads);
    // post-shift +1 voxel (image_util.cpp:770-771)
    for (int i = 0; i < 3 * n_rays; ++i) pos[i] += 1.0f;
}

void vrt_scene_bounds(const vrt_scene* s, int* bounds_out) {
    bounds_out[0] = s->X; bounds_out[1] = s->Y; bounds_out[2] = s->Z;
}

void vrt_scene_free(vrt_scene* s) {
    if (!s) return;
    delete[] s->ior;
    delete[] s->packed;
    delete s;
}

// SoA -> AoS ray packing (≙ fill_struct, cuda_volume_raytracer.cu:468-488):
// out[i] = {pos[3], dir[3], brightness, iterations} as 8 floats/uints.
void vrt_pack_rays(const float* pos, const float* dir,
                   const uint32_t* brightness, const uint32_t* iterations,
                   int n, float* out) {
    for (int i = 0; i < n; ++i) {
        float* o = out + 8 * i;
        std::memcpy(o, pos + 3 * i, 3 * sizeof(float));
        std::memcpy(o + 3, dir + 3 * i, 3 * sizeof(float));
        std::memcpy(o + 6, brightness + i, sizeof(uint32_t));
        std::memcpy(o + 7, iterations + i, sizeof(uint32_t));
    }
}

// AoS -> SoA (≙ read_struct, cuda_volume_raytracer.cu:490-516)
void vrt_unpack_rays(const float* in, int n, float* pos, float* dir,
                     uint32_t* brightness, uint32_t* iterations) {
    for (int i = 0; i < n; ++i) {
        const float* o = in + 8 * i;
        std::memcpy(pos + 3 * i, o, 3 * sizeof(float));
        std::memcpy(dir + 3 * i, o + 3, 3 * sizeof(float));
        std::memcpy(brightness + i, o + 6, sizeof(uint32_t));
        std::memcpy(iterations + i, o + 7, sizeof(uint32_t));
    }
}

}  // extern "C"
