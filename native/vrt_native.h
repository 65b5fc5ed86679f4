/* vrt_native.h — public C ABI of the volumeraytracer_tpu native library.
 *
 * The framework's second-language binding (the role the reference's JNI
 * layer plays, /root/reference/src/java_binding.cpp): any host language
 * with a C FFI (C, C++, Java via JNI/Panama, C#, Rust, ...) can build a
 * scene once and trace ray batches against it, with no Python involved.
 * The device compute path (JAX/XLA) is independent; this library is the
 * host-native oracle + embedding entry point (≙ the reference's -DNCUDA
 * scalar build, /root/reference/Makefile:57-58).
 *
 * Link: -lvrt_native (build with `make -C native`).  All functions are
 * thread-compatible; a vrt_scene is immutable after creation and may be
 * traced from multiple threads concurrently.
 */
#ifndef VRT_NATIVE_H
#define VRT_NATIVE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- options (get/set by integer key) --------------------------------- */
/* ≙ the reference's Options struct exposed over JNI by integer key
 * (java_binding.cpp:322-381; types.h:83-91).  Negative loglevel = more
 * verbose. */

typedef struct vrt_options vrt_options;

enum {
    VRT_OPT_LOGLEVEL = 0,      /* ≙ Options::_loglevel */
    VRT_OPT_MINIMUM_DEVICE = 1,/* ≙ Options::_minimum_gpu (default 0x80) */
    VRT_OPT_MAX_CPU = 2        /* ≙ Options::_max_cpu (default 256) */
};

vrt_options* vrt_options_new(void);
void vrt_options_free(vrt_options* opt);
/* Returns 0 on success, -1 on unknown key. */
int vrt_options_set(vrt_options* opt, int key, int64_t value);
/* Returns the value, or INT64_MIN on unknown key. */
int64_t vrt_options_get(const vrt_options* opt, int key);

/* ---- scene API (build once, trace many) ------------------------------- */

typedef struct vrt_scene vrt_scene;

/* Build a scene from an (X, Y, Z) row-major float refractive-index grid
 * (all values > 0) and an optional (X, Y, Z) uint32 translucency grid
 * (0xFFFFFFFF = fully transparent; pass NULL for a fully transparent
 * volume).  Runs the reference preprocessing in float semantics:
 * log(ior)*0x420000, {14,47,162}/0x100 smoothed central-difference
 * gradients (valid windows, grid shrinks by 2), opacity channel
 * trunc((0x7FFFFFFF - translucency)/0x10000).  Returns NULL on invalid
 * input (bounds < 3 or non-positive ior). */
vrt_scene* vrt_scene_new(const float* ior, int X, int Y, int Z,
                         const uint32_t* translucency);

/* As vrt_scene_new, honouring an options block (may be NULL = defaults):
 * loglevel < 0 prints field statistics during the build (≙ the reference's
 * loglevel < -1 min/max dumps, image_util.cpp:562-573); max_cpu caps the
 * default OpenMP parallelism of vrt_scene_trace when nthreads <= 0. */
vrt_scene* vrt_scene_new_opt(const float* ior, int X, int Y, int Z,
                             const uint32_t* translucency,
                             const vrt_options* opt);

/* Trace n_rays rays IN PLACE (like the reference JNI trace_rays,
 * java_binding.cpp:84-169): pos/dir are (n_rays, 3) row-major float voxel
 * coordinates/directions, iters receives executed step counts.  budget is
 * the per-ray step budget; invscale is the per-axis inverse scale (the
 * reference's invscale, typically {2,2,2}); normalize_length != 0 applies
 * the |v| = n initialisation (direction scaled by the interpolated index
 * at the start point, image_util.cpp:692-710).  nthreads > 0 caps OpenMP
 * parallelism (<= 0: library default). */
void vrt_scene_trace(const vrt_scene* scene, float* pos, float* dir,
                     uint32_t* iters, int n_rays, uint32_t budget,
                     const float* invscale, int normalize_length,
                     int nthreads);

/* Write the scene's (X, Y, Z) ior bounds into bounds_out[3]. */
void vrt_scene_bounds(const vrt_scene* scene, int* bounds_out);

void vrt_scene_free(vrt_scene* scene);

/* ---- raw kernel + helpers --------------------------------------------- */

/* Float eikonal march over a preprocessed (X, Y, Z, 4) channels-last field
 * (see vrt_scene_new for the encoding).  State updated in place; positions
 * are in the packed-grid frame (scene frame minus 1 voxel). */
void vrt_march_float(const float* packed, int X, int Y, int Z,
                     float* pos, float* dir, uint32_t* iters, int n_rays,
                     uint32_t budget, const float* bend,
                     const float* step_scale, int nthreads);

/* Generalised oracle march: ndim 2 or 3 over a packed (dims..., ndim+1)
 * field; optional translucency on the packed grid with a brightness floor
 * (``brightness`` returns the remaining light, may be NULL); optional
 * per-ray budgets (NULL: every ray gets ``budget``). */
void vrt_march_float_ex(const float* packed, const int* dims, int ndim,
                        const uint32_t* translucency, uint32_t min_brightness,
                        float* pos, float* dir, uint32_t* iters,
                        uint32_t* brightness, const uint32_t* budgets,
                        int n_rays, uint32_t budget, const float* bend,
                        const float* step_scale, int nthreads);

/* Damped Jacobi harmonic solve (≙ solveHarmonic, solve_harmonic.cpp):
 * values/divisor (length n, row-major over dims[ndim]) updated in place,
 * fixed_mask marks Dirichlet cells.  Returns sweeps executed. */
int vrt_solve_harmonic(double* values, const double* divisor,
                       const uint8_t* fixed_mask, const int64_t* dims,
                       int ndim, int64_t n, int max_iterations,
                       double max_error, int nthreads);

/* SoA <-> AoS ray marshalling (8 floats per ray: pos[3], dir[3],
 * brightness, iterations — ≙ fill_struct/read_struct). */
void vrt_pack_rays(const float* pos, const float* dir,
                   const uint32_t* brightness, const uint32_t* iterations,
                   int n, float* out);
void vrt_unpack_rays(const float* in, int n, float* pos, float* dir,
                     uint32_t* brightness, uint32_t* iterations);

#ifdef __cplusplus
}
#endif

#endif /* VRT_NATIVE_H */
