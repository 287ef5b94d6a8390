/* Per-image crop + horizontal mirror for NHWC batches, dtype-generic.
 *
 * The host-side inner loop of the input pipeline: per-image slicing is
 * the one part of the loader that does not vectorize in numpy (per-image
 * offsets), so it lives here as row memcpys.  Element size is a
 * parameter, so uint8 and float32 batches share one implementation.
 * Compiled at first use by theanompi_torch.native (cc -O3) into
 * theanompi_torch/native/_build/; the numpy loop in the data modules
 * remains the reference implementation it is tested against.
 */
#include <string.h>

void crop_mirror_batch(const char *src, char *dst,
                       long n, long src_h, long src_w, long c, long esize,
                       long out_h, long out_w,
                       const long *ys, const long *xs,
                       const unsigned char *flips) {
    const long px = c * esize;
    const long src_img = src_h * src_w * px, src_row = src_w * px;
    const long dst_img = out_h * out_w * px, dst_row = out_w * px;
    for (long i = 0; i < n; ++i) {
        const char *s0 = src + i * src_img + ys[i] * src_row + xs[i] * px;
        char *d0 = dst + i * dst_img;
        if (!flips[i]) {
            for (long r = 0; r < out_h; ++r)
                memcpy(d0 + r * dst_row, s0 + r * src_row, dst_row);
        } else {
            for (long r = 0; r < out_h; ++r) {
                const char *sr = s0 + r * src_row;
                char *dr = d0 + r * dst_row;
                for (long q = 0; q < out_w; ++q)
                    memcpy(dr + q * px, sr + (out_w - 1 - q) * px, px);
            }
        }
    }
}
