/* JPEG decode for the ImageNet host input path of the PyTorch port: a
 * plain C library loaded with ctypes (recordio/jpeg.py), built at first
 * use by recordio/_build.py into build/torch_native/.
 *
 * The port's own copy of the JAX package's decoder, with the same code,
 * so both decode to the same bytes.  A call releases the GIL for its
 * whole duration (ctypes), so a thread pool scales across cores, and it
 * uses libjpeg's DCT scaling to decode at 1/2, 1/4 or 1/8 of the size
 * when a target size is given, instead of at full resolution.  It
 * builds against the system's jpeglib.h and libjpeg, or against the
 * headers vendored under include/ (libjpeg-turbo 2.1.5, ABI 62; their
 * license is include/LICENSE.libjpeg-turbo) and the libjpeg that
 * Pillow's wheel bundles.
 *
 * API (ctypes):
 *   tfos_jpeg_decode(buf, len, target_min, out, out_cap, &w, &h)
 *     Decode to RGB8 rows in `out`.  target_min > 0 picks the largest
 *     DCT downscale whose output still has min(w, h) >= target_min;
 *     target_min <= 0 decodes at full size.  Returns 0 on success,
 *     -1 corrupt/not-a-jpeg, -2 output buffer too small, -3 a libjpeg
 *     warning (the caller arbitrates through PIL).
 *   tfos_jpeg_decode_resized(buf, len, size, scratch, scratch_cap, dst)
 *     DCT-scaled decode and bilinear resize to [size, size, 3] in one
 *     call.
 *   tfos_jpeg_info(buf, len, target_min, &w, &h)
 *     The (scaled) output size, without decoding.
 */

#include <setjmp.h>
#include <stdlib.h>
#include <stddef.h>
#include <stdio.h>
#include <string.h>

#include <jpeglib.h>

struct tfos_jpeg_err {
    struct jpeg_error_mgr mgr;
    jmp_buf jump;
};

static void tfos_jpeg_error_exit(j_common_ptr cinfo) {
    struct tfos_jpeg_err *err = (struct tfos_jpeg_err *)cinfo->err;
    longjmp(err->jump, 1); /* corrupt stream: unwind, no abort()/stderr */
}

static void tfos_jpeg_silence(j_common_ptr cinfo) { (void)cinfo; }

int tfos_jpeg_decode(const unsigned char *buf, size_t len, int target_min,
                     unsigned char *out, size_t out_cap, int *out_w,
                     int *out_h) {
    struct jpeg_decompress_struct cinfo;
    struct tfos_jpeg_err err;

    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = tfos_jpeg_error_exit;
    err.mgr.output_message = tfos_jpeg_silence;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, (unsigned char *)buf, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.out_color_space = JCS_RGB;
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    if (target_min > 0) {
        /* largest denominator in {8,4,2} keeping min-dim >= target */
        unsigned d;
        unsigned minside = cinfo.image_width < cinfo.image_height
                               ? cinfo.image_width
                               : cinfo.image_height;
        for (d = 8; d > 1; d /= 2) {
            if (minside / d >= (unsigned)target_min) {
                cinfo.scale_denom = d;
                break;
            }
        }
    }
    jpeg_calc_output_dimensions(&cinfo);
    if ((size_t)cinfo.output_width * cinfo.output_height * 3 > out_cap) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    jpeg_start_decompress(&cinfo);
    {
        size_t stride = (size_t)cinfo.output_width * cinfo.output_components;
        while (cinfo.output_scanline < cinfo.output_height) {
            JSAMPROW row = out + (size_t)cinfo.output_scanline * stride;
            jpeg_read_scanlines(&cinfo, &row, 1);
        }
    }
    *out_w = (int)cinfo.output_width;
    *out_h = (int)cinfo.output_height;
    jpeg_finish_decompress(&cinfo);
    /* jpeg_mem_src pads a truncated stream with a fake EOI and decodes
     * the rest as gray — only a WARNING records it.  Be strict: any
     * warning is a failure (-3); the Python layer arbitrates by
     * retrying through PIL, so weird-but-valid warning-emitting JPEGs
     * degrade to the old path instead of garbage training data. */
    if (cinfo.err->num_warnings > 0) {
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

/* Separable half-pixel-center bilinear resize, RGB8 [h,w] -> [size,size].
 * Kept native so the whole decode+resize pipeline runs GIL-free under a
 * Python thread pool (the numpy version measured 116 img/s and held the
 * GIL — slower than PIL end to end). */
int tfos_resize_bilinear_rgb(const unsigned char *src, int h, int w,
                             unsigned char *dst, int size) {
    int x, y, c;
    if (h <= 0 || w <= 0 || size <= 0) return -1;
    /* precompute x-axis sampling */
    int *x0 = (int *)malloc(sizeof(int) * size);
    float *wx = (float *)malloc(sizeof(float) * size);
    if (!x0 || !wx) {
        if (x0) free(x0);
        if (wx) free(wx);
        return -2;
    }
    for (x = 0; x < size; x++) {
        float fx = ((float)x + 0.5f) * ((float)w / (float)size) - 0.5f;
        if (fx < 0) fx = 0;
        if (fx > (float)(w - 1)) fx = (float)(w - 1);
        int ix = (int)fx;
        if (ix > w - 2) ix = w > 1 ? w - 2 : 0;
        x0[x] = ix;
        wx[x] = w > 1 ? fx - (float)ix : 0.0f;
    }
    for (y = 0; y < size; y++) {
        float fy = ((float)y + 0.5f) * ((float)h / (float)size) - 0.5f;
        if (fy < 0) fy = 0;
        if (fy > (float)(h - 1)) fy = (float)(h - 1);
        int iy = (int)fy;
        if (iy > h - 2) iy = h > 1 ? h - 2 : 0;
        float vy = h > 1 ? fy - (float)iy : 0.0f;
        const unsigned char *r0 = src + (size_t)iy * w * 3;
        const unsigned char *r1 = src + (size_t)(h > 1 ? iy + 1 : iy) * w * 3;
        unsigned char *out = dst + (size_t)y * size * 3;
        for (x = 0; x < size; x++) {
            const unsigned char *a = r0 + (size_t)x0[x] * 3;
            const unsigned char *b = a + (w > 1 ? 3 : 0);
            const unsigned char *cta = r1 + (size_t)x0[x] * 3;
            const unsigned char *ctb = cta + (w > 1 ? 3 : 0);
            float u = wx[x];
            for (c = 0; c < 3; c++) {
                float top = (float)a[c] * (1.0f - u) + (float)b[c] * u;
                float bot = (float)cta[c] * (1.0f - u) + (float)ctb[c] * u;
                float v = top * (1.0f - vy) + bot * vy + 0.5f;
                out[x * 3 + c] = (unsigned char)(v < 0 ? 0 : v > 255 ? 255 : v);
            }
        }
    }
    free(x0);
    free(wx);
    return 0;
}

/* Decode + exact-size bilinear in one native call (GIL-free end to end
 * through ctypes): DCT-scaled decode near `size`, then resize. `scratch`
 * must hold the scaled decode (<= full-size w*h*3; use tfos_jpeg_info). */
int tfos_jpeg_decode_resized(const unsigned char *buf, size_t len, int size,
                             unsigned char *scratch, size_t scratch_cap,
                             unsigned char *dst) {
    int w = 0, h = 0;
    int rc = tfos_jpeg_decode(buf, len, size, scratch, scratch_cap, &w, &h);
    if (rc != 0) return rc;
    if (w == size && h == size) {
        memcpy(dst, scratch, (size_t)size * size * 3);
        return 0;
    }
    return tfos_resize_bilinear_rgb(scratch, h, w, dst, size);
}

/* Probe dimensions without decoding (for buffer sizing).  target_min
 * applies the same DCT-scale rule as tfos_jpeg_decode, so callers can
 * size the scratch buffer to the SCALED decode (as little as 1/64th
 * of full resolution) instead of the full image. */
int tfos_jpeg_info(const unsigned char *buf, size_t len, int target_min,
                   int *out_w, int *out_h) {
    struct jpeg_decompress_struct cinfo;
    struct tfos_jpeg_err err;

    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = tfos_jpeg_error_exit;
    err.mgr.output_message = tfos_jpeg_silence;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, (unsigned char *)buf, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.out_color_space = JCS_RGB;
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    if (target_min > 0) {
        unsigned d;
        unsigned minside = cinfo.image_width < cinfo.image_height
                               ? cinfo.image_width
                               : cinfo.image_height;
        for (d = 8; d > 1; d /= 2) {
            if (minside / d >= (unsigned)target_min) {
                cinfo.scale_denom = d;
                break;
            }
        }
    }
    jpeg_calc_output_dimensions(&cinfo);
    *out_w = (int)cinfo.output_width;
    *out_h = (int)cinfo.output_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}
