/* Fast COLMAP points3D.bin decoder of nerf_fl_torch.
 *
 * The port's own copy of the repo's csrc/colmap_fast.c (the JAX package's),
 * byte for byte in its functions.  The pure-Python reader in
 * nerf_fl_torch/data/colmap.py is the reference; this library takes the
 * startup path's hot spot for a real reconstruction (points3D.bin carries
 * 1e5-1e7 records with variable-length tracks, which forces a per-record
 * loop).  Host C, not a device kernel: nerf_fl_torch/data/colmap_native.py
 * builds it with the C compiler at first use into nerf_fl_torch/_build/
 * and loads it through ctypes, and reads with the pure-Python reader where
 * no compiler is found.
 *
 * All readers assume little-endian layout (COLMAP's on-disk format) and are
 * bounds-checked: they return -1 on truncated input instead of reading OOB.
 */
#include <stdint.h>
#include <string.h>

static uint64_t rd_u64(const unsigned char *p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

/* Count points and validate the stream.  Returns number of points, or -1 on
 * corruption/truncation. */
long long colmap_points3d_count(const unsigned char *buf, long long len) {
    if (len < 8) return -1;
    uint64_t n = rd_u64(buf);
    long long off = 8;
    for (uint64_t i = 0; i < n; i++) {
        if (off + 51 > len) return -1;
        uint64_t tl = rd_u64(buf + off + 43);
        off += 51 + 8 * (long long)tl;
        if (off > len) return -1;
    }
    return (long long)n;
}

/* Decode xyz (n,3 doubles), rgb (n,3 uint8), error (n doubles), track
 * lengths (n int64).  Caller allocates from colmap_points3d_count.
 * Returns 0 on success. */
int colmap_points3d_decode(const unsigned char *buf, long long len,
                           long long n, int64_t *ids, double *xyz,
                           unsigned char *rgb, double *error,
                           int64_t *track_len) {
    long long off = 8;
    for (long long i = 0; i < n; i++) {
        if (off + 51 > len) return -1;
        memcpy(&ids[i], buf + off, 8);
        memcpy(&xyz[3 * i], buf + off + 8, 24);
        memcpy(&rgb[3 * i], buf + off + 32, 3);
        memcpy(&error[i], buf + off + 35, 8);
        uint64_t tl = rd_u64(buf + off + 43);
        track_len[i] = (int64_t)tl;
        off += 51 + 8 * (long long)tl;
        if (off > len) return -1;
    }
    return 0;
}

/* Decode the concatenated (image_id, point2D_idx) int32 track pairs into a
 * flat array of length 2*total_track_len.  Returns 0 on success. */
int colmap_points3d_tracks(const unsigned char *buf, long long len,
                           long long n, int32_t *tracks) {
    long long off = 8;
    long long t = 0;
    for (long long i = 0; i < n; i++) {
        if (off + 51 > len) return -1;
        uint64_t tl = rd_u64(buf + off + 43);
        off += 51;
        if (off + 8 * (long long)tl > len) return -1;
        memcpy(&tracks[t], buf + off, 8 * tl);
        t += 2 * (long long)tl;
        off += 8 * (long long)tl;
    }
    return 0;
}
