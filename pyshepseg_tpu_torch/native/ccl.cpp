// Native host loops for the order-dependent sequential parts of the port
// (counterpart: pyshepseg_tpu/native/ccl.cpp, whose functions are carried over unchanged):
//
// - flood_fill_clump: scan-order flood-fill connected-component labelling
//   with the reference's MAX_CLUMP_SIZE cap semantics (reference:
//   pyshepseg/shepseg.py:452-541). The cap's split geometry depends on the
//   flood fill's stack order, so it is inherently sequential.
//
// - subset_recode: first-encounter dense re-labelling used by
//   subset.subsetImage (reference: pyshepseg/subset.py:367-424). The new
//   ID of a segment is determined by which of its pixels is seen first in
//   global scan order across tiles — a strictly sequential dependence.
//
// - stitch_mapping: the tiled stitch's per-tile window count and
//   ascending owned-id assignment (reference: pyshepseg/tiling.py:
//   1231-1290); stitch_relabel: the same plus the full-tile gather.
//
// Exposed as a plain C ABI, built with g++ on first use and loaded with
// ctypes by pyshepseg_tpu_torch/native/__init__.py.

#include <cstdint>
#include <vector>

extern "C" {

// img: row-major (h, w) int32; out: zero-initialised row-major uint32.
// Returns the next unused clump id (ids assigned from clumpId upward in
// raster-scan seed order). maxClumpSize < 0 means uncapped.
uint32_t flood_fill_clump(const int32_t *img, int64_t h, int64_t w,
                          int32_t ignoreVal, int32_t fourConnected,
                          int64_t maxClumpSize, uint32_t *out,
                          uint32_t clumpId) {
    std::vector<int64_t> stack;
    stack.reserve(4096);
    const int64_t cap = maxClumpSize < 0 ? INT64_MAX : maxClumpSize;

    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            const int64_t p = y * w + x;
            if (img[p] == ignoreVal || out[p] != 0) {
                continue;
            }
            const int32_t val = img[p];
            int64_t clumpSize = 0;
            stack.clear();
            stack.push_back(p);
            out[p] = clumpId;
            while (!stack.empty() && clumpSize < cap) {
                const int64_t s = stack.back();
                stack.pop_back();
                const int64_t sy = s / w;
                const int64_t sx = s % w;
                const int64_t tlx = sx > 0 ? sx - 1 : 0;
                const int64_t tly = sy > 0 ? sy - 1 : 0;
                const int64_t brx = sx < w - 1 ? sx + 1 : w - 1;
                const int64_t bry = sy < h - 1 ? sy + 1 : h - 1;
                // neighbour visit order matches the reference's numba
                // loops (x outer, y inner) so the stack contents — and
                // with them the cap's split geometry — are identical
                for (int64_t cx = tlx; cx <= brx; ++cx) {
                    for (int64_t cy = tly; cy <= bry; ++cy) {
                        const bool connected =
                            !fourConnected || (cy == sy || cx == sx);
                        const int64_t q = cy * w + cx;
                        if (connected && img[q] != ignoreVal &&
                                out[q] == 0 && img[q] == val) {
                            out[q] = clumpId;
                            ++clumpSize;
                            stack.push_back(q);
                        }
                    }
                }
            }
            ++clumpId;
        }
    }
    return clumpId;
}

// tile: (n,) uint32 old segment ids in scan order; mask: optional (n,)
// uint8 (0 = drop pixel); lut: (maxOldId + 1,) uint32, 0 = unassigned,
// updated in place; hist: (capacity,) uint64 new-id pixel counts, updated
// in place; out: (n,) uint32. Returns the next unused new id.
uint32_t subset_recode(const uint32_t *tile, const uint8_t *mask, int64_t n,
                       uint32_t *lut, uint32_t nextId, uint64_t *hist,
                       uint32_t *out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t v = tile[i];
        if (v == 0 || (mask != nullptr && mask[i] == 0)) {
            out[i] = 0;
            continue;
        }
        uint32_t nid = lut[v];
        if (nid == 0) {
            nid = nextId++;
            lut[v] = nid;
        }
        out[i] = nid;
        ++hist[nid];
    }
    return nextId;
}

// Per-tile stitch relabel, without the full-tile gather:
//
//   tile     (h, w) uint32 row-major, per-tile segment ids;
//   window   [top:bottom, left:right) — the trimmed region this tile
//            contributes to the mosaic;
//   mapping  (map_len,) uint32, preloaded with the recode entries
//            (old id -> earlier tile's global id), 0 elsewhere;
//   recoded  (map_len,) uint8, 1 where mapping holds a recode entry;
//   cnt      (map_len,) uint32 zero-initialised; on return, the pixel
//            count of every old id inside the window (cnt[0] = nulls).
//
// Ids present in the window and not recoded get fresh sequential ids
// start_id+1, start_id+2, ... in ascending old-id order (the reference's
// iteration order), written into `mapping`. Returns the last id assigned
// (the new running maxSegId). The caller gathers `mapping[tile]` over
// only the regions it consumes.
uint32_t stitch_mapping(const uint32_t *tile, int64_t h, int64_t w,
                        int64_t top, int64_t bottom,
                        int64_t left, int64_t right,
                        uint32_t *mapping, const uint8_t *recoded,
                        int64_t map_len, uint32_t start_id,
                        uint32_t *cnt) {
    (void)h;
    for (int64_t y = top; y < bottom; ++y) {
        const uint32_t *rowp = tile + y * w;
        for (int64_t x = left; x < right; ++x) {
            ++cnt[rowp[x]];
        }
    }
    uint32_t cur = start_id;
    for (int64_t id = 1; id < map_len; ++id) {
        if (cnt[id] != 0 && !recoded[id]) {
            mapping[id] = ++cur;
        }
    }
    return cur;
}

// stitch_mapping followed by the full-tile gather out[i] = mapping[tile[i]]
// (absent and unrecoded -> 0 = SEGNULLVAL: the neighbouring tile owns it).
//   out      (h * w,) uint32.
uint32_t stitch_relabel(const uint32_t *tile, int64_t h, int64_t w,
                        int64_t top, int64_t bottom,
                        int64_t left, int64_t right,
                        uint32_t *mapping, const uint8_t *recoded,
                        int64_t map_len, uint32_t start_id,
                        uint32_t *cnt, uint32_t *out) {
    const uint32_t cur = stitch_mapping(tile, h, w, top, bottom, left,
                                        right, mapping, recoded, map_len,
                                        start_id, cnt);
    const int64_t n = h * w;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = mapping[tile[i]];
    }
    return cur;
}

}  // extern "C"
