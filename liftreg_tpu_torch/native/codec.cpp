// Native in-RAM compression codec for dataset caching.
//
// The reference keeps its whole training set blosc-compressed in memory
// (dataset/Registration2D3DDataset.py:93-121). blosc is not a dependency of
// this project; this is a native equivalent: blosc-style byte shuffle
// (transpose the byte planes of each element so the slowly-varying
// exponent/sign bytes group together) followed by zlib deflate. Exposed via
// a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC codec.cpp -o libliftregcodec.so -lz
// (liftreg_tpu_torch/native/__init__.py builds it into build/ at first use)

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

void shuffle_bytes(const uint8_t* src, uint8_t* dst, size_t nelem,
                   size_t elem_size) {
  for (size_t b = 0; b < elem_size; ++b) {
    const uint8_t* in = src + b;
    uint8_t* out = dst + b * nelem;
    for (size_t i = 0; i < nelem; ++i) {
      out[i] = in[i * elem_size];
    }
  }
}

void unshuffle_bytes(const uint8_t* src, uint8_t* dst, size_t nelem,
                     size_t elem_size) {
  for (size_t b = 0; b < elem_size; ++b) {
    const uint8_t* in = src + b * nelem;
    uint8_t* out = dst + b;
    for (size_t i = 0; i < nelem; ++i) {
      out[i * elem_size] = in[i];
    }
  }
}

}  // namespace

extern "C" {

// Upper bound on compressed size for a given input size.
size_t lrc_max_compressed_size(size_t nbytes) {
  return compressBound(nbytes) + 16;
}

// Compress `nbytes` of data with element size `elem_size` (byte shuffle +
// deflate). Returns compressed size, or 0 on failure.
size_t lrc_compress(const uint8_t* data, size_t nbytes, size_t elem_size,
                    int level, uint8_t* out, size_t out_capacity) {
  if (elem_size == 0 || nbytes % elem_size != 0) return 0;
  std::vector<uint8_t> shuffled(nbytes);
  shuffle_bytes(data, shuffled.data(), nbytes / elem_size, elem_size);
  uLongf dst_len = out_capacity;
  int rc = compress2(out, &dst_len, shuffled.data(), nbytes, level);
  if (rc != Z_OK) return 0;
  return static_cast<size_t>(dst_len);
}

// Decompress into `out` (must hold exactly `nbytes`). Returns nbytes on
// success, 0 on failure.
size_t lrc_decompress(const uint8_t* comp, size_t comp_size, uint8_t* out,
                      size_t nbytes, size_t elem_size) {
  if (elem_size == 0 || nbytes % elem_size != 0) return 0;
  std::vector<uint8_t> shuffled(nbytes);
  uLongf dst_len = nbytes;
  int rc = uncompress(shuffled.data(), &dst_len, comp, comp_size);
  if (rc != Z_OK || dst_len != nbytes) return 0;
  unshuffle_bytes(shuffled.data(), out, nbytes / elem_size, elem_size);
  return nbytes;
}

}  // extern "C"
