// Native tile decoder for the host input pipeline of crosstalk_tpu_torch
// (the port's own copy of crosstalk_tpu/native/tile_loader.cpp; the parser
// below is that file's, unchanged, so both accept and reject the same files).
//
// The reference decodes one TIFF per DataLoader __getitem__ in forked Python
// workers (reference train_model.py:159-177). Filling the packed tile cache
// for the card needs the host to decode thousands of tiles per second, so the
// hot path here is C++: a minimal baseline-TIFF parser (the dataset flavor:
// single-plane, uncompressed, little-endian float64/float32/uint16/uint8)
// plus a std::thread pool that decodes file pairs straight into the
// caller-provided packed (N, H, W, 2) float32 buffer.
//
// Exposed as a C ABI for ctypes. Python keeps the pure-Python decoder for
// exotic TIFFs (crosstalk_tpu_torch/data/tiff.py).
//
// Build (crosstalk_tpu_torch/data/native_loader.py does it at first use):
//   g++ -O3 -march=native -std=c++17 -shared -fPIC -o libtileloader.so tile_loader.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Tag {
  uint16_t id;
  uint16_t type;
  uint32_t count;
  uint32_t value_or_offset;
};

constexpr uint16_t kImageWidth = 256;
constexpr uint16_t kImageLength = 257;
constexpr uint16_t kBitsPerSample = 258;
constexpr uint16_t kCompression = 259;
constexpr uint16_t kStripOffsets = 273;
constexpr uint16_t kSamplesPerPixel = 277;
constexpr uint16_t kStripByteCounts = 279;
constexpr uint16_t kSampleFormat = 339;

inline uint16_t rd16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}
inline uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

int type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 12: return 8;
    default: return 0;
  }
}

// True when [off, off+len) lies inside buf — all math in 64-bit so
// corruption-controlled 32-bit offsets can't wrap past the check.
bool in_bounds(const std::vector<uint8_t>& buf, uint64_t off, uint64_t len) {
  return off <= buf.size() && len <= buf.size() - off;
}

// Read one tag value (first element) resolving the value/offset encoding.
uint32_t tag_value(const std::vector<uint8_t>& buf, const Tag& tag) {
  int size = type_size(tag.type);
  if (size == 0) return 0;
  if (static_cast<uint64_t>(size) * tag.count <= 4) {
    if (size == 2) return tag.value_or_offset & 0xffff;
    if (size == 1) return tag.value_or_offset & 0xff;
    return tag.value_or_offset;
  }
  if (!in_bounds(buf, tag.value_or_offset, size)) return 0;
  const uint8_t* p = buf.data() + tag.value_or_offset;
  if (size == 2) return rd16(p);
  return rd32(p);
}

// Convert raw pixel data to float32. Returns false on unsupported dtype.
bool convert(const uint8_t* src, uint32_t n, uint16_t fmt, uint16_t bits,
             float* dst) {
  // NOTE: strip data can start at ANY file offset, so src may be
  // misaligned for the element type. Per-element memcpy (not
  // reinterpret_cast + deref) keeps this well-defined: the -O3
  // -march=native build auto-vectorizes these loops, and a cast-based
  // loop lets the vectorizer assume natural alignment (its alignment
  // peeling then faults on a misaligned strip). memcpy compiles to
  // unaligned loads at the same speed.
  if (fmt == 3 && bits == 64) {
    for (uint32_t i = 0; i < n; ++i) {
      double v;
      std::memcpy(&v, src + 8 * static_cast<size_t>(i), 8);
      dst[i] = static_cast<float>(v);
    }
    return true;
  }
  if (fmt == 3 && bits == 32) {
    std::memcpy(dst, src, n * sizeof(float));
    return true;
  }
  if (fmt == 1 && bits == 16) {
    for (uint32_t i = 0; i < n; ++i) {
      uint16_t v;
      std::memcpy(&v, src + 2 * static_cast<size_t>(i), 2);
      dst[i] = static_cast<float>(v);
    }
    return true;
  }
  if (fmt == 1 && bits == 8) {
    for (uint32_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
    return true;
  }
  return false;
}

// Decode one baseline TIFF into dst (expected_h*expected_w floats, strided
// by `stride` between consecutive pixels, so channels can interleave).
// Both dims are checked — a transposed tile (e.g. 512x128 where 256x256 is
// expected) has the right pixel COUNT but would load spatially scrambled.
// Returns 0 on success, negative error codes otherwise.
int decode_tiff(const char* path, float* dst, int64_t stride,
                uint32_t expected_h, uint32_t expected_w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 8) { std::fclose(f); return -2; }
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return -3;
  }
  std::fclose(f);

  if (buf[0] != 'I' || buf[1] != 'I' || rd16(buf.data() + 2) != 42) return -4;
  uint32_t ifd = rd32(buf.data() + 4);
  if (!in_bounds(buf, ifd, 2)) return -5;
  uint16_t n_tags = rd16(buf.data() + ifd);
  // the whole tag table must fit (64-bit math: ifd near UINT32_MAX with a
  // large n_tags must not wrap past the check)
  if (!in_bounds(buf, static_cast<uint64_t>(ifd) + 2,
                 static_cast<uint64_t>(n_tags) * 12)) return -5;

  uint32_t width = 0, height = 0, bits = 1, compression = 1, spp = 1, fmt = 1;
  std::vector<uint32_t> strip_offsets, strip_counts;

  for (uint16_t i = 0; i < n_tags; ++i) {
    const uint8_t* p = buf.data() + ifd + 2 + 12 * i;
    Tag tag{rd16(p), rd16(p + 2), rd32(p + 4), rd32(p + 8)};
    switch (tag.id) {
      case kImageWidth: width = tag_value(buf, tag); break;
      case kImageLength: height = tag_value(buf, tag); break;
      case kBitsPerSample: bits = tag_value(buf, tag); break;
      case kCompression: compression = tag_value(buf, tag); break;
      case kSamplesPerPixel: spp = tag_value(buf, tag); break;
      case kSampleFormat: fmt = tag_value(buf, tag); break;
      case kStripOffsets:
      case kStripByteCounts: {
        int size = type_size(tag.type);
        if (size == 0 || (size != 2 && size != 4)) return -8;  // exotic type
        std::vector<uint32_t>& out =
            (tag.id == kStripOffsets) ? strip_offsets : strip_counts;
        if (static_cast<uint64_t>(size) * tag.count <= 4) {
          // Inline values: up to 4 bytes packed little-endian into the
          // value field. Push ALL tag.count elements (e.g. two SHORT
          // offsets), not just the first — otherwise a 2-strip file with
          // inline offsets would silently decode from strip 0 only.
          for (uint32_t k = 0; k < tag.count; ++k) {
            // size is 2 or 4 here (the type gate above rejects the rest)
            if (size == 2)
              out.push_back((tag.value_or_offset >> (16 * k)) & 0xffff);
            else
              out.push_back(tag.value_or_offset);
          }
        } else {
          if (!in_bounds(buf, tag.value_or_offset,
                         static_cast<uint64_t>(size) * tag.count))
            return -8;  // out-of-line array past EOF -> Python fallback
          const uint8_t* q = buf.data() + tag.value_or_offset;
          for (uint32_t k = 0; k < tag.count; ++k)
            out.push_back(size == 2 ? rd16(q + 2 * k) : rd32(q + 4 * k));
        }
        break;
      }
      default: break;
    }
  }

  if (compression != 1 || spp != 1) return -6;  // exotic -> Python fallback
  if (width != expected_w || height != expected_h) return -7;
  size_t elem = bits / 8;
  if (elem == 0) return -6;
  if (strip_counts.empty())
    strip_counts.push_back(static_cast<uint32_t>(width * height * elem));
  if (strip_offsets.empty() || strip_offsets.size() != strip_counts.size())
    return -8;  // malformed strip tags -> Python fallback
  uint64_t total = 0;
  for (uint32_t c : strip_counts) total += c;
  if (total != static_cast<uint64_t>(width) * height * elem) return -8;

  // gather strips (usually one) then convert — every offset+count check in
  // 64-bit so a uint32 wrap can't bypass it
  std::vector<uint8_t> linear;
  const uint8_t* src;
  if (strip_offsets.size() == 1) {
    if (!in_bounds(buf, strip_offsets[0], total)) return -9;
    src = buf.data() + strip_offsets[0];
  } else {
    linear.reserve(total);
    for (size_t k = 0; k < strip_offsets.size(); ++k) {
      if (!in_bounds(buf, strip_offsets[k], strip_counts[k])) return -9;
      linear.insert(linear.end(), buf.data() + strip_offsets[k],
                    buf.data() + strip_offsets[k] + strip_counts[k]);
    }
    src = linear.data();
  }

  if (stride == 1) {
    if (!convert(src, width * height, fmt, bits, dst)) return -10;
  } else {
    std::vector<float> tmp(width * height);
    if (!convert(src, width * height, fmt, bits, tmp.data())) return -10;
    for (uint32_t i = 0; i < width * height; ++i) dst[i * stride] = tmp[i];
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode `n` (mixed, source) tile pairs into out (n, height, width, 2)
// float32. paths: 2n C strings, [mixed_0, source_0, mixed_1, source_1, ...].
// Returns 0 if every decode succeeded; otherwise the first nonzero error
// code, with `first_failure` set to the failing path index.
int crosstalk_load_pairs(const char** paths, int64_t n, float* out,
                         int64_t height, int64_t width, int threads,
                         int64_t* first_failure) {
  const int64_t pixels = height * width;
  std::atomic<int64_t> next(0);
  std::atomic<int> status(0);
  std::atomic<int64_t> failed(-1);

  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= 2 * n || status.load() != 0) return;
      float* dst = out + (i / 2) * pixels * 2 + (i % 2);
      int rc = decode_tiff(paths[i], dst, 2, static_cast<uint32_t>(height),
                           static_cast<uint32_t>(width));
      if (rc != 0) {
        int expected = 0;
        if (status.compare_exchange_strong(expected, rc)) failed.store(i);
      }
    }
  };

  int n_threads = threads < 1 ? 1 : threads;
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  if (first_failure) *first_failure = failed.load();
  return status.load();
}

// Single-file decode into a dense float32 buffer (stride 1).
int crosstalk_load_tile(const char* path, float* out, int64_t height,
                        int64_t width) {
  return decode_tiff(path, out, 1, static_cast<uint32_t>(height),
                     static_cast<uint32_t>(width));
}

}  // extern "C"
