// Native host data path: TIFF decode + area resize + mask z-score.
//
// The reference delegates its host pipeline to MONAI DataLoader worker
// processes (Python); this framework's equivalent hot path is implemented
// natively and exposed through ctypes (pti_ldm_vae_tpu/native/__init__.py).
// Semantics are bit-compatible with the numpy implementations in
// data/transforms.py (area resize == adaptive average pooling via averaging
// matrices; mask statistics over non-zero pixels with an f64 accumulator,
// matching numpy's pairwise-sum accuracy closely enough for f32 outputs).
//
// Supported TIFF subset: little-endian classic TIFF, uncompressed, grayscale,
// one sample/pixel, 8/16-bit unsigned or 32-bit float, any strip layout.
// Anything else returns an error and the caller falls back to the Python
// reader.
//
// Build: pti_ldm_vae_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Reader {
  const uint8_t* data;
  size_t size;
  bool ok = true;

  uint16_t u16(size_t off) const { return off + 2 <= size ? (uint16_t)(data[off] | data[off + 1] << 8) : 0; }
  uint32_t u32(size_t off) const {
    return off + 4 <= size
               ? (uint32_t)(data[off] | data[off + 1] << 8 | data[off + 2] << 16 | (uint32_t)data[off + 3] << 24)
               : 0;
  }
};

struct TiffInfo {
  uint32_t width = 0, height = 0;
  uint16_t bits = 0, sample_format = 1, compression = 1, samples = 1;
  std::vector<uint32_t> strip_offsets, strip_counts;
  uint32_t rows_per_strip = 0xFFFFFFFFu;
};

// Returns 0 on success.
int parse_tiff(const Reader& r, TiffInfo* info) {
  if (r.size < 8 || r.data[0] != 'I' || r.data[1] != 'I' || r.u16(2) != 42) return 1;  // LE classic only
  uint32_t ifd = r.u32(4);
  if (ifd + 2 > r.size) return 2;
  uint16_t n_entries = r.u16(ifd);
  for (uint16_t i = 0; i < n_entries; ++i) {
    size_t e = ifd + 2 + 12u * i;
    if (e + 12 > r.size) return 3;
    uint16_t tag = r.u16(e), type = r.u16(e + 2);
    uint32_t count = r.u32(e + 4);
    uint32_t value_off = e + 8;  // inline when it fits
    auto scalar = [&](void) -> uint32_t {
      return type == 3 ? r.u16(value_off) : r.u32(value_off);
    };
    auto vec = [&](std::vector<uint32_t>* out) {
      size_t elem = (type == 3) ? 2 : 4;
      size_t bytes = (size_t)count * elem;
      size_t off = bytes <= 4 ? value_off : r.u32(value_off);
      out->resize(count);
      for (uint32_t k = 0; k < count; ++k)
        (*out)[k] = (type == 3) ? r.u16(off + 2 * k) : r.u32(off + 4 * k);
    };
    switch (tag) {
      case 256: info->width = scalar(); break;
      case 257: info->height = scalar(); break;
      case 258: info->bits = (uint16_t)scalar(); break;
      case 259: info->compression = (uint16_t)scalar(); break;
      case 273: vec(&info->strip_offsets); break;
      case 277: info->samples = (uint16_t)scalar(); break;
      case 278: info->rows_per_strip = scalar(); break;
      case 279: vec(&info->strip_counts); break;
      case 339: info->sample_format = (uint16_t)scalar(); break;
      default: break;
    }
  }
  if (info->width == 0 || info->height == 0 || info->strip_offsets.empty()) return 4;
  if (info->compression != 1 || info->samples != 1) return 5;  // uncompressed grayscale only
  bool f32 = info->bits == 32 && info->sample_format == 3;
  bool u8 = info->bits == 8 && info->sample_format == 1;
  bool u16b = info->bits == 16 && info->sample_format == 1;
  if (!f32 && !u8 && !u16b) return 6;
  return 0;
}

}  // namespace

extern "C" {

// Probe: fills height/width; returns 0 when decodable by this library.
int pti_tiff_probe(const uint8_t* buf, size_t size, uint32_t* height, uint32_t* width) {
  Reader r{buf, size};
  TiffInfo info;
  int rc = parse_tiff(r, &info);
  if (rc) return rc;
  *height = info.height;
  *width = info.width;
  return 0;
}

// Decode to float32 [height, width]; returns 0 on success.
int pti_tiff_decode_f32(const uint8_t* buf, size_t size, float* out, size_t out_elems) {
  Reader r{buf, size};
  TiffInfo info;
  int rc = parse_tiff(r, &info);
  if (rc) return rc;
  size_t total = (size_t)info.width * info.height;
  if (out_elems < total) return 7;
  size_t bytes_per = info.bits / 8;
  size_t written = 0;
  for (size_t s = 0; s < info.strip_offsets.size() && written < total; ++s) {
    size_t off = info.strip_offsets[s];
    size_t count = s < info.strip_counts.size() ? info.strip_counts[s]
                                                : (total - written) * bytes_per;
    if (off + count > size) return 8;
    size_t elems = count / bytes_per;
    if (written + elems > total) elems = total - written;
    const uint8_t* src = buf + off;
    if (info.bits == 32) {
      std::memcpy(out + written, src, elems * 4);
    } else if (info.bits == 16) {
      for (size_t k = 0; k < elems; ++k)
        out[written + k] = (float)(uint16_t)(src[2 * k] | src[2 * k + 1] << 8);
    } else {
      for (size_t k = 0; k < elems; ++k) out[written + k] = (float)src[k];
    }
    written += elems;
  }
  return written == total ? 0 : 9;
}

// Area resize (adaptive average pooling): in [h_in, w_in] -> out [h_out, w_out].
void pti_resize_area_f32(const float* in, int h_in, int w_in, float* out, int h_out,
                         int w_out) {
  std::vector<float> tmp((size_t)h_out * w_in);
  for (int i = 0; i < h_out; ++i) {
    int start = (int)(((int64_t)i * h_in) / h_out);
    int end = (int)(((int64_t)(i + 1) * h_in + h_out - 1) / h_out);
    float inv = 1.0f / (float)(end - start);
    float* row = &tmp[(size_t)i * w_in];
    for (int j = 0; j < w_in; ++j) {
      double acc = 0.0;
      for (int k = start; k < end; ++k) acc += in[(size_t)k * w_in + j];
      row[j] = (float)(acc * inv);
    }
  }
  for (int i = 0; i < h_out; ++i) {
    const float* row = &tmp[(size_t)i * w_in];
    for (int j = 0; j < w_out; ++j) {
      int start = (int)(((int64_t)j * w_in) / w_out);
      int end = (int)(((int64_t)(j + 1) * w_in + w_out - 1) / w_out);
      double acc = 0.0;
      for (int k = start; k < end; ++k) acc += row[k];
      out[(size_t)i * w_out + j] = (float)(acc / (double)(end - start));
    }
  }
}

// Mask-aware z-score in place: stats over non-zero pixels, background stays 0,
// std floor 1e-5 -> 1.0 (reference LocalNormalizeByMask semantics).
void pti_mask_zscore_f32(float* img, size_t n) {
  double sum = 0.0, sumsq = 0.0;
  size_t count = 0;
  for (size_t i = 0; i < n; ++i) {
    float v = img[i];
    if (v != 0.0f) {
      sum += v;
      sumsq += (double)v * v;
      ++count;
    }
  }
  if (count == 0) return;
  double mean = sum / (double)count;
  double var = sumsq / (double)count - mean * mean;
  if (var < 0) var = 0;
  double std = std::sqrt(var);
  if (std <= 1e-5) std = 1.0;
  float fmean = (float)mean, finv = (float)(1.0 / std);
  for (size_t i = 0; i < n; ++i) {
    float v = img[i];
    img[i] = (v != 0.0f) ? (v - fmean) * finv : 0.0f;
  }
}

// Fused: decode -> resize -> normalize. Returns 0 on success.
int pti_preprocess(const uint8_t* buf, size_t size, float* out, int h_out, int w_out) {
  uint32_t h_in, w_in;
  int rc = pti_tiff_probe(buf, size, &h_in, &w_in);
  if (rc) return rc;
  std::vector<float> decoded((size_t)h_in * w_in);
  rc = pti_tiff_decode_f32(buf, size, decoded.data(), decoded.size());
  if (rc) return rc;
  if ((int)h_in == h_out && (int)w_in == w_out) {
    std::memcpy(out, decoded.data(), decoded.size() * 4);
  } else {
    pti_resize_area_f32(decoded.data(), (int)h_in, (int)w_in, out, h_out, w_out);
  }
  pti_mask_zscore_f32(out, (size_t)h_out * w_out);
  return 0;
}

}  // extern "C"
