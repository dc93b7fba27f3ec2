// Native host-side input pipeline: JPEG decode + Lanczos-3 resize.
//
// The reference feeds its GPU from 12 forked Python workers doing PIL
// decode + 4x PIL resize per frame (reference: model_tool/loader.py:60-61,
// model_loader/kitti_mono.py:287-304). A current accelerator consumes
// images far faster than that, so the host path must scale with cores: this
// translation unit is called from Python loader threads through ctypes
// (which drops the GIL for the duration of the call), so decode+resize
// runs truly parallel across threads.
//
// decode path: system libjpeg. When the target is <= 1/2 the source in
// both axes we use libjpeg's DCT scaled decode (scale_num/8) to the
// smallest size still >= 2x the target — cuts IDCT work ~4x while
// keeping the Lanczos window well-sampled.
//
// resize: separable Lanczos-3 (the PIL LANCZOS / ANTIALIAS filter the
// reference relies on, kitti_mono.py:275), float accumulation,
// half-pixel centers, kernel support scaled by the downsampling factor
// (antialiasing) — matches PIL within fixed-point rounding (~1/255).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

inline double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  if (x == 0.0) return 1.0;
  const double pix = M_PI * x;
  return 3.0 * std::sin(pix) * std::sin(pix / 3.0) / (pix * pix);
}

// Precomputed sparse row-weights for one output axis.
struct Taps {
  std::vector<int> start;      // first source index per output index
  std::vector<int> count;      // taps per output index
  std::vector<float> weight;   // packed weights
  int max_count = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double support = 3.0 * std::max(scale, 1.0);
  t.start.resize(out_size);
  t.count.resize(out_size);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale - 0.5;
    int lo = static_cast<int>(std::floor(center - support + 0.5));
    int hi = static_cast<int>(std::floor(center + support + 0.5));
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    t.start[i] = lo;
    t.count[i] = hi - lo;
    t.max_count = std::max(t.max_count, hi - lo);
    double sum = 0.0;
    std::vector<double> w(hi - lo);
    for (int k = lo; k < hi; ++k) {
      w[k - lo] = lanczos3((k - center) / std::max(scale, 1.0));
      sum += w[k - lo];
    }
    for (double& v : w) t.weight.push_back(static_cast<float>(v / sum));
  }
  return t;
}

// Separable resize uint8 HWC -> uint8 HWC (C = 3), float accumulation.
void resize_lanczos(const uint8_t* src, int in_h, int in_w, uint8_t* dst,
                    int out_h, int out_w) {
  const Taps tx = make_taps(in_w, out_w);
  const Taps ty = make_taps(in_h, out_h);

  // horizontal pass: [in_h, out_w, 3] float
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    float* orow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    const float* wp = tx.weight.data();
    for (int x = 0; x < out_w; ++x) {
      float r = 0, g = 0, b = 0;
      const uint8_t* p = row + tx.start[x] * 3;
      for (int k = 0; k < tx.count[x]; ++k, p += 3) {
        const float w = wp[k];
        r += w * p[0];
        g += w * p[1];
        b += w * p[2];
      }
      wp += tx.count[x];
      orow[x * 3 + 0] = r;
      orow[x * 3 + 1] = g;
      orow[x * 3 + 2] = b;
    }
  }

  // vertical pass -> uint8
  const float* wp = ty.weight.data();
  for (int y = 0; y < out_h; ++y) {
    uint8_t* orow = dst + static_cast<size_t>(y) * out_w * 3;
    const int count = ty.count[y];
    const float* base = tmp.data() +
        static_cast<size_t>(ty.start[y]) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      float acc = 0;
      const float* p = base + x;
      for (int k = 0; k < count; ++k, p += static_cast<size_t>(out_w) * 3)
        acc += wp[k] * *p;
      orow[x] = static_cast<uint8_t>(
          std::min(255.0f, std::max(0.0f, acc + 0.5f)));
    }
    wp += count;
  }
}

}  // namespace

extern "C" {

// Decode a JPEG from memory and Lanczos-resize to (out_h, out_w) RGB.
// `flip` mirrors horizontally (training augmentation — done here so the
// Python layer never touches pixels). Returns 0 on success.
int mdt_decode_resize(const uint8_t* data, long size, int out_h, int out_w,
                      int flip, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  // Declared BEFORE setjmp: a longjmp from a libjpeg callback must not
  // jump over a live vector's construction (UB + leaks the decode buffer
  // on every corrupt JPEG); declared here it is destroyed normally when
  // the function returns through either path.
  std::vector<uint8_t> raw;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain downscale: smallest M/8 (M in 1..8) with size >= 2x target
  int num = 8;
  while (num > 1 &&
         (cinfo.image_width * (num - 1)) / 8 >= 2u * out_w &&
         (cinfo.image_height * (num - 1)) / 8 >= 2u * out_h) {
    --num;
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;

  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  raw.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = raw.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (w == out_w && h == out_h) {
    std::memcpy(out, raw.data(), raw.size());
  } else {
    resize_lanczos(raw.data(), h, w, out, out_h, out_w);
  }

  if (flip) {
    for (int y = 0; y < out_h; ++y) {
      uint8_t* row = out + static_cast<size_t>(y) * out_w * 3;
      for (int x = 0; x < out_w / 2; ++x) {
        for (int c = 0; c < 3; ++c)
          std::swap(row[x * 3 + c], row[(out_w - 1 - x) * 3 + c]);
      }
    }
  }
  return 0;
}

}  // extern "C"
