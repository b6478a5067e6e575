// JPEG decode and resize for the readers and the pack writer
// (data/native_io.py), linked against libjpeg.
//
// decode_jpeg decodes with libjpeg's ISLOW IDCT to RGB u8; asked for a
// target size it first takes the largest DCT downscale (1/2, 1/4, 1/8)
// that keeps both sides at or above the target. The resizes are bilinear
// at pixel centres (align-corners false): a plain stretch to (H, W), or
// with letterbox an aspect-preserving scale-to-fit padded at the bottom
// and right. A batch call decodes files with a thread pool straight into
// the collated uint8 [n, H, W, 3] buffer (the pack writer's) and pad-fills
// the slot of a file that does not read or decode, returning the number
// decoded.
//
// C ABI (ctypes):
//   nio_jpeg_size(buf, len, &h, &w) -> 0 ok
//   nio_decode_full_u8(buf, len, out, h, w) -> 0 ok   (h, w: the image's)
//   nio_decode_resize_f32(buf, len, out, H, W, pad_value, letterbox) -> 0 ok
//   nio_batch_decode_files_u8(paths, n, out, H, W, n_threads, pad, lb) -> #ok

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decodes a JPEG byte buffer to RGB u8. With target_h, target_w > 0 the
// DCT scale is the smallest that keeps both sides >= the target; with 0 the
// image decodes at full size.
bool decode_jpeg(const uint8_t* data, size_t len, int target_h, int target_w,
                 std::vector<uint8_t>* pixels, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  int num = 8;
  while (target_h > 0 && num > 1) {
    const int next = num / 2;
    if ((int)cinfo.image_height * next / 8 >= target_h &&
        (int)cinfo.image_width * next / 8 >= target_w) {
      num = next;
    } else {
      break;
    }
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  pixels->resize((size_t)h * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels->data() + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return true;
}

// One bilinear sample per output pixel; T is float or uint8_t (rounded and
// clamped). Pixels outside the letterboxed image take pad_value.
template <typename T>
void resize(const uint8_t* src, int sh, int sw, T* dst, int H, int W,
            float pad_value, int letterbox) {
  int rh = H, rw = W;
  if (letterbox) {
    const float scale = std::min((float)H / sh, (float)W / sw);
    rh = std::max(1, (int)std::round(sh * scale));
    rw = std::max(1, (int)std::round(sw * scale));
  }
  auto store = [](float v) -> T {
    if (sizeof(T) == 1) {
      return (T)std::max(0.0f, std::min(255.0f, std::round(v)));
    }
    return (T)v;
  };
  const T pad = store(pad_value);
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      T* px = dst + ((size_t)y * W + x) * 3;
      if (y >= rh || x >= rw) {
        px[0] = px[1] = px[2] = pad;
        continue;
      }
      float fy = ((y + 0.5f) / rh) * sh - 0.5f;
      float fx = ((x + 0.5f) / rw) * sw - 0.5f;
      fy = std::max(0.0f, std::min(fy, (float)sh - 1));
      fx = std::max(0.0f, std::min(fx, (float)sw - 1));
      const int y0 = (int)fy, x0 = (int)fx;
      const int y1 = std::min(y0 + 1, sh - 1), x1 = std::min(x0 + 1, sw - 1);
      const float wy = fy - y0, wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[((size_t)y0 * sw + x0) * 3 + c];
        const float v01 = src[((size_t)y0 * sw + x1) * 3 + c];
        const float v10 = src[((size_t)y1 * sw + x0) * 3 + c];
        const float v11 = src[((size_t)y1 * sw + x1) * 3 + c];
        px[c] = store((1 - wy) * ((1 - wx) * v00 + wx * v01) +
                      wy * ((1 - wx) * v10 + wx * v11));
      }
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  out->resize((size_t)n);
  const size_t got = std::fread(out->data(), 1, (size_t)n, f);
  std::fclose(f);
  return got == (size_t)n;
}

template <typename T>
int batch_decode(const char* const* paths, int n, T* out, int H, int W,
                 int n_threads, float pad_value, int letterbox) {
  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    std::vector<uint8_t> filebuf, pixels;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      T* dst = out + (size_t)i * H * W * 3;
      int sh = 0, sw = 0;
      if (read_file(paths[i], &filebuf) &&
          decode_jpeg(filebuf.data(), filebuf.size(), H, W, &pixels, &sh,
                      &sw)) {
        resize(pixels.data(), sh, sw, dst, H, W, pad_value, letterbox);
        ok.fetch_add(1);
      } else {
        float v = pad_value;
        if (sizeof(T) == 1) v = std::max(0.0f, std::min(255.0f, std::round(v)));
        std::fill(dst, dst + (size_t)H * W * 3, (T)v);
      }
    }
  };
  const int t = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

}  // namespace

extern "C" {

int nio_jpeg_size(const uint8_t* data, long len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (size_t)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = (int)cinfo.image_height;
  *w = (int)cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int nio_decode_full_u8(const uint8_t* data, long len, uint8_t* out, int h,
                       int w) {
  std::vector<uint8_t> pixels;
  int sh = 0, sw = 0;
  if (!decode_jpeg(data, (size_t)len, 0, 0, &pixels, &sh, &sw)) return -1;
  if (sh != h || sw != w) return -1;
  std::memcpy(out, pixels.data(), pixels.size());
  return 0;
}

int nio_decode_resize_f32(const uint8_t* data, long len, float* out, int H,
                          int W, float pad_value, int letterbox) {
  std::vector<uint8_t> pixels;
  int sh = 0, sw = 0;
  if (!decode_jpeg(data, (size_t)len, H, W, &pixels, &sh, &sw)) return -1;
  resize(pixels.data(), sh, sw, out, H, W, pad_value, letterbox);
  return 0;
}

int nio_batch_decode_files_u8(const char* const* paths, int n, uint8_t* out,
                              int H, int W, int n_threads, float pad_value,
                              int letterbox) {
  return batch_decode(paths, n, out, H, W, n_threads, pad_value, letterbox);
}

}  // extern "C"
