// Native image decode op: JPEG/PNG/BMP bytes -> HWC uint8 BGR buffer.
//
// TPU-native equivalent of the reference's OpenCV JNI decode layer
// (reference: readers/src/main/scala/ImageReader.scala:45-63 `Imgcodecs.imdecode`,
// loaded through core/env/src/main/scala/NativeLoader.java). The reference
// decodes every image to 3-channel BGR CV_8U rows; this op keeps the exact
// same output convention so downstream byte-level semantics match.
//
// The port's own copy of mmlspark_tpu/ops/native/decode.cpp, built by
// mmlspark_tpu_torch/ops/native_build.py into build/torch_native/.
//
// C ABI (consumed via ctypes from mmlspark_tpu_torch/ops/decode.py):
//   int  mml_decode_image(const uint8_t* data, size_t len,
//                         int* h, int* w, int* c, uint8_t** out);
//       returns 0 on success (caller owns *out, free with mml_free),
//       nonzero on failure (corrupt/unsupported input -> row is dropped,
//       mirroring ImageReader.decode returning None).
//   void mml_free(uint8_t* p);
//   const char* mml_decoder_version();

#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- JPEG ----

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

int decode_jpeg(const uint8_t* data, size_t len, int* h, int* w, int* c,
                uint8_t** out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  uint8_t* buffer = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(buffer);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
#ifdef JCS_EXT_BGR
  cinfo.out_color_space = JCS_EXT_BGR;  // libjpeg-turbo: BGR directly
  const bool native_bgr = true;
#else
  cinfo.out_color_space = JCS_RGB;
  const bool native_bgr = false;
#endif
  jpeg_start_decompress(&cinfo);
  const int height = static_cast<int>(cinfo.output_height);
  const int width = static_cast<int>(cinfo.output_width);
  const int channels = static_cast<int>(cinfo.output_components);
  if (channels != 3 || height <= 0 || width <= 0) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  const size_t stride = static_cast<size_t>(width) * 3;
  buffer = static_cast<uint8_t*>(std::malloc(stride * height));
  if (!buffer) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buffer + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (!native_bgr) {  // RGB -> BGR swap in place
    for (size_t i = 0; i < stride * height; i += 3) {
      uint8_t t = buffer[i];
      buffer[i] = buffer[i + 2];
      buffer[i + 2] = t;
    }
  }
  *h = height;
  *w = width;
  *c = 3;
  *out = buffer;
  return 0;
}

// ----------------------------------------------------------------- PNG ----

int decode_png(const uint8_t* data, size_t len, int* h, int* w, int* c,
               uint8_t** out) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, len)) return 1;
  image.format = PNG_FORMAT_BGR;  // force 3-channel BGR like OpenCV
  const size_t stride = PNG_IMAGE_ROW_STRIDE(image);
  const size_t size = PNG_IMAGE_SIZE(image);
  uint8_t* buffer = static_cast<uint8_t*>(std::malloc(size));
  if (!buffer) {
    png_image_free(&image);
    return 1;
  }
  if (!png_image_finish_read(&image, nullptr, buffer,
                             static_cast<png_int_32>(stride), nullptr)) {
    png_image_free(&image);
    std::free(buffer);
    return 1;
  }
  *h = static_cast<int>(image.height);
  *w = static_cast<int>(image.width);
  *c = 3;
  *out = buffer;
  return 0;
}

// ----------------------------------------------------------------- BMP ----
// Minimal uncompressed 24/32-bit BMP support (BI_RGB), bottom-up or top-down.

uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

int decode_bmp(const uint8_t* data, size_t len, int* h, int* w, int* c,
               uint8_t** out) {
  if (len < 54) return 1;
  const uint32_t offset = rd32(data + 10);
  const int32_t width = static_cast<int32_t>(rd32(data + 18));
  int32_t height = static_cast<int32_t>(rd32(data + 22));
  const uint16_t bpp = static_cast<uint16_t>(data[28] | (data[29] << 8));
  const uint32_t compression = rd32(data + 30);
  const bool top_down = height < 0;
  if (top_down) height = -height;
  if (compression != 0 || (bpp != 24 && bpp != 32) || width <= 0 ||
      height <= 0 || width > 1 << 20 || height > 1 << 20)
    return 1;
  const size_t src_stride = ((static_cast<size_t>(width) * bpp / 8) + 3) & ~3u;
  if (offset + src_stride * height > len) return 1;
  const size_t dst_stride = static_cast<size_t>(width) * 3;
  uint8_t* buffer = static_cast<uint8_t*>(std::malloc(dst_stride * height));
  if (!buffer) return 1;
  const int step = bpp / 8;
  for (int y = 0; y < height; ++y) {
    const int src_y = top_down ? y : height - 1 - y;
    const uint8_t* src = data + offset + src_stride * src_y;
    uint8_t* dst = buffer + dst_stride * y;
    for (int x = 0; x < width; ++x) {
      dst[x * 3 + 0] = src[x * step + 0];  // BMP rows are already BGR
      dst[x * 3 + 1] = src[x * step + 1];
      dst[x * 3 + 2] = src[x * step + 2];
    }
  }
  *h = height;
  *w = width;
  *c = 3;
  *out = buffer;
  return 0;
}

}  // namespace

extern "C" {

int mml_decode_image(const uint8_t* data, size_t len, int* h, int* w, int* c,
                     uint8_t** out) {
  if (!data || len < 8 || !h || !w || !c || !out) return 1;
  if (data[0] == 0xFF && data[1] == 0xD8) return decode_jpeg(data, len, h, w, c, out);
  if (data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' && data[3] == 'G')
    return decode_png(data, len, h, w, c, out);
  if (data[0] == 'B' && data[1] == 'M') return decode_bmp(data, len, h, w, c, out);
  return 1;
}

void mml_free(uint8_t* p) { std::free(p); }

const char* mml_decoder_version() { return "mml-decode 1.0 (jpeg/png/bmp)"; }

}  // extern "C"
