// First-party JPEG decoder for the frame pipeline.
//
// The reference decodes every input frame through torchvision's libjpeg
// binding into CHW tensors (ref: dataset/frame.py:270-272). Here decode is a
// thin C++ layer over libjpeg(-turbo) that writes straight into
// caller-provided HWC uint8 buffers — the layout the TPU model consumes —
// so clips land in one contiguous (T, H, W, 3) allocation with zero Python
// per-frame overhead. Batch decode fans out over std::thread; every entry
// point is GIL-free (called via ctypes).
//
// Build: `make` in this directory (links -ljpeg, baked into the image).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file. Returns 0 on success. When out != nullptr it must
// hold exactly expect_h * expect_w * 3 bytes and the image must match; when
// out == nullptr only the header is parsed (probe mode).
int decode_file(const char* path, unsigned char* out, int expect_h,
                int expect_w, int* got_h, int* got_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;  // missing frame -> caller zero-pads

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -2;  // corrupt stream
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (out == nullptr) {
    if (got_h) *got_h = static_cast<int>(cinfo.image_height);
    if (got_w) *got_w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 0;
  }

  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != expect_h ||
      static_cast<int>(cinfo.output_width) != expect_w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -3;  // size mismatch
  }

  const int stride = expect_w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return 0;
}

}  // namespace

extern "C" {

// Parse a JPEG header: fills *h/*w. Returns 0 on success.
int tdeed_jpeg_probe(const char* path, int* h, int* w) {
  return decode_file(path, nullptr, 0, 0, h, w);
}

// Decode one file into out (h*w*3 bytes, RGB, HWC). Returns 0 on success.
int tdeed_jpeg_decode(const char* path, unsigned char* out, int h, int w) {
  return decode_file(path, out, h, w, nullptr, nullptr);
}

// Decode n files into a contiguous (n, h, w, 3) buffer using up to
// n_threads workers. paths[i] == nullptr or a missing/failed frame leaves
// its slot zeroed (the data layer's zero-pad contract,
// ref: dataset/frame.py:376-382). Returns the number of frames decoded.
int tdeed_jpeg_decode_batch(const char** paths, int n, unsigned char* out,
                            int h, int w, int n_threads) {
  const size_t frame_bytes = static_cast<size_t>(h) * w * 3;
  std::vector<int> ok(n, 0);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      unsigned char* dst = out + frame_bytes * i;
      if (paths[i] == nullptr ||
          decode_file(paths[i], dst, h, w, nullptr, nullptr) != 0) {
        std::memset(dst, 0, frame_bytes);
      } else {
        ok[i] = 1;
      }
    }
  };

  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& t : threads) t.join();
  }

  int total = 0;
  for (int i = 0; i < n; ++i) total += ok[i];
  return total;
}

}  // extern "C"
