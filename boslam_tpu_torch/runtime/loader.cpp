// Native dataset runtime: PNG decode + multithreaded prefetch pipeline
// (a copy of boslam_tpu/runtime/loader.cpp).
//
// Decodes TUM RGBD frames (8-bit RGB PNG -> BT.601 grayscale float, 16-bit
// depth PNG -> metres float) off the critical path, with a worker pool and
// a bounded ring buffer, so the host loop does not wait on disk or zlib
// while the card tracks the previous frame.
//
// C ABI for ctypes.  Built by boslam_tpu_torch/runtime/native.py with make.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  long index = -1;
  bool ok = false;
  std::vector<float> gray;   // H*W, [0, 255]
  std::vector<float> depth;  // H*W, metres
};

bool decode_png(const char* path, int expect_w, int expect_h, bool is_depth,
                float depth_factor, std::vector<float>* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  if ((expect_w && (int)w != expect_w) || (expect_h && (int)h != expect_h)) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> raw(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = raw.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  out->resize((size_t)w * h);
  if (is_depth) {
    // TUM depth: 16-bit grayscale, big-endian in PNG, value/factor metres.
    if (bit_depth != 16 || channels != 1) return false;
    const float inv = 1.0f / depth_factor;
    for (size_t i = 0; i < (size_t)w * h; ++i) {
      uint16_t v = (uint16_t)((raw[2 * i] << 8) | raw[2 * i + 1]);
      (*out)[i] = v * inv;
    }
  } else if (channels >= 3) {
    for (size_t i = 0; i < (size_t)w * h; ++i) {
      const uint8_t* p = raw.data() + i * channels;
      (*out)[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
    }
  } else {
    for (size_t i = 0; i < (size_t)w * h; ++i) (*out)[i] = raw[i];
  }
  return true;
}

struct Loader {
  int width = 0, height = 0;
  float depth_factor = 5000.0f;
  std::vector<std::string> rgb_paths, depth_paths;
  size_t capacity = 8;

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<Frame> ready;     // decoded frames ordered by index
  std::atomic<long> next_to_decode{0};
  long next_to_emit = 0;
  bool stop = false;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      long idx = next_to_decode.fetch_add(1);
      if (idx >= (long)rgb_paths.size()) return;
      Frame f;
      f.index = idx;
      f.ok = decode_png(rgb_paths[idx].c_str(), width, height, false,
                        depth_factor, &f.gray) &&
             decode_png(depth_paths[idx].c_str(), width, height, true,
                        depth_factor, &f.depth);
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] {
        return stop || (long)ready.size() < (long)capacity ||
               idx == next_to_emit;
      });
      if (stop) return;
      // keep the deque sorted by index (workers may finish out of order)
      auto it = ready.begin();
      while (it != ready.end() && it->index < idx) ++it;
      ready.insert(it, std::move(f));
      cv_consume.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** rgb_paths, const char** depth_paths,
                    long n_frames, int width, int height, float depth_factor,
                    int n_threads, int capacity) {
  auto* L = new Loader();
  L->width = width;
  L->height = height;
  L->depth_factor = depth_factor;
  L->capacity = capacity > 0 ? capacity : 8;
  L->rgb_paths.assign(rgb_paths, rgb_paths + n_frames);
  L->depth_paths.assign(depth_paths, depth_paths + n_frames);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocks until frame `next_to_emit` is decoded; copies into caller buffers.
// Returns 1 on success, 0 on decode failure, -1 when the stream is done.
int loader_next(void* handle, float* gray_out, float* depth_out) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_emit >= (long)L->rgb_paths.size()) return -1;
  L->cv_consume.wait(lk, [&] {
    return !L->ready.empty() && L->ready.front().index == L->next_to_emit;
  });
  Frame f = std::move(L->ready.front());
  L->ready.pop_front();
  L->next_to_emit++;
  L->cv_produce.notify_all();
  lk.unlock();
  if (!f.ok) return 0;
  std::memcpy(gray_out, f.gray.data(), f.gray.size() * sizeof(float));
  std::memcpy(depth_out, f.depth.data(), f.depth.size() * sizeof(float));
  return 1;
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_produce.notify_all();
  L->next_to_decode.store((long)L->rgb_paths.size());
  for (auto& t : L->workers) t.join();
  delete L;
}

// One-shot decode helpers (no pipeline).
int decode_rgb_gray(const char* path, int w, int h, float* out) {
  std::vector<float> buf;
  if (!decode_png(path, w, h, false, 1.0f, &buf)) return 0;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 1;
}

int decode_depth(const char* path, int w, int h, float factor, float* out) {
  std::vector<float> buf;
  if (!decode_png(path, w, h, true, factor, &buf)) return 0;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 1;
}

}  // extern "C"
