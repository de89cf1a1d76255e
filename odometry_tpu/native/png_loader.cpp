// Native data-loading runtime: PNG decode + threaded stereo prefetcher.
//
// The reference's IO path is OpenCV imread on the main thread
// (run_odometry_kitti_offline.cpp:334-359), serializing decode with compute.
// Here decode runs in C++ worker threads that stay ahead of the device:
// python asks for frame pairs and receives float32 grayscale buffers that
// were inflated/unfiltered while the device was busy with the previous frame.
//
// Self-contained PNG support (zlib only): 8-bit greyscale (colour type 0),
// 8-bit RGB/RGBA (2, 6) with BT.601 grey conversion matching
// cv::IMREAD_GRAYSCALE, all five scanline filters, multi-IDAT, no interlace.
//
// Exposed as a plain C API consumed through ctypes (no pybind11 in the
// image); see odometry_tpu/data/native_loader.py.

#include <zlib.h>

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

struct Image {
  int width = 0;
  int height = 0;
  std::vector<float> gray;  // height * width
  bool ok = false;
  std::string error;
};

uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Image decode_png(const std::string& path) {
  Image img;
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    img.error = "open failed: " + path;
    return img;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (std::fread(buf.data(), 1, size, f) != size_t(size)) {
    std::fclose(f);
    img.error = "read failed";
    return img;
  }
  std::fclose(f);

  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || std::memcmp(buf.data(), kSig, 8) != 0) {
    img.error = "not a PNG";
    return img;
  }

  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 8 <= buf.size()) {
    uint32_t len = read_be32(&buf[pos]);
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (pos + 12 + len > buf.size()) break;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      width = read_be32(data);
      height = read_be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (width <= 0 || height <= 0) {
    img.error = "bad IHDR";
    return img;
  }
  if (bit_depth != 8 || interlace != 0 ||
      (color_type != 0 && color_type != 2 && color_type != 6)) {
    img.error = "unsupported PNG (need 8-bit gray/RGB/RGBA, no interlace)";
    return img;
  }
  int channels = color_type == 0 ? 1 : (color_type == 2 ? 3 : 4);
  size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw((stride + 1) * height);
  uLongf out_len = raw.size();
  if (uncompress(raw.data(), &out_len, idat.data(), idat.size()) != Z_OK ||
      out_len != raw.size()) {
    img.error = "inflate failed";
    return img;
  }

  // Unfilter in place into a contiguous pixel buffer.
  std::vector<uint8_t> px(stride * height);
  const int bpp = channels;
  for (int y = 0; y < height; y++) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &px[stride * y];
    const uint8_t* up = y > 0 ? &px[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default:
          img.error = "bad filter";
          return img;
      }
      dst[x] = uint8_t(v);
    }
  }

  img.width = width;
  img.height = height;
  img.gray.resize(size_t(width) * height);
  if (channels == 1) {
    for (size_t i = 0; i < img.gray.size(); i++) img.gray[i] = float(px[i]);
  } else {
    // BT.601 integer-rounded grey, matching OpenCV's IMREAD_GRAYSCALE.
    for (size_t i = 0; i < img.gray.size(); i++) {
      const uint8_t* p = &px[i * channels];
      int g = (299 * p[0] + 587 * p[1] + 114 * p[2] + 500) / 1000;
      img.gray[i] = float(g);
    }
  }
  img.ok = true;
  return img;
}

struct Pair {
  Image left, right;
  int index = -1;
};

struct Loader {
  std::vector<std::string> lefts, rights;
  int prefetch = 4;
  std::deque<Pair> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<int> next_decode{0};
  std::atomic<bool> stop{false};
  int next_serve = 0;
  std::vector<std::thread> workers;

  void worker() {
    while (!stop.load()) {
      int idx = next_decode.fetch_add(1);
      if (idx >= int(lefts.size())) return;
      Pair p;
      p.index = idx;
      p.left = decode_png(lefts[idx]);
      p.right = decode_png(rights[idx]);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || int(ready.size()) < prefetch + 4;
      });
      if (stop.load()) return;
      ready.push_back(std::move(p));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode one PNG to float32 grayscale. Returns 0 on success. Call with
// out=nullptr to query dimensions only.
int otpu_png_read_gray(const char* path, float* out, int* width, int* height) {
  Image img = decode_png(path);
  if (!img.ok) return 1;
  *width = img.width;
  *height = img.height;
  if (out) std::memcpy(out, img.gray.data(), img.gray.size() * sizeof(float));
  return 0;
}

void* otpu_loader_open(const char** left_paths, const char** right_paths, int n,
                       int prefetch, int num_threads) {
  auto* L = new Loader();
  for (int i = 0; i < n; i++) {
    L->lefts.emplace_back(left_paths[i]);
    L->rights.emplace_back(right_paths[i]);
  }
  L->prefetch = prefetch > 0 ? prefetch : 4;
  int nt = num_threads > 0 ? num_threads : 2;
  for (int t = 0; t < nt; t++) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocking next-pair fetch in submission order. Returns 0 on success,
// 1 at end of sequence, 2 on decode error.
int otpu_loader_next(void* handle, float* left_out, float* right_out) {
  auto* L = static_cast<Loader*>(handle);
  if (L->next_serve >= int(L->lefts.size())) return 1;
  std::unique_lock<std::mutex> lk(L->mu);
  int want = L->next_serve;
  L->cv_ready.wait(lk, [&] {
    for (auto& p : L->ready)
      if (p.index == want) return true;
    return false;
  });
  for (auto it = L->ready.begin(); it != L->ready.end(); ++it) {
    if (it->index == want) {
      Pair p = std::move(*it);
      L->ready.erase(it);
      L->cv_space.notify_all();
      lk.unlock();
      L->next_serve++;
      if (!p.left.ok || !p.right.ok) return 2;
      std::memcpy(left_out, p.left.gray.data(), p.left.gray.size() * sizeof(float));
      std::memcpy(right_out, p.right.gray.data(), p.right.gray.size() * sizeof(float));
      return 0;
    }
  }
  return 2;
}

void otpu_loader_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
