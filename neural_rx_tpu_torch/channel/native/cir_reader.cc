// Native CIR dataset reader (.cirbin): mmap-backed zero-copy loader for
// ray-traced channel impulse response records. The PyTorch port's copy of
// neural_rx_tpu/channel/native/cir_reader.cc, built by
// neural_rx_tpu_torch/channel/io_native.py with g++ into _build/.
//
// Replaces the role of the reference's TFRecord ingestion
// (utils/channel_models.py:200-228: load the full dataset into memory
// before training). Exposed to Python via ctypes (no pybind11 in the
// image). Format:
//   magic "CIR1" | uint32 N, R, X, P
//   payload: a  [N, R, X, P] complex64 (float32 re/im interleaved)
//            tau[N, P] float32
// The arrays are mmap'd read-only; Python wraps the pointers with
// numpy.frombuffer so the OS page cache backs the dataset without a
// copy (large site-specific datasets stream from disk on first touch).

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  char magic[4];
  uint32_t n, r, x, p;
};

struct Handle {
  void* map = nullptr;
  size_t size = 0;
  Header hdr{};
  const float* a = nullptr;    // N*R*X*P*2 floats
  const float* tau = nullptr;  // N*P floats
};

}  // namespace

extern "C" {

// Returns nullptr on failure. Fills meta = {N, R, X, P}.
void* cir_open(const char* path, uint32_t* meta) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (long)sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return nullptr;

  auto* h = new Handle;
  h->map = map;
  h->size = st.st_size;
  std::memcpy(&h->hdr, map, sizeof(Header));
  if (std::memcmp(h->hdr.magic, "CIR1", 4) != 0) {
    ::munmap(map, st.st_size);
    delete h;
    return nullptr;
  }
  const size_t n = h->hdr.n, r = h->hdr.r, x = h->hdr.x, p = h->hdr.p;
  const size_t a_floats = n * r * x * p * 2;
  const size_t tau_floats = n * p;
  const size_t need =
      sizeof(Header) + (a_floats + tau_floats) * sizeof(float);
  if ((size_t)st.st_size < need) {
    ::munmap(map, st.st_size);
    delete h;
    return nullptr;
  }
  h->a = reinterpret_cast<const float*>(
      static_cast<const char*>(map) + sizeof(Header));
  h->tau = h->a + a_floats;
  meta[0] = h->hdr.n;
  meta[1] = h->hdr.r;
  meta[2] = h->hdr.x;
  meta[3] = h->hdr.p;
  return h;
}

const float* cir_a_ptr(void* handle) {
  return static_cast<Handle*>(handle)->a;
}

const float* cir_tau_ptr(void* handle) {
  return static_cast<Handle*>(handle)->tau;
}

void cir_close(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  if (h->map) ::munmap(h->map, h->size);
  delete h;
}

}  // extern "C"
