// Native host-IO runtime of the PyTorch port (runtime/hostio.py binds it).
//
// A copy of native/hostio.cpp, the JAX package's: the equivalent of the
// reference's C++ host plumbing
// (stereonet_infer/src/stereonet_node.cpp + preprocess.cpp CPU paths):
//   * a lock-free single-producer/single-consumer frame ring buffer
//     replacing the hbmem zero-copy image transport (stereonet_node.h:95-97)
//     between the capture thread and the device-feed thread;
//   * tight -O3 loops for the host-side byte work that must happen before
//     bytes can ship to the device: side-by-side NV12 split
//     (stereonet_node.cpp:705-738 semantics), BGR->NV12 packing
//     (preprocess.h:56-96), NV12->YUV444 upsample (preprocess.h:128-155).
//
// The device path does all of this on the card (ops/preprocess.py, the
// ingest kernel); these host versions exist for staging pipelines that
// overlap decode with device compute, and as an independent oracle for
// tests.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Frame ring buffer (SPSC, lock-free)
// ---------------------------------------------------------------------------

struct FrameRing {
  uint8_t* storage;          // capacity * frame_bytes
  double* timestamps;        // capacity
  int64_t* indices;          // capacity
  size_t frame_bytes;
  size_t capacity;
  std::atomic<uint64_t> head;  // next write slot (producer)
  std::atomic<uint64_t> tail;  // next read slot (consumer)
  std::atomic<uint64_t> dropped;
};

FrameRing* ring_create(size_t frame_bytes, size_t capacity) {
  auto* r = new FrameRing();
  r->storage = new uint8_t[frame_bytes * capacity];
  r->timestamps = new double[capacity];
  r->indices = new int64_t[capacity];
  r->frame_bytes = frame_bytes;
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  r->dropped.store(0);
  return r;
}

void ring_destroy(FrameRing* r) {
  if (!r) return;
  delete[] r->storage;
  delete[] r->timestamps;
  delete[] r->indices;
  delete r;
}

// Push a frame; returns 1 on success, 0 if full (frame dropped — the
// reference's drop-bad-frames policy, stereonet_node.cpp:682-690).
int ring_push(FrameRing* r, const uint8_t* data, double timestamp,
              int64_t index) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) {
    r->dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  const size_t slot = head % r->capacity;
  std::memcpy(r->storage + slot * r->frame_bytes, data, r->frame_bytes);
  r->timestamps[slot] = timestamp;
  r->indices[slot] = index;
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Pop into out; returns 1 on success, 0 if empty.
int ring_pop(FrameRing* r, uint8_t* out, double* timestamp, int64_t* index) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail == head) return 0;
  const size_t slot = tail % r->capacity;
  std::memcpy(out, r->storage + slot * r->frame_bytes, r->frame_bytes);
  *timestamp = r->timestamps[slot];
  *index = r->indices[slot];
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

size_t ring_size(const FrameRing* r) {
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

uint64_t ring_dropped(const FrameRing* r) {
  return r->dropped.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// NV12 byte work
// ---------------------------------------------------------------------------

// Split a side-by-side NV12 frame (height x full_width) into two
// half-width NV12 buffers.  Row-contiguous memcpys (the reference does
// per-row copies at stereonet_node.cpp:705-738; same data movement, no ROS).
void nv12_split_sbs(const uint8_t* sbs, uint8_t* left, uint8_t* right,
                    int height, int full_width) {
  const int half = full_width / 2;
  // Y plane.
  for (int r = 0; r < height; ++r) {
    std::memcpy(left + r * half, sbs + r * full_width, half);
    std::memcpy(right + r * half, sbs + r * full_width + half, half);
  }
  // Interleaved UV plane (height/2 rows of full_width bytes).
  const uint8_t* uv = sbs + height * full_width;
  uint8_t* luv = left + height * half;
  uint8_t* ruv = right + height * half;
  for (int r = 0; r < height / 2; ++r) {
    std::memcpy(luv + r * half, uv + r * full_width, half);
    std::memcpy(ruv + r * half, uv + r * full_width + half, half);
  }
}

// NV12 -> planar YUV444 (uint8), nearest-neighbor chroma upsample
// (preprocess.h:128-155 semantics).  out is HWC [height, width, 3].
void nv12_to_yuv444(const uint8_t* nv12, uint8_t* out, int height, int width) {
  const uint8_t* y = nv12;
  const uint8_t* uv = nv12 + height * width;
  for (int r = 0; r < height; ++r) {
    const uint8_t* uvrow = uv + (r / 2) * width;
    uint8_t* orow = out + r * width * 3;
    const uint8_t* yrow = y + r * width;
    for (int c = 0; c < width; ++c) {
      orow[c * 3 + 0] = yrow[c];
      orow[c * 3 + 1] = uvrow[(c / 2) * 2];
      orow[c * 3 + 2] = uvrow[(c / 2) * 2 + 1];
    }
  }
}

// BGR (HWC uint8) -> NV12, BT.601 full-range, 2x2 chroma average
// (preprocess.h:56-96 capability; float math matches ops/colorspace.py).
void bgr_to_nv12(const uint8_t* bgr, uint8_t* nv12, int height, int width) {
  uint8_t* yp = nv12;
  uint8_t* uvp = nv12 + height * width;
  std::vector<float> ubuf(static_cast<size_t>(height) * width);
  std::vector<float> vbuf(static_cast<size_t>(height) * width);
  for (int r = 0; r < height; ++r) {
    for (int c = 0; c < width; ++c) {
      const uint8_t* px = bgr + (r * width + c) * 3;
      const float b = px[0], g = px[1], rr = px[2];
      const float yv = 0.299f * rr + 0.587f * g + 0.114f * b;
      ubuf[r * width + c] = (b - yv) * 0.492f + 128.0f;
      vbuf[r * width + c] = (rr - yv) * 0.877f + 128.0f;
      float yr = yv + 0.5f;
      yp[r * width + c] =
          static_cast<uint8_t>(yr < 0 ? 0 : (yr > 255 ? 255 : yr));
    }
  }
  for (int r = 0; r < height / 2; ++r) {
    for (int c = 0; c < width / 2; ++c) {
      const int r0 = 2 * r, c0 = 2 * c;
      const float u =
          0.25f * (ubuf[r0 * width + c0] + ubuf[r0 * width + c0 + 1] +
                   ubuf[(r0 + 1) * width + c0] + ubuf[(r0 + 1) * width + c0 + 1]);
      const float v =
          0.25f * (vbuf[r0 * width + c0] + vbuf[r0 * width + c0 + 1] +
                   vbuf[(r0 + 1) * width + c0] + vbuf[(r0 + 1) * width + c0 + 1]);
      const float ur = u + 0.5f, vr = v + 0.5f;
      uvp[r * width + 2 * c] =
          static_cast<uint8_t>(ur < 0 ? 0 : (ur > 255 ? 255 : ur));
      uvp[r * width + 2 * c + 1] =
          static_cast<uint8_t>(vr < 0 ? 0 : (vr > 255 ? 255 : vr));
    }
  }
}

}  // extern "C"
