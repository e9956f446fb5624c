// husky_native — the framework's native host runtime.
//
// The reference relies on native code for everything off the GPU hot path:
// OpenCV's C++ distance transform (MPPI_isaac.py:374), PIL's C bicubic
// resize inside a dedicated worker process
// (high_resolution_DEM_workers.py:107-196), zfpy's C compression of rock
// blocks (large_scale_terrain/utils.py:33-81), and a multiprocessing worker
// pool with shortest-queue load balancing
// (high_resolution_DEM_workers.py:199-766). This translation unit provides
// this framework's equivalents as a single C-ABI shared library consumed
// via ctypes:
//
//   * hn_edt_l2         — exact L2 EDT (Felzenszwalb-Huttenlocher lower
//                         envelope), the host oracle for ops/edt.py.
//   * hn_chamfer5       — cv2-compatible 5x5 chamfer DT (fixture parity).
//   * hn_bicubic_upsample — Catmull-Rom (a=-0.5) integer-factor upsample,
//                         PIL half-pixel convention, clamped edges.
//   * hn_compress_f32 / hn_decompress_f32 — fixed-accuracy float codec
//                         (quantize to tolerance, delta + zigzag + varint),
//                         the zfpy stand-in for block databases.
//   * hn_pool_*         — a C++ thread-pool tile runner with per-worker
//                         queues and shortest-queue dispatch, poison-pill
//                         shutdown, and a completion queue — the native
//                         re-design of BaseWorkerManager/ThreadMonitor.
//
// Everything device-side stays in JAX/XLA/Pallas; this library is the host
// runtime around it (IO, prefetch, compression, oracles).

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Exact L2 EDT (Felzenszwalb & Huttenlocher, "Distance Transforms of Sampled
// Functions"). Input: uint8 occupancy (nonzero = obstacle). Output: float32
// Euclidean distance in pixels to the nearest obstacle.
// ---------------------------------------------------------------------------

static void dt1d(const float* f, int n, float* d, int* v, float* z) {
  constexpr float kInf = std::numeric_limits<float>::infinity();
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    float s;
    for (;;) {
      const float fq = f[q] + static_cast<float>(q) * q;
      const int vk = v[k];
      const float fv = f[vk] + static_cast<float>(vk) * vk;
      s = (fq - fv) / (2.0f * (q - vk));
      if (s <= z[k] && k > 0) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < static_cast<float>(q)) ++k;
    const float dq = static_cast<float>(q - v[k]);
    d[q] = dq * dq + f[v[k]];
  }
}

void hn_edt_l2_sq(const uint8_t* occ, int h, int w, float* out) {
  constexpr float kInf = 1e20f;
  const int n = h > w ? h : w;
  std::vector<float> col(n), dcol(n), z(n + 1);
  std::vector<int> v(n);
  // pass 1: columns (distance along rows of each column)
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) col[y] = occ[y * w + x] ? 0.0f : kInf;
    dt1d(col.data(), h, dcol.data(), v.data(), z.data());
    for (int y = 0; y < h; ++y) out[y * w + x] = dcol[y];
  }
  // pass 2: rows
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) col[x] = out[y * w + x];
    dt1d(col.data(), w, dcol.data(), v.data(), z.data());
    for (int x = 0; x < w; ++x) out[y * w + x] = dcol[x];
  }
}

void hn_edt_l2(const uint8_t* occ, int h, int w, float* out) {
  hn_edt_l2_sq(occ, h, w, out);
  const long n = static_cast<long>(h) * w;
  for (long i = 0; i < n; ++i) out[i] = std::sqrt(out[i]);
}

// ---------------------------------------------------------------------------
// cv2-compatible 5x5 chamfer distance transform
// (cv2.distanceTransform(img, DIST_L2, 5) weights a=1.0, b=1.4,
// c=2.1969 — OpenCV's 5x5 DIST_L2 mask; the 0.955/1.3693 pair belongs to
// the 3x3 mask). Input: uint8 image, 0 = obstacle, nonzero = free.
// ---------------------------------------------------------------------------

void hn_chamfer5(const uint8_t* free_img, int h, int w, float* out) {
  constexpr float kBig = 1e9f;
  const float a = 1.0f, b = 1.4f, c = 2.1969f;
  const int pad = 2;
  const int H = h + 2 * pad, W = w + 2 * pad;
  std::vector<float> d(static_cast<size_t>(H) * W, kBig);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      d[(y + pad) * W + (x + pad)] = free_img[y * w + x] ? kBig : 0.0f;

  struct Off { int dy, dx; float w; };
  const Off fwd[8] = {{-1, -1, b}, {-1, 0, a}, {-1, 1, b}, {0, -1, a},
                      {-2, -1, c}, {-2, 1, c}, {-1, -2, c}, {-1, 2, c}};
  for (int y = pad; y < h + pad; ++y) {
    for (int x = pad; x < w + pad; ++x) {
      float vmin = d[y * W + x];
      for (const auto& o : fwd) {
        const float cand = d[(y + o.dy) * W + (x + o.dx)] + o.w;
        if (cand < vmin) vmin = cand;
      }
      d[y * W + x] = vmin;
    }
  }
  for (int y = h + pad - 1; y >= pad; --y) {
    for (int x = w + pad - 1; x >= pad; --x) {
      float vmin = d[y * W + x];
      for (const auto& o : fwd) {
        const float cand = d[(y - o.dy) * W + (x - o.dx)] + o.w;
        if (cand < vmin) vmin = cand;
      }
      d[y * W + x] = vmin;
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      out[y * w + x] = d[(y + pad) * W + (x + pad)];
}

// ---------------------------------------------------------------------------
// Catmull-Rom (a = -0.5) separable bicubic upsample by an integer factor,
// matching terrain/upsample.py: output pixel o samples (o + 0.5)/f - 0.5,
// edges clamp, per-row kernels normalized to sum 1.
// ---------------------------------------------------------------------------

static inline float cubic_weight(float t) {
  const float a = -0.5f;
  t = std::fabs(t);
  if (t <= 1.0f) return ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
  if (t < 2.0f) return (((t - 5.0f) * t + 8.0f) * t - 4.0f) * a;
  return 0.0f;
}

// Per output index along one axis: 4 clamped source taps + normalized weights.
static void axis_taps(int n, int factor, std::vector<int>& idx,
                      std::vector<float>& wgt) {
  const int out_n = n * factor;
  idx.resize(static_cast<size_t>(out_n) * 4);
  wgt.resize(static_cast<size_t>(out_n) * 4);
  for (int o = 0; o < out_n; ++o) {
    const float src = (o + 0.5f) / factor - 0.5f;
    const int i0 = static_cast<int>(std::floor(src));
    const float frac = src - i0;
    float sum = 0.0f;
    for (int k = 0; k < 4; ++k) {
      const float t = (k - 1) - frac;
      wgt[o * 4 + k] = cubic_weight(t);
      sum += wgt[o * 4 + k];
      int i = i0 + (k - 1);
      if (i < 0) i = 0;
      if (i > n - 1) i = n - 1;
      idx[o * 4 + k] = i;
    }
    for (int k = 0; k < 4; ++k) wgt[o * 4 + k] /= sum;
  }
}

void hn_bicubic_upsample(const float* src, int h, int w, int factor,
                         float* dst) {
  const int oh = h * factor, ow = w * factor;
  std::vector<int> ridx, cidx;
  std::vector<float> rwgt, cwgt;
  axis_taps(h, factor, ridx, rwgt);
  axis_taps(w, factor, cidx, cwgt);
  // pass 1: rows (upsample the leading axis) -> tmp (oh, w)
  std::vector<float> tmp(static_cast<size_t>(oh) * w);
  for (int o = 0; o < oh; ++o) {
    const int* ip = &ridx[o * 4];
    const float* wp = &rwgt[o * 4];
    float* trow = &tmp[static_cast<size_t>(o) * w];
    const float* r0 = &src[static_cast<size_t>(ip[0]) * w];
    const float* r1 = &src[static_cast<size_t>(ip[1]) * w];
    const float* r2 = &src[static_cast<size_t>(ip[2]) * w];
    const float* r3 = &src[static_cast<size_t>(ip[3]) * w];
    for (int x = 0; x < w; ++x)
      trow[x] = wp[0] * r0[x] + wp[1] * r1[x] + wp[2] * r2[x] + wp[3] * r3[x];
  }
  // pass 2: columns -> dst (oh, ow)
  for (int y = 0; y < oh; ++y) {
    const float* trow = &tmp[static_cast<size_t>(y) * w];
    float* drow = &dst[static_cast<size_t>(y) * ow];
    for (int o = 0; o < ow; ++o) {
      const int* ip = &cidx[o * 4];
      const float* wp = &cwgt[o * 4];
      drow[o] = wp[0] * trow[ip[0]] + wp[1] * trow[ip[1]] +
                wp[2] * trow[ip[2]] + wp[3] * trow[ip[3]];
    }
  }
}

// ---------------------------------------------------------------------------
// Fixed-accuracy float codec (the zfpy stand-in for block databases,
// utils.py:33-81). Quantize to multiples of `tol`, delta-encode in raster
// order, zigzag, LEB128 varint. Exact to <= tol/2 per element; terrain and
// rock fields are smooth, so deltas are tiny and the stream compresses well.
// ---------------------------------------------------------------------------

long hn_compress_f32(const float* src, long n, float tol, uint8_t* dst,
                     long cap) {
  if (tol <= 0.0f) return -1;
  long pos = 0;
  int64_t prev = 0;
  const double tol_d = static_cast<double>(tol);
  for (long i = 0; i < n; ++i) {
    const int64_t q =
        static_cast<int64_t>(std::llround(static_cast<double>(src[i]) / tol_d));
    int64_t delta = q - prev;
    prev = q;
    uint64_t u = (static_cast<uint64_t>(delta) << 1) ^
                 static_cast<uint64_t>(delta >> 63);
    do {
      if (pos >= cap) return -1;
      uint8_t byte = u & 0x7F;
      u >>= 7;
      if (u) byte |= 0x80;
      dst[pos++] = byte;
    } while (u);
  }
  return pos;
}

long hn_decompress_f32(const uint8_t* src, long nbytes, float tol, float* dst,
                       long cap) {
  long pos = 0, out = 0;
  int64_t prev = 0;
  while (pos < nbytes) {
    uint64_t u = 0;
    int shift = 0;
    for (;;) {
      if (pos >= nbytes || shift > 63) return -1;
      const uint8_t byte = src[pos++];
      u |= static_cast<uint64_t>(byte & 0x7F) << shift;
      if (!(byte & 0x80)) break;
      shift += 7;
    }
    const int64_t delta =
        static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
    prev += delta;
    if (out >= cap) return -1;
    dst[out++] =
        static_cast<float>(static_cast<double>(prev) * static_cast<double>(tol));
  }
  return out;
}

// ---------------------------------------------------------------------------
// Thread-pool tile runner. Per-worker job deques with shortest-queue
// dispatch (the reference's load balancer,
// high_resolution_DEM_workers.py:454-466), poison-pill shutdown
// (:270-289), and a single completion queue the host thread drains — the
// collect_terrain_data() pattern (high_resolution_DEM_generator.py:786-826).
//
// Job kinds: 0 = bicubic upsample (p0 = factor), 1 = exact EDT (input
// float, occupancy = v > 0.5), 2 = chamfer5 (input float, free = v > 0.5).
// ---------------------------------------------------------------------------

namespace {

struct Job {
  long id = 0;
  int kind = 0;  // -1 = poison pill
  int h = 0, w = 0, p0 = 1;
  std::vector<float> in;
  std::vector<float> out;
};

struct Worker {
  std::deque<Job> queue;
  std::mutex m;
  std::condition_variable cv;
  std::thread thread;
  size_t depth() {
    std::lock_guard<std::mutex> lk(m);
    return queue.size();
  }
};

struct Pool {
  std::vector<std::unique_ptr<Worker>> workers;
  std::mutex done_m;
  std::condition_variable done_cv;
  std::deque<Job> done;
  std::atomic<long> next_id{1};
  std::atomic<long> pending{0};
};

void run_job(Job& job) {
  switch (job.kind) {
    case 0: {  // bicubic
      job.out.resize(static_cast<size_t>(job.h) * job.w * job.p0 * job.p0);
      hn_bicubic_upsample(job.in.data(), job.h, job.w, job.p0,
                          job.out.data());
      break;
    }
    case 1: {  // exact EDT
      std::vector<uint8_t> occ(static_cast<size_t>(job.h) * job.w);
      for (size_t i = 0; i < occ.size(); ++i) occ[i] = job.in[i] > 0.5f;
      job.out.resize(occ.size());
      hn_edt_l2(occ.data(), job.h, job.w, job.out.data());
      break;
    }
    case 2: {  // chamfer5
      std::vector<uint8_t> img(static_cast<size_t>(job.h) * job.w);
      for (size_t i = 0; i < img.size(); ++i) img[i] = job.in[i] > 0.5f;
      job.out.resize(img.size());
      hn_chamfer5(img.data(), job.h, job.w, job.out.data());
      break;
    }
    default:
      break;
  }
  job.in.clear();
  job.in.shrink_to_fit();
}

void worker_main(Pool* pool, Worker* self) {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(self->m);
      self->cv.wait(lk, [&] { return !self->queue.empty(); });
      job = std::move(self->queue.front());
      self->queue.pop_front();
    }
    if (job.kind < 0) return;  // poison pill
    run_job(job);
    {
      std::lock_guard<std::mutex> lk(pool->done_m);
      pool->done.push_back(std::move(job));
    }
    pool->done_cv.notify_all();
  }
}

}  // namespace

void* hn_pool_create(int n_workers) {
  if (n_workers < 1) n_workers = 1;
  auto* pool = new Pool();
  for (int i = 0; i < n_workers; ++i) {
    auto worker = std::make_unique<Worker>();
    worker->thread = std::thread(worker_main, pool, worker.get());
    pool->workers.push_back(std::move(worker));
  }
  return pool;
}

long hn_pool_submit(void* handle, int kind, const float* src, int h, int w,
                    int p0) {
  auto* pool = static_cast<Pool*>(handle);
  Job job;
  job.id = pool->next_id.fetch_add(1);
  job.kind = kind;
  job.h = h;
  job.w = w;
  job.p0 = p0;
  job.in.assign(src, src + static_cast<size_t>(h) * w);
  // shortest-queue dispatch
  Worker* target = pool->workers[0].get();
  size_t best = target->depth();
  for (auto& w_ptr : pool->workers) {
    const size_t d = w_ptr->depth();
    if (d < best) {
      best = d;
      target = w_ptr.get();
    }
  }
  pool->pending.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(target->m);
    target->queue.push_back(std::move(job));
  }
  target->cv.notify_one();
  return job.id;
}

long hn_pool_pending(void* handle) {
  return static_cast<Pool*>(handle)->pending.load();
}

// Peek the next finished job's (id, h, w, out_size); wait up to wait_ms.
// Returns 1 when a job is ready, 0 on timeout.
int hn_pool_peek(void* handle, long* id, int* h, int* w, long* out_size,
                 int wait_ms) {
  auto* pool = static_cast<Pool*>(handle);
  std::unique_lock<std::mutex> lk(pool->done_m);
  if (pool->done.empty()) {
    if (wait_ms <= 0) return 0;
    pool->done_cv.wait_for(lk, std::chrono::milliseconds(wait_ms),
                           [&] { return !pool->done.empty(); });
    if (pool->done.empty()) return 0;
  }
  const Job& job = pool->done.front();
  *id = job.id;
  *h = job.h;
  *w = job.w;
  *out_size = static_cast<long>(job.out.size());
  return 1;
}

// Pop the job peeked above into dst. Returns copied element count, -1 if
// nothing ready or dst too small.
long hn_pool_fetch(void* handle, float* dst, long cap) {
  auto* pool = static_cast<Pool*>(handle);
  Job job;
  {
    std::lock_guard<std::mutex> lk(pool->done_m);
    if (pool->done.empty()) return -1;
    if (static_cast<long>(pool->done.front().out.size()) > cap) return -1;
    job = std::move(pool->done.front());
    pool->done.pop_front();
  }
  std::memcpy(dst, job.out.data(), job.out.size() * sizeof(float));
  pool->pending.fetch_sub(1);
  return static_cast<long>(job.out.size());
}

void hn_pool_destroy(void* handle) {
  auto* pool = static_cast<Pool*>(handle);
  for (auto& worker : pool->workers) {
    Job pill;
    pill.kind = -1;
    {
      std::lock_guard<std::mutex> lk(worker->m);
      worker->queue.push_back(std::move(pill));
    }
    worker->cv.notify_one();
  }
  for (auto& worker : pool->workers) worker->thread.join();
  delete pool;
}

}  // extern "C"
