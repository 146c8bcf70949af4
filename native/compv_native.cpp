// compv_tpu native runtime: aligned memory pool + prefetching frame loader.
//
// Host-side analogue of the reference's C++ runtime layer:
//   * CompVMem aligned alloc / pool reuse  (base/compv_mem.cxx,
//     base/include/compv/base/compv_mem.h:36-91)
//   * capture/IO threads feeding the pipeline (camera plugins,
//     core/video/compv_core_video_reader_ffmpeg.cxx)
// The compute path stays in XLA; this library feeds it: double-buffered
// background reads of raw frame files into page-aligned host buffers that
// jax.device_put can DMA from without an extra copy.
//
// C ABI only (consumed via ctypes).

#if defined(__linux__)
#include <pthread.h>
#include <sched.h>
#endif

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ------------------------------------------------------------ aligned pool

struct PoolBlock {
  void* ptr;
  size_t size;
  int in_use;
};

struct AlignedPool {
  std::vector<PoolBlock> blocks;
  std::mutex mu;
  size_t alignment;
  std::atomic<uint64_t> hits{0}, misses{0};
};

void* compv_pool_create(size_t alignment) {
  auto* p = new AlignedPool();
  p->alignment = alignment < 64 ? 64 : alignment;
  return p;
}

void* compv_pool_alloc(void* pool, size_t size) {
  auto* p = static_cast<AlignedPool*>(pool);
  std::lock_guard<std::mutex> lock(p->mu);
  for (auto& b : p->blocks) {
    if (!b.in_use && b.size >= size && b.size <= size * 2) {
      b.in_use = 1;
      p->hits++;
      return b.ptr;
    }
  }
  p->misses++;
  void* ptr = nullptr;
  if (posix_memalign(&ptr, p->alignment, size) != 0) return nullptr;
  p->blocks.push_back({ptr, size, 1});
  return ptr;
}

void compv_pool_release(void* pool, void* ptr) {
  auto* p = static_cast<AlignedPool*>(pool);
  std::lock_guard<std::mutex> lock(p->mu);
  for (auto& b : p->blocks) {
    if (b.ptr == ptr) {
      b.in_use = 0;
      return;
    }
  }
}

uint64_t compv_pool_stats(void* pool, int which) {
  auto* p = static_cast<AlignedPool*>(pool);
  if (which == 0) return p->hits.load();
  if (which == 1) return p->misses.load();
  std::lock_guard<std::mutex> lock(p->mu);
  if (which == 2) return p->blocks.size();
  uint64_t bytes = 0;
  for (auto& b : p->blocks) bytes += b.size;
  return bytes;
}

void compv_pool_destroy(void* pool) {
  auto* p = static_cast<AlignedPool*>(pool);
  for (auto& b : p->blocks) free(b.ptr);
  delete p;
}

// ----------------------------------------------------- prefetch frame loader

struct FrameLoader {
  FILE* f = nullptr;
  size_t frame_bytes = 0;
  long n_frames = 0;
  long next_read = 0;
  int depth = 0;
  bool loop = false;
  // ring of prefetched frames
  std::vector<uint8_t*> ring;
  std::vector<long> ring_frame;     // which frame index each slot holds (-1 empty)
  int head = 0, tail = 0, count = 0;
  std::mutex mu;
  std::condition_variable cv_can_read, cv_can_take;
  std::thread worker;
  std::atomic<bool> stop{false};
};

static void loader_worker(FrameLoader* L) {
  for (;;) {
    std::unique_lock<std::mutex> lock(L->mu);
    L->cv_can_read.wait(lock, [&] { return L->stop || L->count < L->depth; });
    if (L->stop) return;
    long frame = L->next_read;
    if (frame >= L->n_frames) {
      if (!L->loop) {
        // park until stopped
        L->cv_can_read.wait(lock, [&] { return (bool)L->stop; });
        return;
      }
      frame = 0;
      L->next_read = 0;
    }
    int slot = L->head;
    lock.unlock();
    // read outside the lock
    fseek(L->f, (long)(frame * L->frame_bytes), SEEK_SET);
    size_t got = fread(L->ring[slot], 1, L->frame_bytes, L->f);
    (void)got;
    lock.lock();
    L->ring_frame[slot] = frame;
    L->head = (L->head + 1) % L->depth;
    L->count++;
    L->next_read = frame + 1;
    lock.unlock();
    L->cv_can_take.notify_one();
  }
}

void* compv_loader_open(const char* path, size_t frame_bytes, int depth,
                        int loop) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  auto* L = new FrameLoader();
  L->f = f;
  L->frame_bytes = frame_bytes;
  L->n_frames = size / (long)frame_bytes;
  L->depth = depth < 2 ? 2 : depth;
  L->loop = loop != 0;
  L->ring.resize(L->depth);
  L->ring_frame.assign(L->depth, -1);
  for (int i = 0; i < L->depth; ++i) {
    if (posix_memalign(reinterpret_cast<void**>(&L->ring[i]), 4096,
                       frame_bytes) != 0) {
      L->ring[i] = static_cast<uint8_t*>(malloc(frame_bytes));
    }
  }
  L->worker = std::thread(loader_worker, L);
  return L;
}

long compv_loader_num_frames(void* loader) {
  return static_cast<FrameLoader*>(loader)->n_frames;
}

// Blocking: copy the next prefetched frame into dst. Returns the frame
// index, or -1 at end-of-stream (non-loop).
long compv_loader_next(void* loader, uint8_t* dst) {
  auto* L = static_cast<FrameLoader*>(loader);
  std::unique_lock<std::mutex> lock(L->mu);
  if (L->count == 0 && !L->loop && L->next_read >= L->n_frames) return -1;
  L->cv_can_take.wait(lock, [&] { return L->stop || L->count > 0; });
  if (L->stop && L->count == 0) return -1;
  int slot = L->tail;
  long frame = L->ring_frame[slot];
  lock.unlock();
  memcpy(dst, L->ring[slot], L->frame_bytes);
  lock.lock();
  L->ring_frame[slot] = -1;
  L->tail = (L->tail + 1) % L->depth;
  L->count--;
  lock.unlock();
  L->cv_can_read.notify_one();
  return frame;
}

void compv_loader_close(void* loader) {
  auto* L = static_cast<FrameLoader*>(loader);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->stop = true;
  }
  L->cv_can_read.notify_all();
  L->cv_can_take.notify_all();
  if (L->worker.joinable()) L->worker.join();
  fclose(L->f);
  for (auto* b : L->ring) free(b);
  delete L;
}

// ------------------------------------------------------------ misc kernels

// Strided plane copy (stride-removal like the reference's CompVImage::wrap).
void compv_copy_strided(const uint8_t* src, size_t src_stride, uint8_t* dst,
                        size_t dst_stride, size_t row_bytes, size_t rows) {
  for (size_t r = 0; r < rows; ++r)
    memcpy(dst + r * dst_stride, src + r * src_stride, row_bytes);
}

// ----------------------------------------------------- fork-join executor
//
// Host-side analogue of the reference's thread pool
// (CompVThreadDispatcher11 + CompVAsyncTask11, one pinned worker per core,
// base/parallel/compv_threaddisp11.cxx:18-46). Used for host pre/post
// processing around the XLA compute path: batch decode, stride removal,
// golden hashing. Fork-join parallel_for over [begin, end) index ranges with
// static chunking — the same "dispatchDividingAcrossY" strategy the
// reference uses (compv_threaddisp.cxx:34-46). Nested fork from a worker
// thread runs inline (the reference forbids it outright via
// isMotherOfTheCurrentThread, threaddisp11.cxx:65).

typedef void (*compv_range_fn)(void* arg, long begin, long end, int worker);

struct Executor {
  struct Job {
    compv_range_fn fn;
    void* arg;
    long begin, end;
    int worker;
  };
  std::vector<std::thread> threads;
  std::vector<Job> queue;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  long pending = 0;
  bool stop = false;
};

static thread_local bool g_in_worker = false;

static void executor_loop(Executor* ex, int worker_id) {
  g_in_worker = true;
#if defined(__linux__)
  cpu_set_t set;
  CPU_ZERO(&set);
  CPU_SET(worker_id % std::thread::hardware_concurrency(), &set);
  pthread_setaffinity_np(pthread_self(), sizeof(set), &set);
#endif
  for (;;) {
    Executor::Job job;
    {
      std::unique_lock<std::mutex> lock(ex->mu);
      ex->cv_work.wait(lock, [&] { return ex->stop || !ex->queue.empty(); });
      if (ex->stop && ex->queue.empty()) return;
      job = ex->queue.back();
      ex->queue.pop_back();
    }
    job.fn(job.arg, job.begin, job.end, worker_id);
    {
      std::lock_guard<std::mutex> lock(ex->mu);
      if (--ex->pending == 0) ex->cv_done.notify_all();
    }
  }
}

void* compv_executor_create(int n_threads) {
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  auto* ex = new Executor();
  for (int i = 0; i < n_threads; ++i)
    ex->threads.emplace_back(executor_loop, ex, i);
  return ex;
}

int compv_executor_num_threads(void* exec) {
  return (int)static_cast<Executor*>(exec)->threads.size();
}

// Blocking fork-join parallel for over [begin, end) in `chunks` pieces
// (chunks <= 0 -> one per worker). Safe to call from a worker (runs inline).
void compv_executor_parallel_for(void* exec, compv_range_fn fn, void* arg,
                                 long begin, long end, int chunks) {
  auto* ex = static_cast<Executor*>(exec);
  long n = end - begin;
  if (n <= 0) return;
  int nw = (int)ex->threads.size();
  if (chunks <= 0) chunks = nw;
  if (chunks > n) chunks = (int)n;
  if (g_in_worker || chunks <= 1 || nw == 0) {
    fn(arg, begin, end, -1);  // nested or trivial: run inline
    return;
  }
  long per = n / chunks, extra = n % chunks;
  {
    std::lock_guard<std::mutex> lock(ex->mu);
    long b = begin;
    for (int c = 0; c < chunks; ++c) {
      long e = b + per + (c < extra ? 1 : 0);
      ex->queue.push_back({fn, arg, b, e, c});
      b = e;
    }
    ex->pending += chunks;
  }
  ex->cv_work.notify_all();
  std::unique_lock<std::mutex> lock(ex->mu);
  ex->cv_done.wait(lock, [&] { return ex->pending == 0; });
}

void compv_executor_destroy(void* exec) {
  auto* ex = static_cast<Executor*>(exec);
  {
    std::lock_guard<std::mutex> lock(ex->mu);
    ex->stop = true;
  }
  ex->cv_work.notify_all();
  for (auto& t : ex->threads)
    if (t.joinable()) t.join();
  delete ex;
}

// ------------------------------------------------------------------- MD5
//
// Golden-value hashing: the reference's image tests compare MD5 of the
// output mat computed row-wise ignoring stride padding (compv_tests_md5,
// tests/tests_common.cxx:98-116). Public-domain MD5 algorithm (RFC 1321),
// implemented from the spec.

struct Md5Ctx {
  uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu, d = 0x10325476u;
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buf_len = 0;
};

static const uint32_t kMd5K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
static const int kMd5S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                              7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                              5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                              4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                              6, 10, 15, 21};

static void md5_block(Md5Ctx* ctx, const uint8_t* p) {
  uint32_t m[16];
  memcpy(m, p, 64);
  uint32_t a = ctx->a, b = ctx->b, c = ctx->c, d = ctx->d;
  for (int i = 0; i < 64; ++i) {
    uint32_t f;
    int g;
    if (i < 16) {
      f = (b & c) | (~b & d);
      g = i;
    } else if (i < 32) {
      f = (d & b) | (~d & c);
      g = (5 * i + 1) & 15;
    } else if (i < 48) {
      f = b ^ c ^ d;
      g = (3 * i + 5) & 15;
    } else {
      f = c ^ (b | ~d);
      g = (7 * i) & 15;
    }
    uint32_t tmp = d;
    d = c;
    c = b;
    uint32_t x = a + f + kMd5K[i] + m[g];
    b = b + ((x << kMd5S[i]) | (x >> (32 - kMd5S[i])));
    a = tmp;
  }
  ctx->a += a;
  ctx->b += b;
  ctx->c += c;
  ctx->d += d;
}

void* compv_md5_create() { return new Md5Ctx(); }

void compv_md5_update(void* h, const uint8_t* data, size_t len) {
  auto* ctx = static_cast<Md5Ctx*>(h);
  ctx->total += len;
  if (ctx->buf_len) {
    size_t take = 64 - ctx->buf_len;
    if (take > len) take = len;
    memcpy(ctx->buf + ctx->buf_len, data, take);
    ctx->buf_len += take;
    data += take;
    len -= take;
    if (ctx->buf_len == 64) {
      md5_block(ctx, ctx->buf);
      ctx->buf_len = 0;
    }
  }
  while (len >= 64) {
    md5_block(ctx, data);
    data += 64;
    len -= 64;
  }
  if (len) {
    memcpy(ctx->buf, data, len);
    ctx->buf_len = len;
  }
}

// Row-wise update ignoring stride padding (the reference's golden style).
void compv_md5_update_strided(void* h, const uint8_t* data, size_t stride,
                              size_t row_bytes, size_t rows) {
  for (size_t r = 0; r < rows; ++r)
    compv_md5_update(h, data + r * stride, row_bytes);
}

// Finalize into hex[33] (NUL-terminated) and free the context.
void compv_md5_final(void* h, char* hex_out) {
  auto* ctx = static_cast<Md5Ctx*>(h);
  uint64_t bits = ctx->total * 8;
  uint8_t pad = 0x80;
  compv_md5_update(h, &pad, 1);
  uint8_t zero = 0;
  while (ctx->buf_len != 56) compv_md5_update(h, &zero, 1);
  uint8_t lenb[8];
  for (int i = 0; i < 8; ++i) lenb[i] = (uint8_t)(bits >> (8 * i));
  // write length directly (bypasses total-count update)
  memcpy(ctx->buf + 56, lenb, 8);
  md5_block(ctx, ctx->buf);
  uint32_t out[4] = {ctx->a, ctx->b, ctx->c, ctx->d};
  const char* hexd = "0123456789abcdef";
  auto* ob = reinterpret_cast<uint8_t*>(out);
  for (int i = 0; i < 16; ++i) {
    hex_out[2 * i] = hexd[ob[i] >> 4];
    hex_out[2 * i + 1] = hexd[ob[i] & 15];
  }
  hex_out[32] = '\0';
  delete ctx;
}

}  // extern "C"
