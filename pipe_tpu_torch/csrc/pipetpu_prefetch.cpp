// pipetpu_prefetch: native double-buffered batch assembly for the LM
// training loop.
//
// The reference stack's input path rides torch's native DataLoader workers
// (background threads assembling batches while the device computes); the
// tutorial driver itself assembles batches inline on the hot loop
// (reference main.py:102-113: get_batch slices + transposes per step).
// In this library a producer thread walks the batchified id matrix and
// writes batch-first (data, target) pairs — get_batch's slice + transpose,
// fused into one pass — into a Python-owned ring of pre-allocated slots, so
// host batch assembly overlaps device compute and the hot loop only copies
// ready buffers to the device. A copy of the root csrc/pipetpu_prefetch.cpp.
//
// Contract (enforced by the ctypes wrapper in pipe_tpu_torch/data/native.py):
//   - source is row-major [nrows, bsz] int32; batch b covers rows
//     [b*bptt, (b+1)*bptt) with target rows shifted by one; only FULL
//     batches are produced ((nrows-1)/bptt of them) — the trainer's
//     tail-batch break, precomputed.
//   - slots live in caller-owned slabs [depth, bsz, bptt]; a slot returned
//     by ptpf_next stays valid until ptpf_release(slot); after release the
//     producer may overwrite it (classic double-buffer discipline).
//   - ptpf_next returns slots strictly in batch order; -1 when exhausted.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread pipetpu_prefetch.cpp
//        -o libpipetpu_prefetch.so

#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <thread>

namespace {

struct Prefetcher {
  const int32_t* src = nullptr;  // [nrows, bsz] row-major (caller-owned)
  int64_t nrows = 0, bsz = 0, bptt = 0;
  int64_t nb = 0;     // number of full batches
  int64_t depth = 0;  // ring slots
  int32_t* data_slab = nullptr;  // [depth, bsz, bptt] (caller-owned)
  int32_t* tgt_slab = nullptr;   // [depth, bsz, bptt] (caller-owned)

  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  int64_t produced = 0;  // batches written and published
  int64_t consumed = 0;  // batches handed to the consumer
  int64_t released = 0;  // batches the consumer has finished with
  bool stop = false;
  std::thread worker;

  void fill(int64_t b) {
    const int64_t slot = b % depth;
    int32_t* d = data_slab + slot * bsz * bptt;
    int32_t* t = tgt_slab + slot * bsz * bptt;
    const int32_t* base = src + b * bptt * bsz;
    // data[r, i] = source[b*bptt + i, r]; target shifts the row by one.
    for (int64_t i = 0; i < bptt; ++i) {
      const int32_t* row = base + i * bsz;
      const int32_t* row_next = row + bsz;
      for (int64_t r = 0; r < bsz; ++r) {
        d[r * bptt + i] = row[r];
        t[r * bptt + i] = row_next[r];
      }
    }
  }

  void run() {
    for (int64_t b = 0; b < nb; ++b) {
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_producer.wait(
            lock, [&] { return stop || produced - released < depth; });
        if (stop) return;
      }
      fill(b);  // slot is exclusively the producer's until published
      {
        std::lock_guard<std::mutex> lock(mu);
        ++produced;
      }
      cv_consumer.notify_one();
    }
  }
};

}  // namespace

extern "C" {

Prefetcher* ptpf_create(const int32_t* source, int64_t nrows, int64_t bsz,
                        int64_t bptt, int64_t depth, int32_t* data_slab,
                        int32_t* tgt_slab) {
  if (!source || !data_slab || !tgt_slab || nrows < 0 || bsz <= 0 ||
      bptt <= 0 || depth <= 0) {
    return nullptr;
  }
  try {
    auto* pf = new Prefetcher();
    pf->src = source;
    pf->nrows = nrows;
    pf->bsz = bsz;
    pf->bptt = bptt;
    pf->nb = nrows > 0 ? (nrows - 1) / bptt : 0;
    pf->depth = depth;
    pf->data_slab = data_slab;
    pf->tgt_slab = tgt_slab;
    pf->worker = std::thread([pf] { pf->run(); });
    return pf;
  } catch (...) {
    return nullptr;  // never let a C++ exception cross the C ABI
  }
}

int64_t ptpf_num_batches(const Prefetcher* pf) { return pf->nb; }

// Blocks until the next batch (in order) is ready; returns its slot index,
// or -1 when all nb batches have been consumed.
int64_t ptpf_next(Prefetcher* pf) {
  std::unique_lock<std::mutex> lock(pf->mu);
  if (pf->consumed >= pf->nb) return -1;
  pf->cv_consumer.wait(
      lock, [&] { return pf->stop || pf->produced > pf->consumed; });
  if (pf->stop) return -1;
  const int64_t slot = pf->consumed % pf->depth;
  ++pf->consumed;
  return slot;
}

// Marks the oldest outstanding slot reusable. Slots are released in the
// order they were consumed (the wrapper enforces this).
void ptpf_release(Prefetcher* pf) {
  {
    std::lock_guard<std::mutex> lock(pf->mu);
    if (pf->released < pf->consumed) ++pf->released;
  }
  pf->cv_producer.notify_one();
}

void ptpf_free(Prefetcher* pf) {
  if (!pf) return;
  {
    std::lock_guard<std::mutex> lock(pf->mu);
    pf->stop = true;
  }
  pf->cv_producer.notify_all();
  pf->cv_consumer.notify_all();
  if (pf->worker.joinable()) pf->worker.join();
  delete pf;
}

}  // extern "C"
