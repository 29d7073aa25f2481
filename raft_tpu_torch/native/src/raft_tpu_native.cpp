// raft_tpu native runtime — host-side C++ for the pieces the reference
// implements natively and that sit off the XLA compute path:
//
//  * bin dataset IO (fbin/ibin/u8bin) with mmap'd zero-copy batch reads —
//    the role of the reference's mmap'd fbin reader
//    (cpp/bench/ann/src/common/dataset.hpp) for out-of-core datasets.
//  * hnswlib-format serializer: writes a base-layer-only hnswlib index
//    from a CAGRA graph + dataset, interoperable with hnswlib's
//    loadIndex (the reference's CAGRA→HNSW export,
//    neighbors/detail/hnsw_types.hpp:60-86).
//  * agglomerative union-find labeling over sorted MST edges — the
//    sequential dendrogram step of single-linkage
//    (cluster/detail/agglomerative.cuh analog).
//  * IVF list packing: group rows by cluster label into padded lists —
//    the host half of build_index_kernel (detail/ivf_flat_build.cuh:123).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>
#include <algorithm>
#include <limits>
#include <numeric>
#include <thread>
#include <utility>
#include <mutex>
#include <condition_variable>

namespace {

// Double-buffered background batch reader: a worker thread preads batch
// i+1 while the consumer processes batch i — the role of the reference
// bench harness's mmap'd dataset + thread pool (bench/ann/src/common/
// dataset.hpp, thread_pool.hpp) for streaming larger-than-memory builds.
struct Prefetcher {
  int fd = -1;
  int64_t n_rows = 0, dim = 0, elem = 0, batch_rows = 0, n_batches = 0;
  int64_t row0 = 0;
  std::thread worker;
  std::mutex m;
  std::condition_variable cv;
  std::vector<std::vector<char>> bufs;
  std::vector<int64_t> buf_rows;  // rows in slot, -1 = empty
  int64_t consumed = 0;
  bool stop = false;
  int err = 0;
};

// pread until `want` bytes land (short reads are routine: 2 GiB syscall
// cap, EINTR, network filesystems). Returns false on EOF/error.
bool pread_fully(int fd, char* out, int64_t want, int64_t off) {
  int64_t done = 0;
  while (done < want) {
    ssize_t got = pread(fd, out + done, want - done, off + done);
    if (got <= 0) return false;
    done += got;
  }
  return true;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------ bin IO

// Header: int32 n_rows, int32 dim. Returns 0 on success.
int bin_read_header(const char* path, int64_t* n_rows, int64_t* dim) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int32_t hdr[2];
  if (std::fread(hdr, sizeof(int32_t), 2, f) != 2) {
    std::fclose(f);
    return -2;
  }
  *n_rows = hdr[0];
  *dim = hdr[1];
  std::fclose(f);
  return 0;
}

// Read rows [row_start, row_start+n_rows) into out (caller-allocated,
// n_rows*dim*elem_size bytes). Uses pread — no seek state, thread-safe.
int bin_read_rows(const char* path, int64_t row_start, int64_t n_rows,
                  int64_t elem_size, void* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  int32_t hdr[2];
  if (pread(fd, hdr, sizeof(hdr), 0) != (ssize_t)sizeof(hdr)) {
    close(fd);
    return -2;
  }
  const int64_t dim = hdr[1];
  const int64_t row_bytes = dim * elem_size;
  const int64_t off = 8 + row_start * row_bytes;
  const int64_t want = n_rows * row_bytes;
  if (!pread_fully(fd, (char*)out, want, off)) {
    close(fd);
    return -3;
  }
  close(fd);
  return 0;
}

int bin_write(const char* path, const void* data, int64_t n_rows,
              int64_t dim, int64_t elem_size) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int32_t hdr[2] = {(int32_t)n_rows, (int32_t)dim};
  if (std::fwrite(hdr, sizeof(int32_t), 2, f) != 2) {
    std::fclose(f);
    return -2;
  }
  const size_t want = (size_t)(n_rows * dim * elem_size);
  if (std::fwrite(data, 1, want, f) != want) {
    std::fclose(f);
    return -3;
  }
  std::fclose(f);
  return 0;
}

// --------------------------------------------------------- hnswlib writer

// Writes a base-layer-only hnswlib index: header fields in hnswlib
// saveIndex order, one level-0 block per element
// [uint32 n_links][maxM0 x uint32][dim x float][size_t label], then a zero
// linkListSize per element (no upper layers). space: 0 = l2, 1 = ip.
// raft_compat selects the header constants:
//   0 ("hnswlib"): max_level=0, enterpoint=0 — stock hnswlib's searchKnn
//     never descends through (absent) upper layers, so the file is safe
//     for an unpatched HierarchicalNSW::loadIndex + search.
//   1 ("raft"): byte-identical to the reference serializer
//     (cagra_serialize.cuh:113-154 — max_level=1, enterpoint=n/2,
//     mult=0.42424242, efConstruction=500), the layout its
//     base_layer_only fork loader consumes (hnsw_types.hpp:60-86). Stock
//     hnswlib would crash searching this variant (null upper link list at
//     the enterpoint) — it exists for byte-compat proofs.
int hnswlib_write(const char* path, const float* data, const int32_t* graph,
                  int64_t n, int64_t dim, int64_t degree, int64_t /*space*/,
                  int64_t raft_compat) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;

  const uint64_t offset_level0 = 0;
  const uint64_t max_elements = (uint64_t)n;
  const uint64_t cur_count = (uint64_t)n;
  const uint64_t size_links0 = (uint64_t)degree * 4 + 4;
  const uint64_t data_size = (uint64_t)dim * 4;
  const uint64_t size_per_elem = size_links0 + data_size + 8;
  const uint64_t label_offset = size_links0 + data_size;
  const uint64_t offset_data = size_links0;
  const int32_t max_level = raft_compat ? 1 : 0;
  const int32_t enterpoint = raft_compat ? (int32_t)(n / 2) : 0;
  const uint64_t maxM = (uint64_t)degree / 2 ? (uint64_t)degree / 2 : 1;
  const uint64_t maxM0 = (uint64_t)degree;
  const uint64_t M = maxM;
  const double mult =
      raft_compat ? 0.42424242 : 1.0 / std::log((double)(M > 1 ? M : 2));
  const uint64_t ef_construction = raft_compat ? 500 : 200;

#define W(x) if (std::fwrite(&(x), sizeof(x), 1, f) != 1) { std::fclose(f); return -2; }
  W(offset_level0);
  W(max_elements);
  W(cur_count);
  W(size_per_elem);
  W(label_offset);
  W(offset_data);
  W(max_level);
  W(enterpoint);
  W(maxM);
  W(maxM0);
  W(M);
  W(mult);
  W(ef_construction);
#undef W

  std::vector<char> elem(size_per_elem);
  for (int64_t i = 0; i < n; ++i) {
    // count valid links (graph entries >= 0)
    uint32_t cnt = 0;
    for (int64_t j = 0; j < degree; ++j)
      if (graph[i * degree + j] >= 0) ++cnt;
    std::memset(elem.data(), 0, elem.size());
    std::memcpy(elem.data(), &cnt, 4);
    uint32_t* links = (uint32_t*)(elem.data() + 4);
    uint32_t w = 0;
    for (int64_t j = 0; j < degree; ++j) {
      int32_t t = graph[i * degree + j];
      if (t >= 0) links[w++] = (uint32_t)t;
    }
    std::memcpy(elem.data() + offset_data, data + i * dim, data_size);
    uint64_t label = (uint64_t)i;
    std::memcpy(elem.data() + label_offset, &label, 8);
    if (std::fwrite(elem.data(), 1, elem.size(), f) != elem.size()) {
      std::fclose(f);
      return -3;
    }
  }
  const uint32_t zero = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (std::fwrite(&zero, 4, 1, f) != 1) {
      std::fclose(f);
      return -4;
    }
  }
  std::fclose(f);
  return 0;
}

// ------------------------------------------- union-find dendrogram labels

static int64_t uf_find(int64_t* parent, int64_t a) {
  int64_t root = a;
  while (parent[root] != root) root = parent[root];
  while (parent[a] != root) {
    int64_t next = parent[a];
    parent[a] = root;
    a = next;
  }
  return root;
}

// Merge MST edges (already sorted by weight ascending; -1 src = padding)
// until n_clusters components remain. labels out: [n] compacted 0..k-1.
int agglomerative_label(const int32_t* src, const int32_t* dst,
                        int64_t n_edges, int64_t n, int64_t n_clusters,
                        int32_t* labels) {
  std::vector<int64_t> parent(n);
  std::iota(parent.begin(), parent.end(), 0);
  int64_t target = n - n_clusters;
  int64_t merges = 0;
  for (int64_t e = 0; e < n_edges && merges < target; ++e) {
    if (src[e] < 0 || dst[e] < 0) continue;
    int64_t ra = uf_find(parent.data(), src[e]);
    int64_t rb = uf_find(parent.data(), dst[e]);
    if (ra == rb) continue;
    parent[std::max(ra, rb)] = std::min(ra, rb);
    ++merges;
  }
  // compact root ids to 0..k-1
  std::vector<int32_t> remap(n, -1);
  int32_t next_label = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = uf_find(parent.data(), i);
    if (remap[r] < 0) remap[r] = next_label++;
    labels[i] = remap[r];
  }
  return next_label;
}

// ----------------------------------------------------- IVF list packing

// Group rows by label into padded [n_lists, list_pad, row_bytes] storage +
// ids [n_lists, list_pad] (-1 pad) + sizes [n_lists]. Returns 0.
int pack_lists(const char* rows, const int32_t* labels, const int32_t* ids,
               int64_t n_rows, int64_t row_bytes, int64_t n_lists,
               int64_t list_pad, char* out_data, int32_t* out_ids,
               int32_t* out_sizes) {
  std::vector<int64_t> cursor(n_lists, 0);
  std::memset(out_sizes, 0, n_lists * sizeof(int32_t));
  for (int64_t i = 0; i < n_rows; ++i) {
    const int32_t l = labels[i];
    if (l < 0 || l >= n_lists) return -1;
    const int64_t pos = cursor[l]++;
    if (pos >= list_pad) return -2;
    std::memcpy(out_data + (l * list_pad + pos) * row_bytes,
                rows + i * row_bytes, row_bytes);
    out_ids[l * list_pad + pos] = ids ? ids[i] : (int32_t)i;
    out_sizes[l] = (int32_t)cursor[l];
  }
  // -1-fill unused id slots
  for (int64_t l = 0; l < n_lists; ++l)
    for (int64_t p = cursor[l]; p < list_pad; ++p)
      out_ids[l * list_pad + p] = -1;
  return 0;
}

// ------------------------------------------------------- batch prefetcher

// row_start/row_limit bound the streamed range (row_limit<0 = to EOF).
// _v2 suffix: the signature was widened from the first release; a distinct
// symbol keeps a stale old-ABI .so from silently ignoring the range args.
void* prefetch_open_v2(const char* path, int64_t batch_rows,
                       int64_t elem_size, int64_t row_start,
                       int64_t row_limit) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  int32_t hdr[2];
  if (pread(fd, hdr, sizeof(hdr), 0) != (ssize_t)sizeof(hdr)) {
    close(fd);
    return nullptr;
  }
  // validate the header before sizing buffers: a corrupt file must fail
  // with a catchable Python error, not a C++ exception crossing the C ABI
  if (hdr[0] < 0 || hdr[1] <= 0 || batch_rows <= 0 || elem_size <= 0 ||
      (int64_t)hdr[1] * elem_size > (int64_t)1 << 40) {
    close(fd);
    return nullptr;
  }
  int64_t total = hdr[0];
  if (row_start < 0 || row_start > total) {
    close(fd);
    return nullptr;
  }
  int64_t avail = total - row_start;
  int64_t n = (row_limit < 0 || row_limit > avail) ? avail : row_limit;
  auto* p = new Prefetcher();
  p->fd = fd;
  p->n_rows = n;
  p->row0 = row_start;
  p->dim = hdr[1];
  p->elem = elem_size;
  p->batch_rows = batch_rows;
  p->n_batches = (p->n_rows + batch_rows - 1) / batch_rows;
  const int depth = 2;
  try {
    p->bufs.resize(depth);
    p->buf_rows.assign(depth, -1);
    for (auto& b : p->bufs)
      b.resize((size_t)batch_rows * p->dim * elem_size);
  } catch (...) {  // bad_alloc on absurd batch sizes
    close(fd);
    delete p;
    return nullptr;
  }
  p->worker = std::thread([p, depth]() {
    for (int64_t bi = 0; bi < p->n_batches; ++bi) {
      int slot = (int)(bi % depth);
      {
        std::unique_lock<std::mutex> lk(p->m);
        p->cv.wait(lk, [&] { return p->stop || p->buf_rows[slot] < 0; });
        if (p->stop) return;
      }
      int64_t start = bi * p->batch_rows;
      int64_t rows = std::min(p->batch_rows, p->n_rows - start);
      int64_t bytes = rows * p->dim * p->elem;
      int64_t off = 8 + (p->row0 + start) * p->dim * p->elem;
      bool ok = pread_fully(p->fd, p->bufs[slot].data(), bytes, off);
      std::lock_guard<std::mutex> lk(p->m);
      if (!ok) {
        p->err = -3;
        p->buf_rows[slot] = 0;
      } else {
        p->buf_rows[slot] = rows;
      }
      p->cv.notify_all();
      if (p->err) return;
    }
  });
  return p;
}

// Copies the next batch into out (caller-allocated, batch_rows*dim*elem).
// Returns rows copied, 0 at EOF, <0 on read error.
int64_t prefetch_next(void* handle, void* out) {
  auto* p = (Prefetcher*)handle;
  const int depth = (int)p->bufs.size();
  if (p->consumed >= p->n_batches) return 0;
  int slot = (int)(p->consumed % depth);
  int64_t rows;
  {
    std::unique_lock<std::mutex> lk(p->m);
    p->cv.wait(lk, [&] { return p->buf_rows[slot] >= 0 || p->err; });
    rows = p->buf_rows[slot];
    // Drain any valid batch already staged in this slot even if the worker
    // has since failed on a later batch; surface the error only when this
    // slot itself carries it (the worker stores 0 rows on a failed read —
    // real batches always have >= 1 row) or was never filled.
    if (rows <= 0) return p->err ? p->err : 0;
  }
  std::memcpy(out, p->bufs[slot].data(), (size_t)rows * p->dim * p->elem);
  {
    std::lock_guard<std::mutex> lk(p->m);
    p->buf_rows[slot] = -1;
    p->consumed++;
    p->cv.notify_all();
  }
  return rows;
}

void prefetch_close(void* handle) {
  auto* p = (Prefetcher*)handle;
  {
    std::lock_guard<std::mutex> lk(p->m);
    p->stop = true;
    p->cv.notify_all();
  }
  if (p->worker.joinable()) p->worker.join();
  close(p->fd);
  delete p;
}

// --------------------------------------------- graph ef-search (hnsw role)
//
// CPU greedy beam search over a fixed-degree neighbor graph — hnswlib's
// layer-0 searchBaseLayerST algorithm (candidate min-heap + bounded
// result max-heap + visited stamps), run from a fixed entry point, which
// is exactly how the base-layer-only indexes hnswlib_write() emits are
// searched. This is the external-competitor row of the bench harness
// (the hnswlib wrapper role, cpp/bench/ann/src/hnswlib/
// hnswlib_wrapper.h): no hnswlib wheel exists on this image, so the
// algorithm itself provides the CPU rival pareto points.
int graph_greedy_search(const float* data, int64_t n, int64_t dim,
                        const int32_t* graph, int64_t degree,
                        const float* queries, int64_t nq,
                        int64_t k, int64_t ef, int64_t entry,
                        int32_t* out_ids, float* out_dists,
                        int64_t n_threads) {
  if (n <= 0 || k <= 0 || ef < k || entry < 0 || entry >= n) return -1;
  if (nq <= 0) return 0;  // empty batch: nothing to do (and the thread
                          // clamp below would otherwise divide by zero)
  if (n_threads <= 0)
    n_threads = (int64_t)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > nq) n_threads = nq;

  auto worker = [&](int64_t q_lo, int64_t q_hi) {
    std::vector<uint32_t> visited(n, 0);
    uint32_t epoch = 0;
    // (dist, id) heaps: cand = min-first frontier, res = max-first top-ef
    using Entry = std::pair<float, int32_t>;
    std::vector<Entry> cand, res;
    for (int64_t qi = q_lo; qi < q_hi; ++qi) {
      const float* q = queries + qi * dim;
      ++epoch;
      cand.clear();
      res.clear();
      auto l2 = [&](int64_t row) {
        const float* v = data + row * dim;
        float s = 0.f;
        for (int64_t d = 0; d < dim; ++d) {
          float t = q[d] - v[d];
          s += t * t;
        }
        return s;
      };
      float d0 = l2(entry);
      cand.push_back({-d0, (int32_t)entry});  // negate: max-heap = nearest
      res.push_back({d0, (int32_t)entry});
      visited[entry] = epoch;
      float worst = d0;
      while (!cand.empty()) {
        std::pop_heap(cand.begin(), cand.end());
        Entry c = cand.back();
        cand.pop_back();
        if (-c.first > worst && (int64_t)res.size() >= ef) break;
        const int32_t* row = graph + (int64_t)c.second * degree;
        for (int64_t j = 0; j < degree; ++j) {
          int32_t nb = row[j];
          if (nb < 0 || nb >= n || visited[nb] == epoch) continue;
          visited[nb] = epoch;
          float d = l2(nb);
          if ((int64_t)res.size() < ef || d < worst) {
            cand.push_back({-d, nb});
            std::push_heap(cand.begin(), cand.end());
            res.push_back({d, nb});
            std::push_heap(res.begin(), res.end());
            if ((int64_t)res.size() > ef) {
              std::pop_heap(res.begin(), res.end());
              res.pop_back();
            }
            worst = res.front().first;
          }
        }
      }
      std::sort(res.begin(), res.end());
      for (int64_t j = 0; j < k; ++j) {
        bool have = j < (int64_t)res.size();
        out_ids[qi * k + j] = have ? res[j].second : -1;
        out_dists[qi * k + j] = have ? res[j].first
                                     : std::numeric_limits<float>::infinity();
      }
    }
  };

  if (n_threads == 1) {
    worker(0, nq);
  } else {
    std::vector<std::thread> pool;
    int64_t chunk = (nq + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t lo = t * chunk, hi = std::min(nq, lo + chunk);
      if (lo >= hi) break;
      pool.emplace_back(worker, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
