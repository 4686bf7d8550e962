// tudo — the kudo-analog columnar shuffle wire format, C++ hot path.
//
// [REF: NVIDIA/spark-rapids-jni :: src/main/cpp/src/kudo/ — KudoSerializer,
//  a partitioned-write columnar wire format for shuffle]
//
// Design notes: kudo serializes cuDF device tables; here the serializer
// runs on HOST buffers (shuffle data crosses the host on the
// MULTITHREADED path, one D2H per map batch), so the hot loop is a
// per-partition row gather from host column arrays into one contiguous
// output buffer per partition.  The PyTorch port keeps its own copy of
// the JAX package's source, byte-compatible on the wire.  The format is
// laid out so the *reader* needs no native code at all: every section
// is a contiguous dtype run that numpy can view with frombuffer
// (zero-copy deserialize).
//
// Layout per partition buffer (little-endian, no alignment padding):
//   [u32 magic 'TUD0'][u32 version=1][i64 nrows][u32 ncols]
//   per column:
//     [u8 kind: 0=fixed 1=string][u8 has_validity][u16 itemsize]
//     fixed : [data nrows*itemsize]
//     string: [lengths nrows*i32][bytes sum(lengths)]
//     if has_validity: [validity nrows u8]
//
// Exposed C ABI (ctypes):
//   tudo_partition_sizes   — pass 1: exact byte size per partition
//   tudo_partition_write   — pass 2: gather+serialize, threaded over
//                            partitions (spark.rapids.shuffle.
//                            multiThreaded.writer.threads)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

struct ColDesc {
  const uint8_t* data;      // fixed: nrows*itemsize; string: byte matrix
  const uint8_t* validity;  // u8 per row (1=valid) or null
  const int32_t* lengths;   // string: byte length per row, else null
  int32_t kind;             // 0=fixed width, 1=string (padded byte matrix)
  int32_t itemsize;         // fixed: element bytes; string: matrix width
};

static const uint32_t MAGIC = 0x30445554u;  // "TUD0"

static int64_t header_size(int ncols) {
  return 4 + 4 + 8 + 4 + (int64_t)ncols * 4;
}

// exact serialized size of one partition (rows selected by idx[lo..hi))
static int64_t part_size(int ncols, const ColDesc* cols,
                         const int32_t* idx, int64_t n) {
  int64_t sz = header_size(ncols);
  for (int c = 0; c < ncols; ++c) {
    const ColDesc& col = cols[c];
    if (col.kind == 0) {
      sz += n * (int64_t)col.itemsize;
    } else {
      sz += n * 4;  // lengths
      for (int64_t i = 0; i < n; ++i) sz += col.lengths[idx[i]];
    }
    if (col.validity) sz += n;
  }
  return sz;
}

static void write_part(int ncols, const ColDesc* cols, const int32_t* idx,
                       int64_t n, uint8_t* out) {
  uint8_t* p = out;
  std::memcpy(p, &MAGIC, 4); p += 4;
  uint32_t ver = 1; std::memcpy(p, &ver, 4); p += 4;
  int64_t nr = n; std::memcpy(p, &nr, 8); p += 8;
  uint32_t nc = (uint32_t)ncols; std::memcpy(p, &nc, 4); p += 4;
  for (int c = 0; c < ncols; ++c) {
    const ColDesc& col = cols[c];
    uint8_t kind = (uint8_t)col.kind;
    uint8_t hasv = col.validity ? 1 : 0;
    uint16_t isz = (uint16_t)col.itemsize;
    std::memcpy(p, &kind, 1); p += 1;
    std::memcpy(p, &hasv, 1); p += 1;
    std::memcpy(p, &isz, 2); p += 2;
  }
  for (int c = 0; c < ncols; ++c) {
    const ColDesc& col = cols[c];
    if (col.kind == 0) {
      const int64_t isz = col.itemsize;
      switch (isz) {  // common widths get tight loops
        case 1:
          for (int64_t i = 0; i < n; ++i) p[i] = col.data[idx[i]];
          p += n;
          break;
        case 4: {
          uint32_t* o = (uint32_t*)p;
          const uint32_t* d = (const uint32_t*)col.data;
          for (int64_t i = 0; i < n; ++i) o[i] = d[idx[i]];
          p += n * 4;
          break;
        }
        case 8: {
          uint64_t* o = (uint64_t*)p;
          const uint64_t* d = (const uint64_t*)col.data;
          for (int64_t i = 0; i < n; ++i) o[i] = d[idx[i]];
          p += n * 8;
          break;
        }
        default:
          for (int64_t i = 0; i < n; ++i)
            std::memcpy(p + i * isz, col.data + (int64_t)idx[i] * isz, isz);
          p += n * isz;
      }
    } else {
      int32_t* lens = (int32_t*)p;
      for (int64_t i = 0; i < n; ++i) lens[i] = col.lengths[idx[i]];
      p += n * 4;
      const int64_t width = col.itemsize;  // padded matrix row stride
      for (int64_t i = 0; i < n; ++i) {
        const int32_t len = col.lengths[idx[i]];
        std::memcpy(p, col.data + (int64_t)idx[i] * width, len);
        p += len;
      }
    }
    if (col.validity) {
      for (int64_t i = 0; i < n; ++i) p[i] = col.validity[idx[i]];
      p += n;
    }
  }
}

// pass 0: bucket rows by partition id → per-partition row-index lists.
// Returns counts; fills idx_out (size nrows) ordered by partition with
// starts[] giving each partition's slice (counting sort, stable).
void tudo_bucket_rows(const int32_t* pids, const uint8_t* live,
                      int64_t nrows, int32_t nparts,
                      int32_t* idx_out, int64_t* starts /* nparts+1 */) {
  std::vector<int64_t> counts(nparts, 0);
  for (int64_t i = 0; i < nrows; ++i)
    if (!live || live[i]) ++counts[pids[i]];
  starts[0] = 0;
  for (int32_t p = 0; p < nparts; ++p) starts[p + 1] = starts[p] + counts[p];
  std::vector<int64_t> cur(starts, starts + nparts);
  for (int64_t i = 0; i < nrows; ++i)
    if (!live || live[i]) idx_out[cur[pids[i]]++] = (int32_t)i;
}

void tudo_partition_sizes(int ncols, const ColDesc* cols,
                          const int32_t* idx, const int64_t* starts,
                          int32_t nparts, int64_t* sizes_out) {
  for (int32_t p = 0; p < nparts; ++p)
    sizes_out[p] = part_size(ncols, cols, idx + starts[p],
                             starts[p + 1] - starts[p]);
}

void tudo_partition_write(int ncols, const ColDesc* cols,
                          const int32_t* idx, const int64_t* starts,
                          int32_t nparts, uint8_t* out,
                          const int64_t* out_offsets, int32_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > nparts) nthreads = nparts;
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int32_t t = 0; t < nthreads; ++t) {
    pool.emplace_back([=]() {
      for (int32_t p = t; p < nparts; p += nthreads)
        write_part(ncols, cols, idx + starts[p],
                   starts[p + 1] - starts[p], out + out_offsets[p]);
    });
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Scatter path: one streaming pass per column section instead of a
// per-partition random gather.  A gather reads source rows in
// permutation order — every 8-byte load pulls a fresh cache line and
// uses 8 of its 64 bytes; the scatter reads the source SEQUENTIALLY
// (full cache-line utilization, hardware prefetch) and appends to one
// write cursor per partition (nparts open cache lines — fine for the
// 16-64 partitions shuffles use).  Measured 3-4x on the single-core
// hosts this runs on, where thread-pooling the gather can't help.
// Wire format identical to write_part (the reader can't tell).
//
// work layout (int64): [counts nparts][strbytes ncols*nparts]
// ---------------------------------------------------------------------------

void tudo_scatter_sizes(int ncols, const ColDesc* cols,
                        const int32_t* pids, const uint8_t* live,
                        int64_t nrows, int32_t nparts,
                        int64_t* sizes_out, int64_t* work) {
  int64_t* counts = work;
  int64_t* strbytes = work + nparts;
  for (int32_t p = 0; p < nparts; ++p) counts[p] = 0;
  for (int64_t i = 0; i < (int64_t)ncols * nparts; ++i) strbytes[i] = 0;
  for (int64_t i = 0; i < nrows; ++i)
    if (!live || live[i]) ++counts[pids[i]];
  for (int c = 0; c < ncols; ++c) {
    if (cols[c].kind != 1) continue;
    int64_t* sb = strbytes + (int64_t)c * nparts;
    const int32_t* lens = cols[c].lengths;
    for (int64_t i = 0; i < nrows; ++i)
      if (!live || live[i]) sb[pids[i]] += lens[i];
  }
  for (int32_t p = 0; p < nparts; ++p) {
    int64_t sz = header_size(ncols);
    for (int c = 0; c < ncols; ++c) {
      const ColDesc& col = cols[c];
      if (col.kind == 0) {
        sz += counts[p] * (int64_t)col.itemsize;
      } else {
        sz += counts[p] * 4 + strbytes[(int64_t)c * nparts + p];
      }
      if (col.validity) sz += counts[p];
    }
    sizes_out[p] = sz;
  }
}

void tudo_scatter_write(int ncols, const ColDesc* cols,
                        const int32_t* pids, const uint8_t* live,
                        int64_t nrows, int32_t nparts, uint8_t* out,
                        const int64_t* out_offsets, const int64_t* work) {
  const int64_t* counts = work;
  const int64_t* strbytes = work + nparts;
  // headers + per-(partition) section cursor table
  std::vector<uint8_t*> cursor((size_t)nparts);
  for (int32_t p = 0; p < nparts; ++p) {
    uint8_t* o = out + out_offsets[p];
    std::memcpy(o, &MAGIC, 4); o += 4;
    uint32_t ver = 1; std::memcpy(o, &ver, 4); o += 4;
    int64_t nr = counts[p]; std::memcpy(o, &nr, 8); o += 8;
    uint32_t nc = (uint32_t)ncols; std::memcpy(o, &nc, 4); o += 4;
    for (int c = 0; c < ncols; ++c) {
      const ColDesc& col = cols[c];
      uint8_t kind = (uint8_t)col.kind;
      uint8_t hasv = col.validity ? 1 : 0;
      uint16_t isz = (uint16_t)col.itemsize;
      std::memcpy(o, &kind, 1); o += 1;
      std::memcpy(o, &hasv, 1); o += 1;
      std::memcpy(o, &isz, 2); o += 2;
    }
    cursor[p] = o;
  }
  std::vector<uint8_t*> cur((size_t)nparts);
  std::vector<uint8_t*> bytes_cur((size_t)nparts);
  for (int c = 0; c < ncols; ++c) {
    const ColDesc& col = cols[c];
    if (col.kind == 0) {
      const int64_t isz = col.itemsize;
      for (int32_t p = 0; p < nparts; ++p) cur[p] = cursor[p];
      switch (isz) {
        case 1:
          for (int64_t i = 0; i < nrows; ++i)
            if (!live || live[i]) *cur[pids[i]]++ = col.data[i];
          break;
        case 4: {
          const uint32_t* d = (const uint32_t*)col.data;
          for (int64_t i = 0; i < nrows; ++i)
            if (!live || live[i]) {
              uint8_t*& cp = cur[pids[i]];
              *(uint32_t*)cp = d[i];
              cp += 4;
            }
          break;
        }
        case 8: {
          const uint64_t* d = (const uint64_t*)col.data;
          for (int64_t i = 0; i < nrows; ++i)
            if (!live || live[i]) {
              uint8_t*& cp = cur[pids[i]];
              *(uint64_t*)cp = d[i];
              cp += 8;
            }
          break;
        }
        default:
          for (int64_t i = 0; i < nrows; ++i)
            if (!live || live[i]) {
              uint8_t*& cp = cur[pids[i]];
              std::memcpy(cp, col.data + i * isz, isz);
              cp += isz;
            }
      }
      for (int32_t p = 0; p < nparts; ++p)
        cursor[p] += counts[p] * isz;
    } else {
      // lengths section, then the variable bytes section
      for (int32_t p = 0; p < nparts; ++p) {
        cur[p] = cursor[p];
        bytes_cur[p] = cursor[p] + counts[p] * 4;
      }
      const int64_t width = col.itemsize;
      const int32_t* lens = col.lengths;
      for (int64_t i = 0; i < nrows; ++i)
        if (!live || live[i]) {
          const int32_t pp = pids[i];
          const int32_t len = lens[i];
          *(int32_t*)cur[pp] = len;
          cur[pp] += 4;
          std::memcpy(bytes_cur[pp], col.data + i * width, len);
          bytes_cur[pp] += len;
        }
      for (int32_t p = 0; p < nparts; ++p)
        cursor[p] += counts[p] * 4 + strbytes[(int64_t)c * nparts + p];
    }
    if (col.validity) {
      for (int32_t p = 0; p < nparts; ++p) cur[p] = cursor[p];
      for (int64_t i = 0; i < nrows; ++i)
        if (!live || live[i]) *cur[pids[i]]++ = col.validity[i];
      for (int32_t p = 0; p < nparts; ++p) cursor[p] += counts[p];
    }
  }
}

}  // extern "C"
