// The PyTorch port's copy of matrix_eyes_tpu/native/pngwriter.cpp, built by
// matrix_eyes_tpu_torch/native/__init__.py.
//
// Striped parallel PNG encoder (RGB8) for the stereogram / depth-map
// outputs (reference: output.rs:123-193 ends at out_image.save -- PNG
// encoding is part of the user-visible cost, and the reference's
// single-threaded image-crate encode is the model being beaten).
//
// Design: the image is encoded in independent row bands ("stripes").
// Each stripe is filtered and raw-deflated on a worker thread, terminated
// with Z_FULL_FLUSH -- a byte-aligned deflate boundary that resets the
// window, so stripe outputs concatenate into one valid deflate stream.
// The zlib container is assembled around them: 2-byte header, stripe
// blocks, an empty BFINAL deflate block, and an adler32 trailer combined
// from the per-stripe sums with adler32_combine. Each stripe becomes its
// own IDAT chunk (PNG permits any IDAT segmentation), so nothing is
// re-buffered before hitting the file.
//
// Two wins over a monolithic encoder:
//   * stripes compress on N cores concurrently (pigz-style);
//   * mepng_write_rows() enqueues and returns, so the caller can overlap
//     device->host readback of band k+1 with the compression of band k.
//
// C API (ctypes): mepng_begin / mepng_write_rows / mepng_end / mepng_abort.

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kFilterNone = 0;
// filter ids 1..4 = Sub / Up / Average / Paeth, applied to every row

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// Filter one row (RGB, bpp=3) into dst (no leading filter byte).
void filter_row(int filter, const uint8_t* row, const uint8_t* prior,
                uint8_t* dst, int64_t rowbytes) {
  constexpr int bpp = 3;
  switch (filter) {
    case 1:  // Sub
      for (int64_t i = 0; i < bpp; ++i) dst[i] = row[i];
      for (int64_t i = bpp; i < rowbytes; ++i) dst[i] = (uint8_t)(row[i] - row[i - bpp]);
      break;
    case 2:  // Up
      for (int64_t i = 0; i < rowbytes; ++i) dst[i] = (uint8_t)(row[i] - prior[i]);
      break;
    case 3:  // Average
      for (int64_t i = 0; i < bpp; ++i) dst[i] = (uint8_t)(row[i] - prior[i] / 2);
      for (int64_t i = bpp; i < rowbytes; ++i)
        dst[i] = (uint8_t)(row[i] - (row[i - bpp] + prior[i]) / 2);
      break;
    case 4:  // Paeth
      for (int64_t i = 0; i < bpp; ++i) dst[i] = (uint8_t)(row[i] - paeth(0, prior[i], 0));
      for (int64_t i = bpp; i < rowbytes; ++i)
        dst[i] = (uint8_t)(row[i] - paeth(row[i - bpp], prior[i], prior[i - bpp]));
      break;
    default:
      std::memcpy(dst, row, (size_t)rowbytes);
  }
}

struct Stripe {
  int64_t index = 0;
  std::vector<uint8_t> rows;    // raw pixels, nrows * rowbytes
  std::vector<uint8_t> prior;   // row preceding this stripe (zeros for first)
  int64_t nrows = 0;
  // stereogram-reconstruction jobs carry (shift, noise) instead of pixels
  std::vector<uint8_t> shift;   // nrows * w, link shifts
  std::vector<uint8_t> noise;   // nrows * pw * 3, per-row seed pixels
  int64_t pattern_width = 0;    // 0 = plain pixel stripe
  // results
  std::vector<uint8_t> compressed;
  uLong adler = 0;
  int64_t filtered_len = 0;
  uint32_t crc = 0;             // crc32 of "IDAT" + compressed
  bool failed = false;
};

// The reference's per-row linker scan (output.rs:173-185): out[x] is the
// noise seed pixel reached by following parent links x + shift[x] - pw.
// Row-independent, so it parallelises over the stripe worker pool; shifts
// obey shift <= dm < pw, so every parent lies strictly left of x and a
// single left-to-right pass resolves all chains.
void reconstruct_stereo_rows(const uint8_t* shift, const uint8_t* noise,
                             uint8_t* out, int64_t nrows, int64_t w,
                             int64_t pw) {
  for (int64_t r = 0; r < nrows; ++r) {
    const uint8_t* srow = shift + r * w;
    const uint8_t* nrow = noise + r * pw * 3;
    uint8_t* orow = out + r * w * 3;
    int64_t head = std::min<int64_t>(pw, w);
    std::memcpy(orow, nrow, (size_t)head * 3);
    for (int64_t x = pw; x < w; ++x) {
      int64_t p = x + (int64_t)srow[x] - pw;  // in [x - pw, x) for valid input
      // contract: shift <= dm < pw (the wrapper gates the pathological
      // cases); clamp so corrupted shifts cannot read past the row
      p = p < x ? p : x - 1;
      std::memcpy(orow + x * 3, orow + p * 3, 3);
    }
  }
}

struct Encoder {
  FILE* f = nullptr;
  int64_t w = 0, h = 0;
  int level = 1;
  int filter = kFilterNone;
  int64_t rows_in = 0;
  int64_t next_index = 0;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  std::deque<std::unique_ptr<Stripe>> queue;
  std::vector<std::unique_ptr<Stripe>> done;   // indexed by stripe
  int64_t completed = 0;
  bool shutdown = false;
  bool error = false;

  std::vector<uint8_t> last_row;  // prior for the next stripe

  int64_t rowbytes() const { return w * 3; }

  void work() {
    for (;;) {
      std::unique_ptr<Stripe> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return shutdown || !queue.empty(); });
        if (queue.empty()) return;  // shutdown and drained
        job = std::move(queue.front());
        queue.pop_front();
      }
      compress_stripe(*job);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (job->failed) error = true;
        if ((int64_t)done.size() <= job->index) done.resize(job->index + 1);
        int64_t idx = job->index;
        done[idx] = std::move(job);
        ++completed;
      }
      cv_done.notify_all();
    }
  }

  void compress_stripe(Stripe& s) {
    const int64_t rb = rowbytes();
    if (s.pattern_width > 0) {  // reconstruct pixels from (shift, noise)
      s.rows.resize((size_t)(s.nrows * rb));
      reconstruct_stereo_rows(s.shift.data(), s.noise.data(), s.rows.data(),
                              s.nrows, w, s.pattern_width);
      s.shift.clear();
      s.shift.shrink_to_fit();
      s.noise.clear();
      s.noise.shrink_to_fit();
    }
    const int64_t flen = s.nrows * (rb + 1);
    // one deflate() call per stripe: zlib's avail_in/avail_out are uInt,
    // so a stripe over ~2 GiB would silently truncate and corrupt the
    // stream -- fail it instead (callers band at 256 rows; this only
    // guards a pathological single-stripe image)
    if (flen > (int64_t(1) << 31) - 64) {
      s.failed = true;
      return;
    }
    std::vector<uint8_t> filtered((size_t)flen);
    const uint8_t* prior = s.prior.data();
    for (int64_t r = 0; r < s.nrows; ++r) {
      uint8_t* dst = filtered.data() + r * (rb + 1);
      const uint8_t* row = s.rows.data() + r * rb;
      *dst = (uint8_t)filter;
      filter_row(filter, row, prior, dst + 1, rb);
      prior = row;
    }
    s.rows.clear();
    s.rows.shrink_to_fit();
    s.prior.clear();
    s.prior.shrink_to_fit();

    // (64-bit safe) fold in chunks <= UINT_MAX
    {
      uLong a = adler32(0L, Z_NULL, 0);
      int64_t off = 0;
      while (off < flen) {
        uInt n = (uInt)std::min<int64_t>(flen - off, 1u << 30);
        a = adler32(a, filtered.data() + off, n);
        off += n;
      }
      s.adler = a;
    }
    s.filtered_len = flen;

    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    // raw deflate: the zlib container is hand-assembled around the stripes
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK) {
      s.failed = true;
      return;
    }
    uLong bound = deflateBound(&zs, (uLong)flen) + 16;
    s.compressed.resize((size_t)bound);
    zs.next_in = filtered.data();
    zs.avail_in = (uInt)flen;
    zs.next_out = s.compressed.data();
    zs.avail_out = (uInt)bound;
    // Z_FULL_FLUSH: byte-aligned boundary + window reset, so independent
    // stripe streams concatenate into one valid deflate stream
    int rc = deflate(&zs, Z_FULL_FLUSH);
    if (rc != Z_OK || zs.avail_in != 0) {
      deflateEnd(&zs);
      s.failed = true;
      return;
    }
    s.compressed.resize(bound - zs.avail_out);
    deflateEnd(&zs);

    uint32_t crc = (uint32_t)crc32(0L, Z_NULL, 0);
    crc = (uint32_t)crc32(crc, (const Bytef*)"IDAT", 4);
    {
      uLong c = crc;
      size_t off = 0;
      while (off < s.compressed.size()) {
        uInt n = (uInt)std::min<size_t>(s.compressed.size() - off, 1u << 30);
        c = crc32(c, s.compressed.data() + off, n);
        off += n;
      }
      crc = (uint32_t)c;
    }
    s.crc = crc;
  }
};

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}

bool write_chunk(FILE* f, const char type[4], const uint8_t* data, size_t len) {
  uint8_t hdr[8];
  put_be32(hdr, (uint32_t)len);
  std::memcpy(hdr + 4, type, 4);
  if (fwrite(hdr, 1, 8, f) != 8) return false;
  if (len && fwrite(data, 1, len, f) != len) return false;
  uLong crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, (const Bytef*)type, 4);
  if (len) crc = crc32(crc, data, (uInt)len);
  uint8_t tail[4];
  put_be32(tail, (uint32_t)crc);
  return fwrite(tail, 1, 4, f) == 4;
}

// Chunk with a precomputed CRC (the worker already hashed the data).
bool write_chunk_crc(FILE* f, const char type[4], const uint8_t* data,
                     size_t len, uint32_t crc) {
  uint8_t hdr[8];
  put_be32(hdr, (uint32_t)len);
  std::memcpy(hdr + 4, type, 4);
  if (fwrite(hdr, 1, 8, f) != 8) return false;
  if (len && fwrite(data, 1, len, f) != len) return false;
  uint8_t tail[4];
  put_be32(tail, crc);
  return fwrite(tail, 1, 4, f) == 4;
}

}  // namespace

extern "C" {

// Begin a streaming PNG encode. Returns an opaque handle or null.
// filter: 0=None 1=Sub 2=Up 3=Average 4=Paeth (fixed for all rows).
void* mepng_begin(const char* path, int64_t w, int64_t h, int level,
                  int filter, int nthreads) {
  if (w <= 0 || h <= 0 || filter < 0 || filter > 4) return nullptr;
  auto* e = new Encoder();
  e->f = std::fopen(path, "wb");
  if (!e->f) {
    delete e;
    return nullptr;
  }
  e->w = w;
  e->h = h;
  e->level = level < 0 ? 1 : (level > 9 ? 9 : level);
  e->filter = filter;
  e->last_row.assign((size_t)e->rowbytes(), 0);
  if (nthreads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    nthreads = hc ? (int)hc : 1;
  }
  if (nthreads > 64) nthreads = 64;
  for (int i = 0; i < nthreads; ++i)
    e->workers.emplace_back([e] { e->work(); });
  return e;
}

// Enqueue nrows rows (RGB8, tightly packed) as one stripe; returns 0 on
// success. Copies the data and returns immediately -- compression happens
// on the worker pool.
int mepng_write_rows(void* handle, const uint8_t* rows, int64_t nrows) {
  auto* e = (Encoder*)handle;
  if (!e || nrows <= 0 || e->rows_in + nrows > e->h) return 1;
  const int64_t rb = e->rowbytes();
  auto s = std::make_unique<Stripe>();
  s->index = e->next_index++;
  s->nrows = nrows;
  s->rows.assign(rows, rows + nrows * rb);
  s->prior = e->last_row;
  e->last_row.assign(rows + (nrows - 1) * rb, rows + nrows * rb);
  e->rows_in += nrows;
  {
    std::lock_guard<std::mutex> lk(e->mu);
    e->queue.push_back(std::move(s));
  }
  e->cv_job.notify_one();
  return 0;
}

// Enqueue nrows stereogram rows given per-pixel link shifts (nrows * w u8)
// and per-row noise seeds (nrows * pw * 3 u8); the worker pool reconstructs
// the pixels with the reference's linker scan, then compresses. Only valid
// with filter None (row filters would need the previous stripe's pixels,
// which are not reconstructed yet at enqueue time). Returns 0 on success.
int mepng_write_stereo_rows(void* handle, const uint8_t* shift,
                            const uint8_t* noise, int64_t nrows, int64_t pw) {
  auto* e = (Encoder*)handle;
  if (!e || nrows <= 0 || e->rows_in + nrows > e->h) return 1;
  if (e->filter != kFilterNone || pw <= 0 || pw > e->w) return 1;
  auto s = std::make_unique<Stripe>();
  s->index = e->next_index++;
  s->nrows = nrows;
  s->pattern_width = pw;
  s->shift.assign(shift, shift + nrows * e->w);
  s->noise.assign(noise, noise + nrows * pw * 3);
  e->rows_in += nrows;
  {
    std::lock_guard<std::mutex> lk(e->mu);
    e->queue.push_back(std::move(s));
  }
  e->cv_job.notify_one();
  return 0;
}

// Wait for all stripes, assemble the file, free the handle.
// Returns 0 on success, nonzero on error (file removed best-effort not
// attempted; caller decides).
int mepng_end(void* handle) {
  auto* e = (Encoder*)handle;
  if (!e) return 1;
  int rc = 0;
  {
    std::unique_lock<std::mutex> lk(e->mu);
    e->cv_done.wait(lk, [&] { return e->completed == e->next_index; });
    e->shutdown = true;
  }
  e->cv_job.notify_all();
  for (auto& t : e->workers) t.join();

  if (e->error || e->rows_in != e->h) rc = 2;

  if (rc == 0) {
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    uint8_t ihdr[13];
    put_be32(ihdr, (uint32_t)e->w);
    put_be32(ihdr + 4, (uint32_t)e->h);
    ihdr[8] = 8;    // bit depth
    ihdr[9] = 2;    // color type: truecolor RGB
    ihdr[10] = 0;   // compression
    ihdr[11] = 0;   // filter method
    ihdr[12] = 0;   // no interlace
    bool ok = fwrite(sig, 1, 8, e->f) == 8 && write_chunk(e->f, "IHDR", ihdr, 13);

    // zlib container: header IDAT, per-stripe IDATs, trailer IDAT with a
    // final empty deflate block (BFINAL stored, from an empty Z_FINISH
    // deflate) + the combined adler32.
    static const uint8_t zhdr[2] = {0x78, 0x9C};
    ok = ok && write_chunk(e->f, "IDAT", zhdr, 2);

    uLong adler = adler32(0L, Z_NULL, 0);
    for (auto& sp : e->done) {
      if (!sp) {
        ok = false;
        break;
      }
      ok = ok && write_chunk_crc(e->f, "IDAT", sp->compressed.data(),
                                 sp->compressed.size(), sp->crc);
      adler = adler32_combine(adler, sp->adler, (z_off_t)sp->filtered_len);
    }

    if (ok) {
      // empty raw deflate stream finished -> the stream-terminating block
      uint8_t fin[16];
      z_stream zs;
      std::memset(&zs, 0, sizeof(zs));
      deflateInit2(&zs, 1, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);
      zs.next_out = fin;
      zs.avail_out = sizeof(fin);
      deflate(&zs, Z_FINISH);
      size_t fin_len = sizeof(fin) - zs.avail_out;
      deflateEnd(&zs);
      uint8_t trailer[20];
      std::memcpy(trailer, fin, fin_len);
      put_be32(trailer + fin_len, (uint32_t)adler);
      ok = write_chunk(e->f, "IDAT", trailer, fin_len + 4) &&
           write_chunk(e->f, "IEND", nullptr, 0);
    }
    if (!ok) rc = 3;
  }

  if (std::fclose(e->f) != 0 && rc == 0) rc = 4;
  delete e;
  return rc;
}

// Abort an in-progress encode (joins workers, closes + leaves the partial
// file; caller unlinks).
void mepng_abort(void* handle) {
  auto* e = (Encoder*)handle;
  if (!e) return;
  {
    std::lock_guard<std::mutex> lk(e->mu);
    e->shutdown = true;
    e->queue.clear();
    e->completed = e->next_index;  // nothing left to wait for
  }
  e->cv_job.notify_all();
  for (auto& t : e->workers) t.join();
  std::fclose(e->f);
  delete e;
}

// One-shot convenience: encode a full image, striping internally.
int mepng_encode(const char* path, const uint8_t* rgb, int64_t w, int64_t h,
                 int level, int filter, int nthreads, int64_t stripe_rows) {
  void* e = mepng_begin(path, w, h, level, filter, nthreads);
  if (!e) return 1;
  if (stripe_rows <= 0) stripe_rows = 128;
  for (int64_t y = 0; y < h; y += stripe_rows) {
    int64_t n = std::min<int64_t>(stripe_rows, h - y);
    if (mepng_write_rows(e, rgb + y * w * 3, n) != 0) {
      mepng_abort(e);
      return 2;
    }
  }
  return mepng_end(e);
}

}  // extern "C"
