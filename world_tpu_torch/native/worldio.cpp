// Native I/O and corpus batch loader for world_tpu_torch (a copy of
// world_tpu/native/worldio.cpp; the port imports nothing of world_tpu).
//
// The reference implements its runtime (wav + parameter file I/O) in C++
// (tools/audioio.cpp, tools/parameterio.cpp); this is the host-side
// native equivalent: a C-ABI library used via ctypes that adds what
// corpus-scale feeding needs — a multithreaded loader that reads many
// wavs and packs them padded into one contiguous batch, so the host
// never bottlenecks the device.
//
// Sample scaling matches the reference exactly: read divides by
// 2^(nbit-1); write scales by 32767 with clipping.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

struct WioWav {
  double *samples;
  int64_t length;
  int32_t fs;
  int32_t nbit;
};

static int read_exact(FILE *f, void *buf, size_t n) {
  return fread(buf, 1, n, f) == n ? 1 : 0;
}

// Parses a mono integer-PCM RIFF file.  Returns 0 on success.
static int parse_wav(FILE *f, WioWav *out) {
  char tag[4];
  uint32_t u32;
  uint16_t u16;
  if (!read_exact(f, tag, 4) || memcmp(tag, "RIFF", 4)) return 1;
  if (!read_exact(f, &u32, 4)) return 1;
  if (!read_exact(f, tag, 4) || memcmp(tag, "WAVE", 4)) return 1;

  int have_fmt = 0;
  uint16_t channels = 0, nbit = 0, fmt_code = 0;
  uint32_t fs = 0;
  for (;;) {
    if (!read_exact(f, tag, 4) || !read_exact(f, &u32, 4)) return 1;
    if (!memcmp(tag, "fmt ", 4)) {
      long next = ftell(f) + u32;
      if (!read_exact(f, &fmt_code, 2) || !read_exact(f, &channels, 2))
        return 1;
      if (!read_exact(f, &fs, 4)) return 1;
      fseek(f, 6, SEEK_CUR);  // byte rate + block align
      if (!read_exact(f, &nbit, 2)) return 1;
      fseek(f, next, SEEK_SET);
      have_fmt = 1;
    } else if (!memcmp(tag, "data", 4)) {
      if (!have_fmt || fmt_code != 1 || channels != 1 || nbit % 8) return 1;
      int qbyte = nbit / 8;
      int64_t n = u32 / qbyte;
      std::vector<uint8_t> raw(u32);
      if (!read_exact(f, raw.data(), u32)) return 1;
      double *x = new double[n];
      double zero_line = static_cast<double>(1ull << (nbit - 1));
      for (int64_t i = 0; i < n; ++i) {
        const uint8_t *p = &raw[i * qbyte];
        double sign_bias = 0.0;
        uint8_t top = p[qbyte - 1];
        double tmp = top >= 128 ? (top & 0x7F) : top;
        if (top >= 128) sign_bias = zero_line;
        for (int j = qbyte - 2; j >= 0; --j) tmp = tmp * 256.0 + p[j];
        x[i] = (tmp - sign_bias) / zero_line;
      }
      out->samples = x;
      out->length = n;
      out->fs = static_cast<int32_t>(fs);
      out->nbit = nbit;
      return 0;
    } else {
      fseek(f, u32, SEEK_CUR);  // skip unknown chunk
    }
  }
}

// Returns 0 on success; caller frees with wio_free.
int wio_read_wav(const char *path, WioWav *out) {
  FILE *f = fopen(path, "rb");
  if (!f) return 2;
  int rc = parse_wav(f, out);
  fclose(f);
  return rc;
}

void wio_free(double *p) { delete[] p; }

int wio_write_wav(const char *path, const double *x, int64_t n,
                  int32_t fs) {
  FILE *f = fopen(path, "wb");
  if (!f) return 2;
  uint32_t u32;
  uint16_t u16;
  fwrite("RIFF", 1, 4, f);
  u32 = 36 + static_cast<uint32_t>(n) * 2;
  fwrite(&u32, 4, 1, f);
  fwrite("WAVEfmt ", 1, 8, f);
  u32 = 16; fwrite(&u32, 4, 1, f);
  u16 = 1; fwrite(&u16, 2, 1, f);   // PCM
  u16 = 1; fwrite(&u16, 2, 1, f);   // mono
  u32 = fs; fwrite(&u32, 4, 1, f);
  u32 = fs * 2; fwrite(&u32, 4, 1, f);
  u16 = 2; fwrite(&u16, 2, 1, f);
  u16 = 16; fwrite(&u16, 2, 1, f);
  fwrite("data", 1, 4, f);
  u32 = static_cast<uint32_t>(n) * 2;
  fwrite(&u32, 4, 1, f);
  std::vector<int16_t> pcm(n);
  for (int64_t i = 0; i < n; ++i) {
    int v = static_cast<int>(x[i] * 32767);
    if (v > 32767) v = 32767;
    if (v < -32768) v = -32768;
    pcm[i] = static_cast<int16_t>(v);
  }
  fwrite(pcm.data(), 2, n, f);
  fclose(f);
  return 0;
}

// Multithreaded batch loader: reads n_paths mono wavs (';'-joined paths),
// converts to float32, pads/truncates each into row i of out
// (n_paths x bucket_len, pre-allocated by the caller).  lengths[i]
// receives the true sample count (0 on per-file failure).  fs_out
// receives the fs of the first successful file; files with a different
// fs are treated as failures.  Returns the number of failures.
int wio_load_batch(const char *joined_paths, int32_t n_paths,
                   int64_t bucket_len, float *out, int64_t *lengths,
                   int32_t *fs_out, int32_t n_threads) {
  std::vector<std::string> paths;
  {
    const char *p = joined_paths;
    for (int i = 0; i < n_paths; ++i) {
      const char *sep = strchr(p, ';');
      size_t len = sep ? static_cast<size_t>(sep - p) : strlen(p);
      paths.emplace_back(p, len);
      p += len + (sep ? 1 : 0);
    }
  }
  std::vector<int> fail(n_paths, 0);
  std::vector<int32_t> fss(n_paths, 0);
  if (n_threads < 1) n_threads = 1;

  auto work = [&](int t) {
    for (int i = t; i < n_paths; i += n_threads) {
      WioWav w{};
      if (wio_read_wav(paths[i].c_str(), &w) != 0) {
        fail[i] = 1;
        lengths[i] = 0;
        memset(out + static_cast<int64_t>(i) * bucket_len, 0,
               bucket_len * sizeof(float));
        continue;
      }
      int64_t n = w.length < bucket_len ? w.length : bucket_len;
      float *row = out + static_cast<int64_t>(i) * bucket_len;
      for (int64_t j = 0; j < n; ++j)
        row[j] = static_cast<float>(w.samples[j]);
      memset(row + n, 0, (bucket_len - n) * sizeof(float));
      lengths[i] = w.length;
      fss[i] = w.fs;
      wio_free(w.samples);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  for (auto &th : threads) th.join();

  int32_t fs = 0;
  int failures = 0;
  for (int i = 0; i < n_paths; ++i) {
    if (fail[i]) { failures++; continue; }
    if (fs == 0) fs = fss[i];
    if (fss[i] != fs) {
      // Zero the row, as for an unreadable file (the Python loader never
      // fills it).
      fail[i] = 1;
      lengths[i] = 0;
      memset(out + static_cast<int64_t>(i) * bucket_len, 0,
             bucket_len * sizeof(float));
      failures++;
    }
  }
  *fs_out = fs;
  return failures;
}

}  // extern "C"
