// Native host transform library of the PyTorch/CUDA port: batched zstd,
// AES-256-GCM and the tpu-lzhuff-v1 sequence expander.
//
// The reference's performance-critical native code is what its JVM links
// against: zstd-jni for per-chunk compression
// (core/.../transform/CompressionChunkEnumeration.java:50-63) and the JDK's
// AES-GCM intrinsics (EncryptionChunkEnumeration.java:66-81). This library is
// the equivalent native layer for the port's host side: whole chunk batches
// cross the Python boundary once and are compressed/encrypted on threads
// the call starts, or, for the segment windows of the CUDA backend, one
// chunk at a time on the caller's own thread (ts_zstd_compress_into), which
// the caller's bounded workers schedule. Both libraries are resolved at run time with dlopen, so the
// build needs neither zstd.h nor the OpenSSL headers, and links neither:
// zstd through libzstd.so.1, AES-256-GCM through libcrypto.so.3 (or .so.1.1).
// Only the stable ABI of each is used: eight zstd functions and the two
// content-size sentinels, the EVP cipher calls and three control codes.
//
// Wire format parity with the reference:
//   compression: one zstd frame per chunk, content size pledged in the frame
//   encryption:  IV(12) || ciphertext || tag(16) per chunk, fresh IV per chunk
//
// C ABI notes: callers pass one contiguous input buffer plus per-chunk sizes,
// and one contiguous output buffer with a fixed per-chunk stride
// (worst-case-bound sized); per-chunk output sizes are returned. No memory
// ownership crosses the boundary.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <dlfcn.h>

namespace {

// ---------------------------------------------------------------------------
// libzstd runtime binding
// ---------------------------------------------------------------------------

// zstd's content-size sentinels (stable ABI values from zstd.h).
constexpr unsigned long long kZstdContentSizeUnknown = 0ULL - 1;
constexpr unsigned long long kZstdContentSizeError = 0ULL - 2;

struct ZstdApi {
  size_t (*compress_bound)(size_t);
  size_t (*compress)(void *, size_t, const void *, size_t, int);
  void *(*create_cctx)();
  size_t (*free_cctx)(void *);
  size_t (*compress_cctx)(void *, void *, size_t, const void *, size_t, int);
  size_t (*decompress)(void *, size_t, const void *, size_t);
  unsigned (*is_error)(size_t);
  unsigned long long (*frame_content_size)(const void *, size_t);
  bool ok = false;
};

const ZstdApi &zstd() {
  static ZstdApi api = [] {
    ZstdApi a{};
    void *lib = dlopen("libzstd.so.1", RTLD_NOW);
    if (lib == nullptr) return a;
    auto sym = [lib](const char *name) { return dlsym(lib, name); };
    a.compress_bound = reinterpret_cast<size_t (*)(size_t)>(sym("ZSTD_compressBound"));
    a.compress = reinterpret_cast<size_t (*)(void *, size_t, const void *, size_t, int)>(
        sym("ZSTD_compress"));
    a.create_cctx = reinterpret_cast<void *(*)()>(sym("ZSTD_createCCtx"));
    a.free_cctx = reinterpret_cast<size_t (*)(void *)>(sym("ZSTD_freeCCtx"));
    a.compress_cctx =
        reinterpret_cast<size_t (*)(void *, void *, size_t, const void *, size_t, int)>(
            sym("ZSTD_compressCCtx"));
    a.decompress = reinterpret_cast<size_t (*)(void *, size_t, const void *, size_t)>(
        sym("ZSTD_decompress"));
    a.is_error = reinterpret_cast<unsigned (*)(size_t)>(sym("ZSTD_isError"));
    a.frame_content_size = reinterpret_cast<unsigned long long (*)(const void *, size_t)>(
        sym("ZSTD_getFrameContentSize"));
    a.ok = a.compress_bound && a.compress && a.create_cctx && a.free_cctx &&
           a.compress_cctx && a.decompress && a.is_error && a.frame_content_size;
    return a;
  }();
  return api;
}

// ---------------------------------------------------------------------------
// libcrypto runtime binding (EVP AES-256-GCM)
// ---------------------------------------------------------------------------

typedef struct evp_cipher_ctx_st EVP_CIPHER_CTX;
typedef struct evp_cipher_st EVP_CIPHER;
typedef struct engine_st ENGINE;

struct CryptoApi {
  EVP_CIPHER_CTX *(*ctx_new)();
  void (*ctx_free)(EVP_CIPHER_CTX *);
  int (*ctx_ctrl)(EVP_CIPHER_CTX *, int, int, void *);
  const EVP_CIPHER *(*aes_256_gcm)();
  int (*encrypt_init)(EVP_CIPHER_CTX *, const EVP_CIPHER *, ENGINE *,
                      const unsigned char *, const unsigned char *);
  int (*encrypt_update)(EVP_CIPHER_CTX *, unsigned char *, int *,
                        const unsigned char *, int);
  int (*encrypt_final)(EVP_CIPHER_CTX *, unsigned char *, int *);
  int (*decrypt_init)(EVP_CIPHER_CTX *, const EVP_CIPHER *, ENGINE *,
                      const unsigned char *, const unsigned char *);
  int (*decrypt_update)(EVP_CIPHER_CTX *, unsigned char *, int *,
                        const unsigned char *, int);
  int (*decrypt_final)(EVP_CIPHER_CTX *, unsigned char *, int *);
  bool ok = false;
};

// Stable EVP_CIPHER_CTX_ctrl command values (openssl/evp.h ABI).
constexpr int kGcmSetIvLen = 0x9;
constexpr int kGcmGetTag = 0x10;
constexpr int kGcmSetTag = 0x11;

const CryptoApi &crypto() {
  static CryptoApi api = [] {
    CryptoApi a{};
    void *lib = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (lib == nullptr) lib = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib == nullptr) return a;
    auto sym = [lib](const char *name) { return dlsym(lib, name); };
    a.ctx_new = reinterpret_cast<EVP_CIPHER_CTX *(*)()>(sym("EVP_CIPHER_CTX_new"));
    a.ctx_free = reinterpret_cast<void (*)(EVP_CIPHER_CTX *)>(sym("EVP_CIPHER_CTX_free"));
    a.ctx_ctrl = reinterpret_cast<int (*)(EVP_CIPHER_CTX *, int, int, void *)>(
        sym("EVP_CIPHER_CTX_ctrl"));
    a.aes_256_gcm = reinterpret_cast<const EVP_CIPHER *(*)()>(sym("EVP_aes_256_gcm"));
    a.encrypt_init =
        reinterpret_cast<int (*)(EVP_CIPHER_CTX *, const EVP_CIPHER *, ENGINE *,
                                 const unsigned char *, const unsigned char *)>(
            sym("EVP_EncryptInit_ex"));
    a.encrypt_update = reinterpret_cast<int (*)(EVP_CIPHER_CTX *, unsigned char *, int *,
                                                const unsigned char *, int)>(
        sym("EVP_EncryptUpdate"));
    a.encrypt_final = reinterpret_cast<int (*)(EVP_CIPHER_CTX *, unsigned char *, int *)>(
        sym("EVP_EncryptFinal_ex"));
    a.decrypt_init =
        reinterpret_cast<int (*)(EVP_CIPHER_CTX *, const EVP_CIPHER *, ENGINE *,
                                 const unsigned char *, const unsigned char *)>(
            sym("EVP_DecryptInit_ex"));
    a.decrypt_update = reinterpret_cast<int (*)(EVP_CIPHER_CTX *, unsigned char *, int *,
                                                const unsigned char *, int)>(
        sym("EVP_DecryptUpdate"));
    a.decrypt_final = reinterpret_cast<int (*)(EVP_CIPHER_CTX *, unsigned char *, int *)>(
        sym("EVP_DecryptFinal_ex"));
    a.ok = a.ctx_new && a.ctx_free && a.ctx_ctrl && a.aes_256_gcm && a.encrypt_init &&
           a.encrypt_update && a.encrypt_final && a.decrypt_init && a.decrypt_update &&
           a.decrypt_final;
    return a;
  }();
  return api;
}

// ---------------------------------------------------------------------------
// Run fn(chunk_index) over [0, n) on up to n_threads threads started for
// this call (hardware_concurrency() of them when n_threads is 0).
// ---------------------------------------------------------------------------

template <typename Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  if (n <= 0) return;
  int workers = n_threads > 0 ? n_threads : static_cast<int>(std::thread::hardware_concurrency());
  if (workers > n) workers = n;
  if (workers <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto &th : threads) th.join();
}

// One compression context per thread, reused by every chunk the thread
// compresses and freed when the thread exits.
struct ThreadCCtx {
  void *ctx = nullptr;
  ~ThreadCCtx() {
    if (ctx != nullptr) zstd().free_cctx(ctx);
  }
};

constexpr size_t kIvSize = 12;
constexpr size_t kTagSize = 16;
// EVP_*Update takes int lengths; larger chunks must be rejected, not wrapped.
constexpr uint64_t kMaxAesChunk = 0x7FFFFFFF;

}  // namespace

extern "C" {

// Returns 1 when the AES path is usable (libcrypto resolved).
int ts_crypto_available() { return crypto().ok ? 1 : 0; }

// Returns 1 when the zstd path is usable (libzstd.so.1 resolved).
int ts_zstd_available() { return zstd().ok ? 1 : 0; }

// Worst-case compressed size for a chunk of `size` bytes (0 without libzstd).
size_t ts_zstd_bound(size_t size) {
  const ZstdApi &api = zstd();
  return api.ok ? api.compress_bound(size) : 0;
}

// Compress n chunks. Inputs are consecutive in `in` at `in_offsets[i]` with
// `in_sizes[i]`; chunk i's frame is written at out + i*out_stride, its size
// into out_sizes[i]. Returns 0 on success, 1+index of the failing chunk, or
// -1 when libzstd is unavailable.
int ts_zstd_compress_batch(const uint8_t *in, const uint64_t *in_offsets,
                           const uint64_t *in_sizes, int n, int level,
                           uint8_t *out, uint64_t out_stride,
                           uint64_t *out_sizes, int n_threads) {
  const ZstdApi &api = zstd();
  if (!api.ok) return -1;
  std::atomic<int> err{0};
  parallel_for(n, n_threads, [&](int i) {
    if (err.load(std::memory_order_relaxed) != 0) return;
    // A context per task keeps frames identical to one-shot compression
    // (content size pledged in the frame header, like the reference's
    // setPledgedSrcSize + setContentSize(true)).
    size_t written = api.compress(out + static_cast<size_t>(i) * out_stride, out_stride,
                                  in + in_offsets[i], in_sizes[i], level);
    if (api.is_error(written)) {
      int expected = 0;
      err.compare_exchange_strong(expected, 1 + i);
      return;
    }
    out_sizes[i] = written;
  });
  return err.load();
}

// Compress one chunk on the calling thread into dst (dst_cap bytes), with
// the thread's own compression context. ZSTD_compressCCtx ignores every
// parameter but the level and ZSTD_compress is it over a fresh context, so
// the frame is ZSTD_compress's byte for byte (content size in the header).
// Returns the frame's size, -1 when libzstd is unavailable, -2 when the
// compression fails.
int64_t ts_zstd_compress_into(const uint8_t *src, uint64_t size, int level,
                              uint8_t *dst, uint64_t dst_cap) {
  const ZstdApi &api = zstd();
  if (!api.ok) return -1;
  thread_local ThreadCCtx cctx;
  if (cctx.ctx == nullptr) cctx.ctx = api.create_cctx();
  if (cctx.ctx == nullptr) return -2;
  size_t written = api.compress_cctx(cctx.ctx, dst, dst_cap, src, size, level);
  if (api.is_error(written)) return -2;
  return static_cast<int64_t>(written);
}

// Decompress n zstd frames (content size must be in the frame header).
// Returns 0 on success, 1+index of the failing chunk, or -1 when libzstd is
// unavailable.
int ts_zstd_decompress_batch(const uint8_t *in, const uint64_t *in_offsets,
                             const uint64_t *in_sizes, int n, uint8_t *out,
                             uint64_t out_stride, uint64_t *out_sizes,
                             int n_threads) {
  const ZstdApi &api = zstd();
  if (!api.ok) return -1;
  std::atomic<int> err{0};
  parallel_for(n, n_threads, [&](int i) {
    if (err.load(std::memory_order_relaxed) != 0) return;
    const uint8_t *src = in + in_offsets[i];
    unsigned long long content = api.frame_content_size(src, in_sizes[i]);
    if (content == kZstdContentSizeError || content == kZstdContentSizeUnknown ||
        content > out_stride) {
      int expected = 0;
      err.compare_exchange_strong(expected, 1 + i);
      return;
    }
    size_t written = api.decompress(out + static_cast<size_t>(i) * out_stride, out_stride,
                                    src, in_sizes[i]);
    if (api.is_error(written) || written != content) {
      int expected = 0;
      err.compare_exchange_strong(expected, 1 + i);
      return;
    }
    out_sizes[i] = written;
  });
  return err.load();
}

// AES-256-GCM encrypt n chunks: out[i] = IV || ciphertext || tag at
// out + i*out_stride (out_stride >= in_sizes[i] + 28). IVs are caller-supplied
// (n * 12 bytes) so the Python layer controls IV uniqueness policy.
// Returns 0 on success, 1+i for a cipher failure on chunk i, -(2+i) when
// chunk i (or the AAD) exceeds the int length limit, -1 if libcrypto is
// unavailable.
int ts_aes_gcm_encrypt_batch(const uint8_t *key, const uint8_t *aad, uint64_t aad_len,
                             const uint8_t *ivs, const uint8_t *in,
                             const uint64_t *in_offsets, const uint64_t *in_sizes,
                             int n, uint8_t *out, uint64_t out_stride,
                             uint64_t *out_sizes, int n_threads) {
  const CryptoApi &api = crypto();
  if (!api.ok) return -1;
  std::atomic<int> err{0};
  parallel_for(n, n_threads, [&](int i) {
    if (err.load(std::memory_order_relaxed) != 0) return;
    if (in_sizes[i] > kMaxAesChunk || aad_len > kMaxAesChunk) {
      int expected = 0;
      err.compare_exchange_strong(expected, -(2 + i));
      return;
    }
    uint8_t *dst = out + static_cast<size_t>(i) * out_stride;
    const uint8_t *iv = ivs + static_cast<size_t>(i) * kIvSize;
    EVP_CIPHER_CTX *ctx = api.ctx_new();
    bool fail = ctx == nullptr;
    int len = 0;
    if (!fail) fail = api.encrypt_init(ctx, api.aes_256_gcm(), nullptr, nullptr, nullptr) != 1;
    if (!fail) fail = api.ctx_ctrl(ctx, kGcmSetIvLen, kIvSize, nullptr) != 1;
    if (!fail) fail = api.encrypt_init(ctx, nullptr, nullptr, key, iv) != 1;
    if (!fail && aad_len > 0)
      fail = api.encrypt_update(ctx, nullptr, &len, aad, static_cast<int>(aad_len)) != 1;
    std::memcpy(dst, iv, kIvSize);
    if (!fail)
      fail = api.encrypt_update(ctx, dst + kIvSize, &len, in + in_offsets[i],
                                static_cast<int>(in_sizes[i])) != 1;
    int ct_len = len;
    if (!fail) fail = api.encrypt_final(ctx, dst + kIvSize + ct_len, &len) != 1;
    ct_len += len;
    if (!fail)
      fail = api.ctx_ctrl(ctx, kGcmGetTag, kTagSize, dst + kIvSize + ct_len) != 1;
    if (ctx != nullptr) api.ctx_free(ctx);
    if (fail) {
      int expected = 0;
      err.compare_exchange_strong(expected, 1 + i);
      return;
    }
    out_sizes[i] = kIvSize + ct_len + kTagSize;
  });
  return err.load();
}

// AES-256-GCM decrypt n chunks of IV || ciphertext || tag. Returns 0 on
// success, 1+index of the first failing chunk (bad tag included), -(2+i)
// when chunk i (or the AAD) exceeds the int length limit, -1 when libcrypto
// is unavailable.
int ts_aes_gcm_decrypt_batch(const uint8_t *key, const uint8_t *aad, uint64_t aad_len,
                             const uint8_t *in, const uint64_t *in_offsets,
                             const uint64_t *in_sizes, int n, uint8_t *out,
                             uint64_t out_stride, uint64_t *out_sizes, int n_threads) {
  const CryptoApi &api = crypto();
  if (!api.ok) return -1;
  std::atomic<int> err{0};
  parallel_for(n, n_threads, [&](int i) {
    if (err.load(std::memory_order_relaxed) != 0) return;
    const uint8_t *src = in + in_offsets[i];
    if (in_sizes[i] > kMaxAesChunk || aad_len > kMaxAesChunk) {
      // Size-limit rejection, NOT an auth failure: distinct code -(2+i).
      int expected = 0;
      err.compare_exchange_strong(expected, -(2 + i));
      return;
    }
    if (in_sizes[i] < kIvSize + kTagSize) {
      int expected = 0;
      err.compare_exchange_strong(expected, 1 + i);
      return;
    }
    const uint8_t *iv = src;
    const uint8_t *ct = src + kIvSize;
    size_t ct_len = in_sizes[i] - kIvSize - kTagSize;
    uint8_t tag[kTagSize];
    std::memcpy(tag, src + in_sizes[i] - kTagSize, kTagSize);
    uint8_t *dst = out + static_cast<size_t>(i) * out_stride;
    EVP_CIPHER_CTX *ctx = api.ctx_new();
    bool fail = ctx == nullptr;
    int len = 0;
    if (!fail) fail = api.decrypt_init(ctx, api.aes_256_gcm(), nullptr, nullptr, nullptr) != 1;
    if (!fail) fail = api.ctx_ctrl(ctx, kGcmSetIvLen, kIvSize, nullptr) != 1;
    if (!fail) fail = api.decrypt_init(ctx, nullptr, nullptr, key, iv) != 1;
    if (!fail && aad_len > 0)
      fail = api.decrypt_update(ctx, nullptr, &len, aad, static_cast<int>(aad_len)) != 1;
    if (!fail)
      fail = api.decrypt_update(ctx, dst, &len, ct, static_cast<int>(ct_len)) != 1;
    int pt_len = len;
    if (!fail) fail = api.ctx_ctrl(ctx, kGcmSetTag, kTagSize, tag) != 1;
    if (!fail) fail = api.decrypt_final(ctx, dst + pt_len, &len) != 1;  // tag check
    pt_len += len;
    if (ctx != nullptr) api.ctx_free(ctx);
    if (fail) {
      int expected = 0;
      err.compare_exchange_strong(expected, 1 + i);
      return;
    }
    out_sizes[i] = pt_len;
  });
  return err.load();
}

// Expand one tpu-lzhuff-v1 sequence stream (transform/lzhuff.py): n_seq
// records of <lit_len u16, match_len u16, offset u16>, literals consumed
// from `lits`. Offset 0 on a match repeats the previous match's offset
// (the rep-offset sentinel); offsets may be smaller than the match length
// (overlapped copy — how runs encode). Returns 0 on success; 1 = literal
// overflow, 2 = match outside the decoded prefix, 3 = totals mismatch.
// The role the reference's zstd-jni native decode path plays, for this
// build's codec.
int ts_lz_expand(const uint16_t* seqs, int n_seq,
                 const uint8_t* lits, uint64_t lit_total,
                 uint8_t* out, uint64_t out_len) {
  // The Python caller serializes sequences as numpy '<u2' (explicit
  // little-endian); decode byte-wise so this expander and the numpy
  // fallback agree on any host endianness.
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(seqs);
  const auto u16le = [sb](uint64_t idx) -> uint64_t {
    return static_cast<uint64_t>(sb[2 * idx]) |
           (static_cast<uint64_t>(sb[2 * idx + 1]) << 8);
  };
  uint64_t o = 0, lp = 0, last_d = 0;
  for (int i = 0; i < n_seq; ++i) {
    const uint64_t base = 3ull * static_cast<uint64_t>(i);
    const uint64_t lit = u16le(base);
    const uint64_t m = u16le(base + 1);
    uint64_t d = u16le(base + 2);
    if (lit) {
      if (lp + lit > lit_total || o + lit > out_len) return 1;
      std::memcpy(out + o, lits + lp, lit);
      o += lit;
      lp += lit;
    }
    if (m) {
      if (d == 0) d = last_d;  // repeat-offset sentinel
      last_d = d;
      if (d < 1 || d > o || o + m > out_len) return 2;
      if (d >= m) {
        std::memcpy(out + o, out + o - d, m);
      } else {
        uint8_t* dst = out + o;
        const uint8_t* src = out + o - d;
        for (uint64_t j = 0; j < m; ++j) dst[j] = src[j];
      }
      o += m;
    }
  }
  if (o != out_len || lp != lit_total) return 3;
  return 0;
}

}  // extern "C"
