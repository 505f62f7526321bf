// Lane-serial WavPack decode: entropy words -> decorrelation -> joint
// stereo, mute check and block CRC, one thread per block ("lane").
//
// Every lane is sample-serial (each word's bit position depends on the
// previous word), so the kernel walks a whole block inside one thread with
// the bit cursor, medians, hybrid state, decorrelation weights and history
// held per thread. Blocks are independent, which is where the parallelism
// comes from.
//
// The semantics are those of the XLA scans, step for step and in int64
// arithmetic: ops/entropy.py (entropy_decode), ops/decorr.py
// (decorr_decode) and ops/post.py (joint_mute_crc). Medians wrap exactly
// as there.
//
// This one file is compiled twice: by nvcc for CUDA (one thread per lane)
// and by a host C++ compiler for the CPU (a loop over lanes), which is how
// the CPU tests reach the kernel's arithmetic. ops/lanes.py builds and
// registers both as XLA FFI targets.

#include <cstdint>

#include "xla/ffi/api/ffi.h"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WV_FN __device__ __forceinline__
#else
#define WV_FN static inline
#endif

namespace ffi = xla::ffi;

typedef int64_t i64;
typedef uint64_t u64;
typedef int32_t i32;
typedef uint32_t u32;

// columns of the per-lane int64 parameter matrix (ops/lanes.py packs it)
enum {
  P_NSAMPLES = 0,
  P_MED = 1,      // [2][3] medians
  P_SLOW = 7,     // [2]
  P_ACC = 9,      // [2]
  P_DELTA = 11,   // [2] bitrate deltas
  P_NTERMS = 13,
  P_JOINT = 14,
  P_MUTE_LIMIT = 15,
  P_BROKE = 16,   // entropy EOF flag (residual input only)
  P_TERMS = 17,   // [16]
  P_DELTAS = 33,  // [16]
  P_WA = 49,      // [16]
  P_WB = 65,      // [16]
  NPARAM = 81,
};

enum { MAX_NTERMS = 16, LIMIT_ONES = 16, SLS = 8, SLO = 1 << (SLS - 1) };

struct Args {
  const u32* words;  // (L, W) bitstreams, or nullptr with residual input
  i64 nwords;
  const i32* res;    // (T, L, C) residuals, or nullptr with word input
  const i64* params; // (L, NPARAM)
  const i32* hist;   // (L, 2, 16, 8) decorrelation history
  const i32* log2t;  // 256-entry tables (tables.py)
  const i32* exp2t;
  i32* out;          // (T, L, C)
  i32* crc;          // (L,)
  i32* mute;         // (L,)
  i64 L, T;
  bool hybrid, hybrid_bitrate, hybrid_balance;
};

// ---- integer helpers with the XLA scans' int64 / int32-wrap semantics ----

WV_FN i64 wrap32(i64 x) { return (i64)(i32)(u32)(u64)x; }
WV_FN i64 shl(i64 x, i64 n) { return (i64)((u64)x << n); }
WV_FN i64 clip(i64 x, i64 lo, i64 hi) { return x < lo ? lo : (x > hi ? hi : x); }
WV_FN i64 imin(i64 a, i64 b) { return a < b ? a : b; }

WV_FN i64 clz64(u64 x) {
#ifdef __CUDACC__
  return __clzll((long long)x);
#else
  return x ? __builtin_clzll(x) : 64;
#endif
}

WV_FN i64 bit_length(i64 x) { return 64 - clz64((u64)x); }

WV_FN i64 trailing_ones(u64 win) {
  u64 y = ~win;
  if (y == 0) return 64;
#ifdef __CUDACC__
  return __ffsll((long long)y) - 1;
#else
  return __builtin_ctzll(y);
#endif
}

WV_FN i64 bits_of(u64 win, i64 n) {
  n = clip(n, 0, 63);
  return (i64)(win & ((1ull << n) - 1ull));
}

// >= 33 low bits of the stream from bitpos (bitio.peek: the cursor clamps
// to the last word, and the word after the last reads as the EOF fill)
WV_FN u64 peek(const u32* w, i64 nw, i64 bitpos) {
  i64 bp = imin(bitpos, (nw - 1) * 32);
  i64 idx = bp >> 5;
  u64 lo = w[idx];
  u64 hi = idx + 1 < nw ? (u64)w[idx + 1] : 0xFFFFFFFFull;
  return (lo | (hi << 32)) >> (bp & 31);
}

WV_FN i64 exp2s(const i32* exp2t, i64 log) {
  bool neg = log < 0;
  i64 a = neg ? (i64)(0 - (u64)log) : log;
  i64 v = (i64)(exp2t[a & 0xFF] | 0x100);
  i64 sh = a >> 8;
  i64 r = sh <= 9 ? v >> clip(9 - sh, 0, 63)
                  : wrap32(shl(v, clip(sh - 9, 0, 63)));
  return neg ? -r : r;
}

WV_FN i64 mylog2(const i32* log2t, i64 av) {
  av = av + (av >> 9);
  i64 dbits = av > 0 ? bit_length(av) : 0;
  i64 sh = dbits - 9;
  i64 idx = (sh >= 0 ? av >> sh : shl(av, -sh)) & 0xFF;
  return shl(dbits, 8) + log2t[idx];
}

WV_FN i64 slow_decay(i64 s) { return s - ((s + SLO) >> SLS); }

// ---- entropy: one get_words iteration (ops/entropy.py decode_word) ----

struct Entropy {
  i64 bitpos;
  i64 med[2][3];
  i64 slow[2], acc[2], errlim[2], delta[2];
  i64 zacc;
  bool h1, h0, done;
};

// Elias-gamma style count (zero runs and the LIMIT_ONES escape). Returns
// false on the 33-ones break.
WV_FN bool read_gamma(const u32* w, i64 nw, i64 pos, i64* value,
                      i64* consume) {
  i64 cbits = imin(trailing_ones(peek(w, nw, pos)), 33);
  if (cbits >= 33) return false;
  i64 data = bits_of(peek(w, nw, pos + cbits + 1), cbits - 1);
  *value = cbits < 2 ? cbits : (data | shl(1, clip(cbits - 1, 0, 62)));
  *consume = cbits < 2 ? cbits + 1 : 2 * cbits;
  return true;
}

WV_FN void update_error_limit(const Args& a, Entropy& e, bool mono) {
  i64 acc_a = e.acc[0] + e.delta[0];
  i64 br0 = wrap32(acc_a >> 16);
  i64 sl0 = (e.slow[0] + SLO) >> SLS;
  if (mono) {
    i64 e0;
    if (a.hybrid_bitrate)
      e0 = sl0 - br0 > -0x100 ? exp2s(a.exp2t, sl0 - br0 + 0x100) : 0;
    else
      e0 = exp2s(a.exp2t, br0);
    e.acc[0] = acc_a;
    e.errlim[0] = e0;
    return;
  }
  i64 acc_b = e.acc[1] + e.delta[1];
  i64 br1 = wrap32(acc_b >> 16);
  i64 e0, e1;
  if (a.hybrid_bitrate) {
    i64 sl1 = (e.slow[1] + SLO) >> SLS;
    if (a.hybrid_balance) {
      i64 balance = (sl1 - sl0 + br1 + 1) >> 1;
      bool hi = balance > br0, lo = -balance > br0;
      i64 b1 = hi ? br0 * 2 : (lo ? 0 : br0 + balance);
      i64 b0 = hi ? 0 : (lo ? br0 * 2 : br0 - balance);
      br0 = b0;
      br1 = b1;
    }
    e0 = sl0 - br0 > -0x100 ? exp2s(a.exp2t, sl0 - br0 + 0x100) : 0;
    e1 = sl1 - br1 > -0x100 ? exp2s(a.exp2t, sl1 - br1 + 0x100) : 0;
  } else {
    e0 = exp2s(a.exp2t, br0);
    e1 = exp2s(a.exp2t, br1);
  }
  e.acc[0] = acc_a;
  e.acc[1] = acc_b;
  e.errlim[0] = e0;
  e.errlim[1] = e1;
}

template <bool MONO>
WV_FN i32 decode_word(const Args& a, Entropy& e, int c, const u32* w) {
  const i64 nw = a.nwords;
  if (e.done) return 0;

  // zero-run branch (WordsUtils.cs:304-352)
  bool zcond = (e.med[0][0] & ~1LL) == 0 && (e.med[1][0] & ~1LL) == 0 &&
               !e.h1 && !e.h0;
  bool consumed_zero = false, run_started = false;
  if (zcond && e.zacc > 0) {
    e.zacc -= 1;
    consumed_zero = e.zacc > 0;
  } else if (zcond) {
    i64 z, consume;
    if (!read_gamma(w, nw, e.bitpos, &z, &consume)) {
      e.done = true;
      return 0;
    }
    e.bitpos += consume;
    if (z > 0) {
      run_started = true;
      e.zacc = z;
    }
  }
  if (consumed_zero || run_started) {
    e.slow[c] = slow_decay(e.slow[c]);
    if (run_started)
      for (int k = 0; k < 3; k++) e.med[0][k] = e.med[1][k] = 0;
    return 0;
  }

  // unary ones count with the holding carry (WordsUtils.cs:354-428)
  i64 oc;
  if (e.h0) {
    oc = 0;
    e.h1 = e.h0 = false;
  } else {
    i64 t_u = trailing_ones(peek(w, nw, e.bitpos));
    i64 raw, consume;
    if (t_u >= LIMIT_ONES + 1) {
      e.done = true;
      return 0;
    }
    if (t_u == LIMIT_ONES) {
      i64 ev, econsume;
      if (!read_gamma(w, nw, e.bitpos + 17, &ev, &econsume)) {
        e.done = true;
        return 0;
      }
      raw = ev + LIMIT_ONES;
      consume = 17 + econsume;
    } else {
      raw = t_u;
      consume = t_u + 1;
    }
    e.bitpos += consume;
    oc = e.h1 ? (raw >> 1) + 1 : raw >> 1;
    e.h1 = (raw & 1) != 0;
    e.h0 = !e.h1;
  }

  // hybrid error limit, updated before channel-A words (WordsUtils.cs:430)
  if (a.hybrid && c == 0) update_error_limit(a, e, MONO);

  // median interval (WordsUtils.cs:433-475)
  i64* m = e.med[c];
  i64 m0 = m[0], m1 = m[1], m2 = m[2];
  i64 g0 = (m0 >> 4) + 1, g1 = (m1 >> 4) + 1, g2 = (m2 >> 4) + 1;
  i64 low, width;
  if (oc == 0) {
    low = 0;
    width = g0;
    m[0] = wrap32(m0 - ((m0 + (128 - 2)) >> 7) * 2);
  } else {
    m[0] = wrap32(m0 + ((m0 + 128) >> 7) * 5);
    if (oc == 1) {
      low = g0;
      width = g1;
      m[1] = wrap32(m1 - ((m1 + (64 - 2)) >> 6) * 2);
    } else {
      m[1] = wrap32(m1 + ((m1 + 64) >> 6) * 5);
      low = oc == 2 ? g0 + g1 : g0 + g1 + (oc - 2) * g2;
      width = g2;
      m[2] = oc == 2 ? wrap32(m2 - ((m2 + (32 - 2)) >> 5) * 2)
                     : wrap32(m2 + ((m2 + 32) >> 5) * 5);
    }
  }
  i64 high = low + width - 1;

  // value: read_code, or the hybrid error-limit binary search
  u64 win = peek(w, nw, e.bitpos);
  i64 err = a.hybrid ? e.errlim[c] : 0;
  i64 mid, consume;
  if (err == 0) {
    i64 maxcode = high - low;
    i64 bitcount = maxcode > 0 ? bit_length(maxcode) : 0;
    // C# `1 << bitcount` is an int shift (mod 32), WordsUtils.cs:549
    i64 extras = wrap32(shl(1, bitcount & 31)) - maxcode - 1;
    i64 code = bits_of(win, bitcount - 1);
    bool need_extra = bitcount > 0 && code >= extras;
    if (need_extra)
      code = shl(code, 1) - extras +
             bits_of(win >> clip(bitcount - 1, 0, 62), 1);
    mid = low + code;
    consume = bitcount == 0 ? 0 : bitcount - 1 + (need_extra ? 1 : 0);
  } else {
    i64 lo = low, hi = high;
    mid = (high + low + 1) >> 1;
    consume = 0;
    for (int k = 0; k < 32 && hi - lo > err; k++) {
      if ((win >> consume) & 1)
        lo = mid;
      else
        hi = mid - 1;
      mid = (hi + lo + 1) >> 1;
      consume++;
    }
  }
  bool sign = ((win >> clip(consume, 0, 62)) & 1) != 0;
  e.bitpos += consume + 1;
  if (a.hybrid_bitrate) e.slow[c] = slow_decay(e.slow[c]) + mylog2(a.log2t, mid);
  return (i32)wrap32(sign ? ~mid : mid);
}

// ---- decorrelation: every pass for one sample (ops/decorr.py) ----

WV_FN i64 pred(i64 w, i64 sam) {
  return (i64)((u64)w * (u64)sam + 512ull) >> 10;
}

WV_FN i64 upd(i64 w, i64 d, i64 sam, i64 v) {
  if (sam == 0 || v == 0) return w;
  return (sam ^ v) < 0 ? w - d : w + d;
}

WV_FN i64 upd_clamp(i64 w, i64 d, i64 sam, i64 v) {
  if (sam == 0 || v == 0) return w;
  if ((sam ^ v) < 0) return w - d < -1024 ? -1024 : w - d;
  return w + d > 1024 ? 1024 : w + d;
}

struct Decorr {
  i64 term[MAX_NTERMS], delta[MAX_NTERMS];
  i64 wa[MAX_NTERMS], wb[MAX_NTERMS];
  i32 ha[MAX_NTERMS][8], hb[MAX_NTERMS][8];
  int nterms;
};

WV_FN i64 ring_sample(const i32* r, i64 term, int m) {
  if (term == 17) return wrap32(2 * (i64)r[0] - r[1]);
  if (term == 18) return wrap32(3 * (i64)r[0] - r[1]) >> 1;
  if (term >= 1 && term <= 8) return r[m];
  return r[0];
}

WV_FN void ring_store(i32* r, i64 term, int m, i64 v) {
  if (term >= 1 && term <= 8) {
    r[(m + term) & 7] = (i32)v;
  } else if (term == 17 || term == 18) {
    r[1] = r[0];
    r[0] = (i32)v;
  }
}

WV_FN void decorr_stereo(Decorr& d, int m, i64* va, i64* vb) {
  for (int j = 0; j < d.nterms; j++) {
    const i64 term = d.term[j], dj = d.delta[j];
    i32* ra = d.ha[j];
    i32* rb = d.hb[j];
    i64 oa, ob, sam_a, sam_b;
    if (term == -2) {
      sam_b = rb[0];
      ob = wrap32(pred(d.wb[j], sam_b) + *vb);
      sam_a = ob;
      oa = wrap32(pred(d.wa[j], sam_a) + *va);
    } else {
      sam_a = ring_sample(ra, term, m);
      oa = wrap32(pred(d.wa[j], sam_a) + *va);
      sam_b = term == -1 ? oa : ring_sample(rb, term, m);
      ob = wrap32(pred(d.wb[j], sam_b) + *vb);
    }
    if (term == -1 || term == -2 || term == -3) {
      d.wa[j] = upd_clamp(d.wa[j], dj, sam_a, *va);
      d.wb[j] = upd_clamp(d.wb[j], dj, sam_b, *vb);
      if (term != -2) ra[0] = (i32)ob;
      if (term != -1) rb[0] = (i32)oa;
    } else {
      d.wa[j] = upd(d.wa[j], dj, sam_a, *va);
      d.wb[j] = upd(d.wb[j], dj, sam_b, *vb);
      ring_store(ra, term, m, oa);
      ring_store(rb, term, m, ob);
    }
    *va = oa;
    *vb = ob;
  }
}

WV_FN void decorr_mono(Decorr& d, int m, i64* va) {
  for (int j = 0; j < d.nterms; j++) {
    const i64 term = d.term[j];
    i32* ra = d.ha[j];
    i64 sam = ring_sample(ra, term, m);
    i64 oa = wrap32(pred(d.wa[j], sam) + *va);
    d.wa[j] = upd(d.wa[j], d.delta[j], sam, *va);
    ring_store(ra, term, m, oa);
    *va = oa;
  }
}

// C# unchecked abs on an int32 value
WV_FN i64 cabs(i64 v) { return v < 0 ? wrap32(-v) : v; }

// ---- one lane, start to end ----

template <bool MONO>
WV_FN void decode_lane(const Args& a, i64 lane) {
  const int C = MONO ? 1 : 2;
  const i64* p = a.params + lane * NPARAM;
  const i64 L = a.L, T = a.T;
  const u32* w = a.words ? a.words + lane * a.nwords : nullptr;

  Entropy e;
  e.bitpos = 0;
  for (int c = 0; c < 2; c++) {
    for (int k = 0; k < 3; k++) e.med[c][k] = p[P_MED + 3 * c + k];
    e.slow[c] = p[P_SLOW + c];
    e.acc[c] = p[P_ACC + c];
    e.delta[c] = p[P_DELTA + c];
    e.errlim[c] = 0;
  }
  e.zacc = 0;
  e.h1 = e.h0 = false;
  e.done = a.words ? false : p[P_BROKE] != 0;

  Decorr d;
  d.nterms = (int)clip(p[P_NTERMS], 0, MAX_NTERMS);
  const i32* hist = a.hist + lane * (2 * MAX_NTERMS * 8);
  for (int j = 0; j < MAX_NTERMS; j++) {
    d.term[j] = p[P_TERMS + j];
    d.delta[j] = p[P_DELTAS + j];
    d.wa[j] = p[P_WA + j];
    d.wb[j] = p[P_WB + j];
    for (int k = 0; k < 8; k++) {
      d.ha[j][k] = hist[j * 8 + k];
      d.hb[j][k] = hist[MAX_NTERMS * 8 + j * 8 + k];
    }
  }

  const bool joint = p[P_JOINT] != 0;
  const i64 mute_limit = p[P_MUTE_LIMIT];
  const i64 ns = imin(p[P_NSAMPLES], T);
  u32 crc = 0xFFFFFFFFu;
  bool bad = false;
  i64 t = 0;
  for (; t < ns; t++) {
    i64 va, vb = 0;
    const i64 o = (t * L + lane) * C;
    if (w) {
      va = decode_word<MONO>(a, e, 0, w);
      if (!MONO) vb = decode_word<MONO>(a, e, 1, w);
    } else {
      va = a.res[o];
      if (!MONO) vb = a.res[o + 1];
    }
    if (MONO) {
      decorr_mono(d, (int)(t & 7), &va);
      if (cabs(va) > mute_limit) {
        bad = true;
        break;
      }
      crc = crc * 3u + (u32)va;
      a.out[o] = (i32)va;
    } else {
      decorr_stereo(d, (int)(t & 7), &va, &vb);
      i64 l = va, r = vb;
      if (joint) {
        r = wrap32(vb - (va >> 1));
        l = wrap32(va + r);
      }
      if (cabs(l) > mute_limit || cabs(r) > mute_limit) {
        bad = true;
        break;
      }
      crc = crc * 9u + (u32)(u64)(l * 3 + r);
      a.out[o] = (i32)l;
      a.out[o + 1] = (i32)r;
    }
  }
  const bool mute = bad || e.done;
  for (i64 z = mute ? 0 : t; z < T; z++)
    for (int c = 0; c < C; c++) a.out[(z * L + lane) * C + c] = 0;
  a.crc[lane] = (i32)crc;
  a.mute[lane] = mute ? 1 : 0;
}

// ---- launch: CUDA threads on the XLA stream, or a host loop ----

#ifdef __CUDACC__
template <bool MONO>
__global__ void lanes_kernel(Args a) {
  i64 lane = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.L) decode_lane<MONO>(a, lane);
}

typedef cudaStream_t Stream;
#define WV_STREAM_PARAM cudaStream_t stream,
#define WV_BIND ffi::Ffi::Bind().Ctx<ffi::PlatformStream<cudaStream_t>>()
#else
typedef int Stream;
#define WV_STREAM_PARAM
#define WV_BIND ffi::Ffi::Bind()
static const Stream stream = 0;
#endif

static const int THREADS_PER_BLOCK = 64;

static ffi::Error launch(Stream strm, const Args& a, bool mono) {
  if (a.L == 0) return ffi::Error::Success();
#ifdef __CUDACC__
  dim3 grid((unsigned)((a.L + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK));
  if (mono)
    lanes_kernel<true><<<grid, THREADS_PER_BLOCK, 0, strm>>>(a);
  else
    lanes_kernel<false><<<grid, THREADS_PER_BLOCK, 0, strm>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
#else
  (void)strm;
  for (i64 lane = 0; lane < a.L; lane++) {
    if (mono)
      decode_lane<true>(a, lane);
    else
      decode_lane<false>(a, lane);
  }
#endif
  return ffi::Error::Success();
}

static Args make_args(ffi::Buffer<ffi::S64> params, ffi::Buffer<ffi::S32> hist,
                      ffi::Buffer<ffi::S32> tables,
                      ffi::ResultBuffer<ffi::S32> out,
                      ffi::ResultBuffer<ffi::S32> crc,
                      ffi::ResultBuffer<ffi::S32> mute) {
  Args a = {};
  a.params = params.typed_data();
  a.hist = hist.typed_data();
  a.log2t = tables.typed_data();
  a.exp2t = tables.typed_data() + 256;
  a.out = out->typed_data();
  a.crc = crc->typed_data();
  a.mute = mute->typed_data();
  a.L = (i64)params.dimensions()[0];
  a.T = (i64)out->dimensions()[0];
  return a;
}

// bitstreams (L, W) -> samples, CRC, mute
static ffi::Error DecodeImpl(WV_STREAM_PARAM ffi::Buffer<ffi::U32> words,
                             ffi::Buffer<ffi::S64> params,
                             ffi::Buffer<ffi::S32> hist,
                             ffi::Buffer<ffi::S32> tables,
                             ffi::ResultBuffer<ffi::S32> out,
                             ffi::ResultBuffer<ffi::S32> crc,
                             ffi::ResultBuffer<ffi::S32> mute, bool mono,
                             bool hybrid, bool hybrid_bitrate,
                             bool hybrid_balance) {
  Args a = make_args(params, hist, tables, out, crc, mute);
  a.words = words.typed_data();
  a.nwords = (i64)words.dimensions()[1];
  a.hybrid = hybrid;
  a.hybrid_bitrate = hybrid_bitrate;
  a.hybrid_balance = hybrid_balance;
  return launch(stream, a, mono);
}

// TEST-ONLY entry: residuals (T, L, C) -> samples, CRC, mute, the
// decorrelation and post stages alone. No decode path calls it; the tests
// use it (through ops/lanes.py::decorr_post) to drive those stages with
// arbitrary weights, histories and residuals that no encoder emits.
static ffi::Error DecorrImpl(WV_STREAM_PARAM ffi::Buffer<ffi::S32> res,
                             ffi::Buffer<ffi::S64> params,
                             ffi::Buffer<ffi::S32> hist,
                             ffi::Buffer<ffi::S32> tables,
                             ffi::ResultBuffer<ffi::S32> out,
                             ffi::ResultBuffer<ffi::S32> crc,
                             ffi::ResultBuffer<ffi::S32> mute, bool mono) {
  Args a = make_args(params, hist, tables, out, crc, mute);
  a.res = res.typed_data();
  return launch(stream, a, mono);
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(WvpkLanesDecode, DecodeImpl,
                              WV_BIND.Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S64>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<bool>("mono")
                                  .Attr<bool>("hybrid")
                                  .Attr<bool>("hybrid_bitrate")
                                  .Attr<bool>("hybrid_balance"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(WvpkLanesDecorr, DecorrImpl,
                              WV_BIND.Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S64>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<bool>("mono"));
