// Copied from libhm_tpu/hostdec/native/encctu.cpp
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <limits>
#include <utility>
#include <vector>

// Native CU/mode RD orchestration: the per-CTU compress pass of the
// encoder (encoder.py encode_cqt and everything below it), ported 1:1 so
// the emitted CABAC op stream is byte-identical to the Python reference
// implementation.  Reference anchor: TEncCu::xCompressCU
// (/root/reference/source/Lib/TLibEncoder/TEncCu.cpp:363-680) and
// TEncSearch (estIntraPredQT, predInterSearch, xEstimateInterResidualQT).
//
// Shares the live Python context-bank arrays (int32, state = 2*pState+MPS)
// exactly like rdoq.cpp; decisions record (context, idx, value, pre-state)
// ops with trial-coder semantics: recording adapts the shared state, ops
// are priced at their pre-adaptation states, truncate() rolls states back
// and reinstate() re-advances them (encoder.py _RecordingCabac).
//
// Compiled into libhevcdec.so via api.cpp (after rdoq.cpp, whose
// residualBits / EstBits / scanOrder and the enc_tu_fwd kernel it reuses).

namespace hevc {
namespace encctu {

using rdoq::kFrac;
using rdoq::kEst;
using rdoq::kGroupIdx;
using rdoq::kMinInGroup;
using rdoq::scanOrder;

// context-bank set ids — MUST match encoder.py _NATIVE_BANK_KEYS order
enum BankSet {
  B_TQB = 0, B_SPLIT, B_SKIP, B_MERGE_FLAG, B_MERGE_IDX, B_PART,
  B_PREDMODE, B_MPM, B_CHROMA_MODE, B_INTER_DIR, B_MVD, B_REF_IDX, B_DQP,
  B_QT_CBF, B_ROOT_CBF, B_SIG_CG, B_SIG, B_GT1, B_GT2, B_MVP, B_SUBDIV,
  B_TSKIP, B_LAST_X, B_LAST_Y, NSETS
};

enum { OP_B = 0, OP_P = 1, OP_PN = 2, OP_EG = 3, OP_T = 4 };

enum { MODE_INTER = 0, MODE_INTRA = 1 };
enum { SIZE_2Nx2N = 0, SIZE_2NxN = 1, SIZE_Nx2N = 2, SIZE_NxN = 3,
       SIZE_2NxnU = 4, SIZE_2NxnD = 5, SIZE_nLx2N = 6, SIZE_nRx2N = 7 };
enum { EDGE_TU_LEFT = 1, EDGE_TU_TOP = 2, EDGE_PU_LEFT = 4, EDGE_PU_TOP = 8,
       EDGE_CU_LEFT = 16, EDGE_CU_TOP = 32 };
enum { SCAN_DIAG = 0, SCAN_HOR = 1, SCAN_VER = 2 };
enum { PLANAR_IDX = 0, DC_IDX = 1, HOR_IDX = 10, VER_IDX = 26 };

static const int kChroma422AngleMap[35] = {
    0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20,
    21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31};

static const int kAngTable[35] = {0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2,
                                  -5, -9, -13, -17, -21, -26, -32, -26, -21,
                                  -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17,
                                  21, 26, 32};

static inline int invAngleOf(int ang) {
  switch (ang) {
    case -2: return 4096;
    case -5: return 1638;
    case -9: return 910;
    case -13: return 630;
    case -17: return 482;
    case -21: return 390;
    case -26: return 315;
    default: return 256;  // -32
  }
}

static inline int bitLength(unsigned long long v) {
  int n = 0;
  while (v) { n++; v >>= 1; }
  return n;
}

// ---------------------------------------------------------------------------
// recording trial coder (encoder.py _RecordingCabac)
// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// lightweight phase profiler (HEVC_ENC_PROF=1): coarse per-phase wall time
// accumulated across the picture, printed at enc_ctu_destroy
// ---------------------------------------------------------------------------
namespace prof {
enum { P_ME = 0, P_TUFWD, P_RESBITS, P_INTRAPRED, P_INTERPRED, P_EMIT,
       P_SNAP, P_N };
static const char* kNames[P_N] = {"motion-search", "tu-fwd",
                                  "residual-bits", "intra-pred",
                                  "inter-pred", "residual-emit",
                                  "cu-snapshots"};
static double acc[P_N];
static long cnt[P_N];
static bool on() {
  static int v = -1;
  if (v < 0) { const char* e = getenv("HEVC_ENC_PROF"); v = e && *e == '1'; }
  return v;
}
struct Scope {
  int i;
  std::chrono::steady_clock::time_point t0;
  bool act;
  explicit Scope(int idx) : i(idx), act(on()) {
    if (act) t0 = std::chrono::steady_clock::now();
  }
  ~Scope() {
    if (act) {
      acc[i] += std::chrono::duration<double>(
          std::chrono::steady_clock::now() - t0).count();
      cnt[i]++;
    }
  }
};
static void dump() {
  if (!on()) return;
  for (int i = 0; i < P_N; i++)
    if (cnt[i])
      fprintf(stderr, "[encprof] %-14s %8.3fs  x%ld\n", kNames[i], acc[i],
              cnt[i]);
}
}  // namespace prof

struct Ops {
  std::vector<uint8_t> kind;
  std::vector<int32_t> a;    // OP_B: (set<<8)|idx; OP_PN: n; OP_EG: k
  std::vector<int32_t> b;    // value
  std::vector<uint8_t> pre;  // OP_B: pre-adaptation state
  size_t size() const { return kind.size(); }
};

struct OpsSlice {
  std::vector<uint8_t> kind;
  std::vector<int32_t> a, b;
  std::vector<uint8_t> pre;
};

struct PartTrial;  // fwd (inter)

struct Ctx {
  // --- config ---
  int width, height, bd, cfmt;
  int log2Ctb, log2MinCb, log2MinTb, log2MaxTb;
  int maxTrIntra, maxTrInter;
  int ampEnabled, strongSmoothing, smoothingDisabled;
  int sdh, rdoqOn, tsEnabled;
  int sliceType, qp;
  int numRef[2], maxMerge, searchRange, fastSearch;
  int mvdL1Zero = 0, fastEnc = 0;
  int tmvp, colFromL0, colRefIdx, poc;
  int rdoCu, cuSizeTarget, intraRdCands, rdParts, rdUni;
  int w4, h4, nctbX;
  int allRefsBefore;
  int log2ParMrg;
  double rdLambda, lamMotion, lamPred, cw[3];

  // --- map pointers (4x4 granularity, row stride w4) ---
  int8_t *depth, *predMode, *partSize, *skip, *pcm, *intraY, *intraC,
      *chromaDm, *qpMap, *cbfY, *interDir, *refIdx, *refIsLt;
  uint8_t *edgeFlags;
  int32_t *mv, *refPocM, *sliceIdx;
  int64_t *zmap;
  int32_t *tileMap;

  // --- planes (int32, stride = planeW[c]) ---
  int32_t *orig[3], *recon[3];
  int planeW[3], planeH[3];
  int compW[3], compH[3];  // true component dims (sps.width >> ssx, ...)

  int32_t *bank[NSETS];
  const int32_t *nextMps, *nextLps;

  // --- scaling lists (encoder.py _scaling_matrix; sizeIdx = log2n-2,
  // listIdx = (0 if intra else 3) + comp) ---
  const int32_t* scalMat[4][6] = {};
  bool scalOn = false;

  // --- weighted prediction (slice WP tables; encoder.py cur_wp/_l1) ---
  struct WpEntry {
    int w[3] = {0, 0, 0};
    int o[3] = {0, 0, 0};
    int denom = 0;
    bool flag = false;
  };
  WpEntry wpTab[2][16];
  bool wpOn = false;
  const WpEntry* wpOf(int l, int r) const {
    if (!wpOn) return nullptr;
    const WpEntry& e = wpTab[l][r < 0 ? 0 : (r > 15 ? 15 : r)];
    return e.flag ? &e : nullptr;
  }

  // --- reference pictures (inter) ---
  struct Ref {
    const int16_t* plane[3];  // unpadded int16 copies, stride compW
    const int16_t* padded;    // luma edge-padded (pad = R + 8) for ME
    int padW, padH;
    int planeId;              // dedup id (same picture in both lists)
    int poc, isLt;
  };
  std::vector<Ref> refs[2];
  int colList() const { return 1 - colFromL0; }

  // --- collocated picture syntax maps (TMVP) ---
  struct Col {
    bool valid = false;
    const int8_t *predMode = nullptr, *refIsLt = nullptr;
    const int8_t *interDir = nullptr;
    const int32_t *mv = nullptr, *refPoc = nullptr;
    int w4 = 0, h4 = 0, poc = 0;
  } col;

  Ops ops;
  int curQp;
  int ctuX, ctuY;

  // dqp (cu_qp_delta) state — encoder.py _maybe_write_dqp / _finish_cu_qp;
  // one quantization group per CTU (diff_cu_qp_delta_depth == 0)
  int dqpEnabled = 0;
  int lastQpEnc = 0, qpPredEnc = 0, cuDeltaEnc = 0;
  bool dqpCoded = true;

  // inter helper state (mirrors transient attrs on IntraEncoder)
  int puLastMode;
  int curDepth;  // _cur_depth (inter_dir context)

  ~Ctx();

  // ---- recording coder ----
  void recBin(int set, int idx, int v) {
    int32_t* arr = bank[set];
    int state = arr[idx];
    arr[idx] = (v == (state & 1)) ? nextMps[state] : nextLps[state];
    ops.kind.push_back(OP_B);
    ops.a.push_back((set << 8) | idx);
    ops.b.push_back(v);
    ops.pre.push_back((uint8_t)state);
  }
  void recBypass(int v) {
    ops.kind.push_back(OP_P);
    ops.a.push_back(0);
    ops.b.push_back(v);
    ops.pre.push_back(0);
  }
  void recBypassBins(int v, int n) {
    ops.kind.push_back(OP_PN);
    ops.a.push_back(n);
    ops.b.push_back(v);
    ops.pre.push_back(0);
  }
  void recEg(int v, int k) {
    ops.kind.push_back(OP_EG);
    ops.a.push_back(k);
    ops.b.push_back(v);
    ops.pre.push_back(0);
  }
  void recTerm(int v) {
    ops.kind.push_back(OP_T);
    ops.a.push_back(0);
    ops.b.push_back(v);
    ops.pre.push_back(0);
  }
  void truncate(size_t lo) {
    for (size_t i = ops.size(); i-- > lo;) {
      if (ops.kind[i] == OP_B)
        bank[ops.a[i] >> 8][ops.a[i] & 255] = ops.pre[i];
    }
    ops.kind.resize(lo);
    ops.a.resize(lo);
    ops.b.resize(lo);
    ops.pre.resize(lo);
  }
  OpsSlice saveOps(size_t lo) const {
    OpsSlice s;
    s.kind.assign(ops.kind.begin() + lo, ops.kind.end());
    s.a.assign(ops.a.begin() + lo, ops.a.end());
    s.b.assign(ops.b.begin() + lo, ops.b.end());
    s.pre.assign(ops.pre.begin() + lo, ops.pre.end());
    return s;
  }
  void reinstate(const OpsSlice& s) {
    for (size_t i = 0; i < s.kind.size(); i++) {
      if (s.kind[i] == OP_B) {
        int set = s.a[i] >> 8, idx = s.a[i] & 255;
        int32_t* arr = bank[set];
        int state = arr[idx];
        arr[idx] = (s.b[i] == (state & 1)) ? nextMps[state] : nextLps[state];
      }
      ops.kind.push_back(s.kind[i]);
      ops.a.push_back(s.a[i]);
      ops.b.push_back(s.b[i]);
      ops.pre.push_back(s.pre[i]);
    }
  }
  // fractional-bit pricing (encoder.py _est_ops_raw): context bins priced
  // at the per-op pre-adaptation state, FRAC-scaled, accumulation order
  // matches the recording order exactly.
  double estOpsRaw(size_t lo) const {
    double tot = 0.0;
    for (size_t i = lo; i < ops.size(); i++) {
      switch (ops.kind[i]) {
        case OP_B: {
          int state = ops.pre[i];
          tot += (ops.b[i] == (state & 1)) ? kEst.mps[state >> 1]
                                           : kEst.lps[state >> 1];
          break;
        }
        case OP_P: tot += kFrac; break;
        case OP_PN: tot += (double)ops.a[i] * kFrac; break;
        case OP_T: tot += kFrac; break;
        default: {  // OP_EG
          int k = ops.a[i];
          long long v = ops.b[i];
          tot += (double)(2 * bitLength((unsigned long long)((v >> k) + 1)) -
                          1 + k) * kFrac;
        }
      }
    }
    return tot;
  }
  double estOpsBits(size_t lo) const { return estOpsRaw(lo) / kFrac; }

  // ---- map helpers ----
  int m4(int v) const { return v >> 2; }
  size_t mi(int x, int y) const { return (size_t)(y >> 2) * w4 + (x >> 2); }
  void setRect8(int8_t* m, int x, int y, int w, int h, int v) {
    for (int j = y >> 2; j < (y + h) >> 2; j++)
      for (int i = x >> 2; i < (x + w) >> 2; i++) m[(size_t)j * w4 + i] = v;
  }
  void markEdges(int x, int y, int size) {
    for (int j = y >> 2; j < (y + size) >> 2; j++)
      edgeFlags[(size_t)j * w4 + (x >> 2)] |=
          EDGE_CU_LEFT | EDGE_PU_LEFT | EDGE_TU_LEFT;
    for (int i = x >> 2; i < (x + size) >> 2; i++)
      edgeFlags[(size_t)(y >> 2) * w4 + i] |=
          EDGE_CU_TOP | EDGE_PU_TOP | EDGE_TU_TOP;
  }
  void markTuEdges(int x, int y, int size) {
    for (int j = y >> 2; j < (y + size) >> 2; j++)
      edgeFlags[(size_t)j * w4 + (x >> 2)] |= EDGE_TU_LEFT;
    for (int i = x >> 2; i < (x + size) >> 2; i++)
      edgeFlags[(size_t)(y >> 2) * w4 + i] |= EDGE_TU_TOP;
  }

  // availability (slicedec.SliceDecoder.available)
  bool available(int x, int y, int curX, int curY, bool checkZ = true) const {
    if (x < 0 || y < 0 || x >= width || y >= height) return false;
    int x4 = x >> 2, y4 = y >> 2, cx4 = curX >> 2, cy4 = curY >> 2;
    if (checkZ && zmap[(size_t)y4 * w4 + x4] >= zmap[(size_t)cy4 * w4 + cx4])
      return false;
    if (sliceIdx[(size_t)y4 * w4 + x4] !=
        sliceIdx[(size_t)cy4 * w4 + cx4])
      return false;
    return tileMap[(y >> log2Ctb) * nctbX + (x >> log2Ctb)] ==
           tileMap[(curY >> log2Ctb) * nctbX + (curX >> log2Ctb)];
  }

  int chromaShiftX() const { return cfmt == 1 || cfmt == 2 ? 1 : 0; }
  int chromaShiftY() const { return cfmt == 1 ? 1 : 0; }
  int ncomp() const { return cfmt ? 3 : 1; }
};

Ctx::~Ctx() {
  for (int l = 0; l < 2; l++)
    for (auto& r : refs[l]) {
      // planes/padded owned only by the first (l, idx) holding the id
      (void)r;
    }
}

// ---------------------------------------------------------------------------
// intra prediction oracle (hostdec/refimpl.py) over int32 planes
// ---------------------------------------------------------------------------
struct IntraRefs {
  int32_t top[129], left[129];  // [2n+1] each, n <= 64
};

// fill_reference_samples (refimpl.py:132) for component comp at component
// coords (x, y), block size n.  Availability mirrors encoder.py
// _intra_pred's closure: anchored at the block's luma position.
static void fillRefSamples(const Ctx& E, int comp, int x, int y, int n,
                           IntraRefs* out) {
  int ssx = comp ? E.chromaShiftX() : 0;
  int ssy = comp ? E.chromaShiftY() : 0;
  int W = E.compW[comp], H = E.compH[comp];
  int lxA = x << ssx, lyA = y << ssy;
  long long zCur = E.zmap[(size_t)(lyA >> 2) * E.w4 + (lxA >> 2)];
  int32_t sliceCur = E.sliceIdx[(size_t)(lyA >> 2) * E.w4 + (lxA >> 2)];
  int32_t tileCur =
      E.tileMap[(lyA >> E.log2Ctb) * E.nctbX + (lxA >> E.log2Ctb)];
  auto avail = [&](int cx, int cy) -> bool {
    if (cx < 0 || cy < 0 || cx >= W || cy >= H) return false;
    int lx = cx << ssx, ly = cy << ssy;
    if (E.zmap[(size_t)(ly >> 2) * E.w4 + (lx >> 2)] >= zCur) return false;
    if (E.sliceIdx[(size_t)(ly >> 2) * E.w4 + (lx >> 2)] != sliceCur)
      return false;
    return E.tileMap[(ly >> E.log2Ctb) * E.nctbX + (lx >> E.log2Ctb)] ==
           tileCur;
  };
  const int total = 4 * n + 1;
  int cxs[257], cys[257];
  bool av[257];
  for (int i = 0; i < 2 * n; i++) { cxs[i] = x - 1; cys[i] = y + 2 * n - 1 - i; }
  cxs[2 * n] = x - 1; cys[2 * n] = y - 1;
  for (int i = 0; i < 2 * n; i++) { cxs[2 * n + 1 + i] = x + i; cys[2 * n + 1 + i] = y - 1; }
  bool any = false;
  for (int i = 0; i < total; i++) {
    av[i] = avail(cxs[i], cys[i]);
    any = any || av[i];
  }
  int32_t vals[257];
  const int32_t* plane = E.recon[comp];
  const int stride = E.planeW[comp];
  if (!any) {
    int32_t dc = 1 << (E.bd - 1);
    for (int i = 0; i < total; i++) vals[i] = dc;
  } else {
    for (int i = 0; i < total; i++)
      vals[i] = av[i] ? plane[(size_t)cys[i] * stride + cxs[i]] : 0;
    if (!av[0]) {
      int j = 1;
      while (j < total && !av[j]) j++;
      vals[0] = vals[j];
    }
    for (int i = 1; i < total; i++)
      if (!av[i]) vals[i] = vals[i - 1];
  }
  // left[0] = corner, left[1..2n] downwards; top[0] = corner, rightwards
  for (int i = 0; i <= 2 * n; i++) out->left[i] = vals[2 * n - i];
  for (int i = 0; i <= 2 * n; i++) out->top[i] = vals[2 * n + i];
}

// filter_reference_samples (refimpl.py:172)
static void filterRefSamples(const IntraRefs& in, int n, int bd,
                             bool strongEnabled, IntraRefs* out) {
  int32_t corner = in.top[0];
  // full = left[2n..1] reversed-ish: full[i] = left[2n - i] for i<2n;
  // full[2n] = corner; full[2n + i] = top[i]
  int32_t full[257];
  for (int i = 0; i < 2 * n; i++) full[i] = in.left[2 * n - i];
  full[2 * n] = corner;
  for (int i = 1; i <= 2 * n; i++) full[2 * n + i] = in.top[i];
  const int T = 4 * n + 1;
  if (strongEnabled && n == 32) {
    int thr = 1 << (bd - 5);
    bool f1 = std::abs((long long)corner + in.top[2 * n] - 2LL * in.top[n]) <
              thr;
    bool f2 = std::abs((long long)corner + in.left[2 * n] -
                       2LL * in.left[n]) < thr;
    if (f1 && f2) {
      long long bl = in.left[2 * n], tr = in.top[2 * n], c = corner;
      out->left[0] = (int32_t)c;
      out->top[0] = (int32_t)c;
      for (int i = 0; i < 2 * n; i++) {
        out->left[1 + i] =
            (int32_t)(((2 * n - 1 - i) * c + (i + 1) * bl + n) >> 6);
        out->top[1 + i] =
            (int32_t)(((2 * n - 1 - i) * c + (i + 1) * tr + n) >> 6);
      }
      out->left[2 * n] = (int32_t)bl;
      out->top[2 * n] = (int32_t)tr;
      return;
    }
  }
  int32_t sm[257];
  sm[0] = full[0];
  sm[T - 1] = full[T - 1];
  for (int i = 1; i < T - 1; i++)
    sm[i] = (full[i - 1] + 2 * full[i] + full[i + 1] + 2) >> 2;
  out->left[0] = sm[2 * n];
  for (int i = 0; i < 2 * n; i++) out->left[1 + i] = sm[2 * n - 1 - i];
  for (int i = 0; i <= 2 * n; i++) out->top[i] = sm[2 * n + i];
}

// use_filtered_refs (refimpl.py:208)
static bool useFilteredRefs(const Ctx& E, int comp, int n, int mode) {
  if (E.smoothingDisabled) return false;
  if (comp != 0 && E.cfmt != 3) return false;
  if (mode == 1 || n == 4) return false;
  if (mode == 0) return n >= 8;
  int minDist = std::min(std::abs(mode - 26), std::abs(mode - 10));
  int thr = n == 8 ? 7 : (n == 16 ? 1 : (n == 32 || n == 64 ? 0 : 10));
  return minDist > thr;
}

// predict_intra (refimpl.py:223), full oracle incl. boundary filters
static void predictIntra(const int32_t* top, const int32_t* left, int n,
                         int mode, int comp, int bd, int32_t* pred) {
  prof::Scope _ps(prof::P_INTRAPRED);
  const int maxv = (1 << bd) - 1;
  const int log2n = bitLength((unsigned)n) - 1;
  if (mode == 0) {  // planar
    long long tr = top[n + 1], bl = left[n + 1];
    for (int j = 0; j < n; j++)
      for (int i = 0; i < n; i++) {
        long long hor =
            (long long)(n - 1 - i) * left[1 + j] + (long long)(i + 1) * tr;
        long long ver =
            (long long)(n - 1 - j) * top[1 + i] + (long long)(j + 1) * bl;
        pred[j * n + i] = (int32_t)((hor + ver + n) >> (log2n + 1));
      }
    return;
  }
  if (mode == 1) {  // DC
    long long s = 0;
    for (int i = 1; i <= n; i++) s += top[i] + left[i];
    int dc = (int)((s + n) >> (log2n + 1));
    for (int i = 0; i < n * n; i++) pred[i] = dc;
    if (comp == 0 && n < 32) {
      pred[0] = (left[1] + 2 * dc + top[1] + 2) >> 2;
      for (int i = 1; i < n; i++) pred[i] = (top[1 + i] + 3 * dc + 2) >> 2;
      for (int j = 1; j < n; j++)
        pred[j * n] = (left[1 + j] + 3 * dc + 2) >> 2;
    }
    return;
  }
  int ang = kAngTable[mode];
  bool vertical = mode >= 18;
  const int32_t* main_ = vertical ? top : left;
  const int32_t* side = vertical ? left : top;
  int32_t ref[129 * 2];
  int baseIdx;
  if (ang < 0) {
    int inv = invAngleOf(ang);
    for (int i = 0; i <= 2 * n; i++) ref[i] = 0;
    for (int i = 0; i <= n; i++) ref[n + i] = main_[i];
    int lo = (n * ang) >> 5;
    for (int i = -1; i >= lo; i--) {
      int si = (-i * inv + 128) >> 8;
      if (si > 2 * n) si = 2 * n;
      ref[n + i] = side[si];
    }
    baseIdx = n;
  } else {
    for (int i = 0; i <= 2 * n; i++) ref[i] = main_[i];
    baseIdx = 0;
  }
  for (int j = 0; j < n; j++) {
    int pos = (j + 1) * ang;
    int intOff = pos >> 5;
    int frac = pos & 31;
    int idx = baseIdx + 1 + intOff;
    for (int i = 0; i < n; i++) {
      long long v;
      if (frac)
        v = ((long long)(32 - frac) * ref[idx + i] +
             (long long)frac * ref[idx + i + 1] + 16) >> 5;
      else
        v = ref[idx + i];
      if (vertical) pred[j * n + i] = (int32_t)v;
      else pred[i * n + j] = (int32_t)v;
    }
  }
  if (comp == 0 && n < 32) {
    if (mode == 26) {
      for (int j = 0; j < n; j++) {
        long long d = ((long long)left[1 + j] - top[0]) >> 1;
        long long v = top[1] + d;
        pred[j * n] = (int32_t)(v < 0 ? 0 : (v > maxv ? maxv : v));
      }
    } else if (mode == 10) {
      for (int i = 0; i < n; i++) {
        long long d = ((long long)top[1 + i] - left[0]) >> 1;
        long long v = left[1] + d;
        pred[i] = (int32_t)(v < 0 ? 0 : (v > maxv ? maxv : v));
      }
    }
  }
}

// encoder-side full intra prediction (encoder.py _intra_pred): fill +
// conditional smoothing + full predict.
static void intraPredFull(const Ctx& E, int comp, int x, int y, int n,
                          int mode, int32_t* pred) {
  IntraRefs r;
  fillRefSamples(E, comp, x, y, n, &r);
  if (useFilteredRefs(E, comp, n, mode)) {
    IntraRefs f;
    bool strong = E.strongSmoothing && comp == 0;
    filterRefSamples(r, n, E.bd, strong, &f);
    predictIntra(f.top, f.left, n, mode, comp, E.bd, pred);
  } else {
    predictIntra(r.top, r.left, n, mode, comp, E.bd, pred);
  }
}

// all-modes search predictions (encoder/intra_search.predict_all_modes):
// boundary filters are SKIPPED (search-side simplification; the RD trial
// uses these predictions too, so the skip influences decisions and must
// be mirrored exactly).
struct AllPreds {
  std::vector<int32_t> buf;  // [35 * n * n]
  int n;
  const int32_t* at(int m) const { return buf.data() + (size_t)m * n * n; }
  int32_t* at(int m) { return buf.data() + (size_t)m * n * n; }
};

static void predictAllModes(const Ctx& E, int comp, int x, int y, int n,
                            AllPreds* out) {
  out->n = n;
  out->buf.resize((size_t)35 * n * n);
  IntraRefs ru;
  fillRefSamples(E, comp, x, y, n, &ru);
  IntraRefs rf;
  bool haveF = !E.smoothingDisabled && (comp == 0 || E.cfmt == 3) && n > 4;
  if (haveF)
    filterRefSamples(ru, n, E.bd, E.strongSmoothing && comp == 0, &rf);
  const int log2n = bitLength((unsigned)n) - 1;
  for (int m = 0; m < 35; m++) {
    bool filt = haveF && useFilteredRefs(E, comp, n, m);
    const IntraRefs& R = filt ? rf : ru;
    int32_t* p = out->at(m);
    if (m == 0) {  // planar
      long long tr = R.top[n + 1], bl = R.left[n + 1];
      for (int j = 0; j < n; j++)
        for (int i = 0; i < n; i++) {
          long long hor = (long long)(n - 1 - i) * R.left[1 + j] +
                          (long long)(i + 1) * tr;
          long long ver = (long long)(n - 1 - j) * R.top[1 + i] +
                          (long long)(j + 1) * bl;
          p[j * n + i] = (int32_t)((hor + ver + n) >> (log2n + 1));
        }
      continue;
    }
    if (m == 1) {  // DC, boundary filter skipped
      long long s = 0;
      for (int i = 1; i <= n; i++) s += R.top[i] + R.left[i];
      int dc = (int)((s + n) >> (log2n + 1));
      for (int i = 0; i < n * n; i++) p[i] = dc;
      continue;
    }
    // angular without the mode-10/26 boundary filter: reuse predictIntra
    // with comp forced chroma-like (boundary filters keyed on comp == 0)
    predictIntra(R.top, R.left, n, m, /*comp=*/1, E.bd, p);
  }
}

// intra MPM derivation (slicedec._intra_mpm)
static void intraMpm(const Ctx& E, int x, int y, int preds[3]) {
  int leftM = DC_IDX;
  if (E.available(x - 1, y, x, y) &&
      E.predMode[E.mi(x - 1, y)] == MODE_INTRA && !E.pcm[E.mi(x - 1, y)])
    leftM = E.intraY[E.mi(x - 1, y)];
  int aboveM = DC_IDX;
  int ctb = 1 << E.log2Ctb;
  if ((y % ctb) != 0 && E.available(x, y - 1, x, y) &&
      E.predMode[E.mi(x, y - 1)] == MODE_INTRA && !E.pcm[E.mi(x, y - 1)])
    aboveM = E.intraY[E.mi(x, y - 1)];
  if (leftM == aboveM) {
    if (leftM > 1) {
      preds[0] = leftM;
      preds[1] = ((leftM + 29) % 32) + 2;
      preds[2] = ((leftM - 1) % 32) + 2;
    } else {
      preds[0] = PLANAR_IDX;
      preds[1] = DC_IDX;
      preds[2] = VER_IDX;
    }
    return;
  }
  preds[0] = leftM;
  preds[1] = aboveM;
  if (leftM != PLANAR_IDX && aboveM != PLANAR_IDX) preds[2] = PLANAR_IDX;
  else if (leftM != DC_IDX && aboveM != DC_IDX) preds[2] = DC_IDX;
  else preds[2] = VER_IDX;
}

// ---------------------------------------------------------------------------
// SATD (encsearch satdBlock over int32 diff)
// ---------------------------------------------------------------------------
static long long satd32(const int32_t* a, const int32_t* b, int w, int h) {
  static thread_local std::vector<int32_t> diff;
  diff.resize((size_t)w * h);
  for (int i = 0; i < w * h; i++) diff[i] = a[i] - b[i];
  return enc::satdBlock(diff.data(), w, h);
}

// ---------------------------------------------------------------------------
// residual_coding() emission into the recording coder
// (encoder/residual_enc.py encode_residual, recording variant)
// ---------------------------------------------------------------------------
static void encodeLastSigXY(Ctx& E, int posX, int posY, int w, int h,
                            bool isChroma, int scanType) {
  if (scanType == SCAN_VER) {
    std::swap(posX, posY);
    std::swap(w, h);
  }
  int log2w = bitLength((unsigned)w) - 1, log2h = bitLength((unsigned)h) - 1;
  int offX, offY, shiftX, shiftY;
  if (isChroma) {
    offX = offY = 15;
    shiftX = log2w - 2;
    shiftY = log2h - 2;
  } else {
    offX = 3 * (log2w - 2) + ((log2w - 1) >> 2);
    offY = 3 * (log2h - 2) + ((log2h - 1) >> 2);
    shiftX = (log2w + 1) >> 2;
    shiftY = (log2h + 1) >> 2;
  }
  int gx = kGroupIdx[posX], gy = kGroupIdx[posY];
  for (int i = 0; i < gx; i++) E.recBin(B_LAST_X, offX + (i >> shiftX), 1);
  if (gx < kGroupIdx[w - 1]) E.recBin(B_LAST_X, offX + (gx >> shiftX), 0);
  for (int i = 0; i < gy; i++) E.recBin(B_LAST_Y, offY + (i >> shiftY), 1);
  if (gy < kGroupIdx[h - 1]) E.recBin(B_LAST_Y, offY + (gy >> shiftY), 0);
  if (gx > 3) E.recBypassBins(posX - kMinInGroup[gx], (gx - 2) >> 1);
  if (gy > 3) E.recBypassBins(posY - kMinInGroup[gy], (gy - 2) >> 1);
}

static void encodeCoefRemain(Ctx& E, long long v, int rice) {
  const int RED = 3;  // COEF_REMAIN_BIN_REDUCTION
  if ((v >> rice) < RED) {
    int prefix = (int)(v >> rice);
    for (int i = 0; i < prefix; i++) E.recBypass(1);
    E.recBypass(0);
    E.recBypassBins((int)(v & ((1 << rice) - 1)), rice);
  } else {
    long long vr = v >> rice;
    int L = bitLength((unsigned long long)(vr - 2)) - 1;
    for (int i = 0; i < RED + L; i++) E.recBypass(1);
    E.recBypass(0);
    long long suffix = v - (((1LL << L) + RED - 1) << rice);
    E.recBypassBins((int)suffix, L + rice);
  }
}

// significance context layout constants (hostdec/residual.py)
static const int kCtxIndMap4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                      6, 6, 8, 8, 7, 7, 8, 8};
static const int kSigSet[2][3] = {{0, 9, 21}, {0, 9, 12}};
static const int kNonDiag8[2] = {6, 0};
static const int kNotFirst[2] = {3, 0};
static const int C1FLAG_NUMBER = 8;

static void encodeResidual(Ctx& E, const int32_t* coeffs, int w, int h,
                           int comp, int scanType, int signHiding,
                           int tsFlag) {
  prof::Scope _ps(prof::P_EMIT);
  if (tsFlag >= 0) E.recBin(B_TSKIP, comp == 0 ? 0 : 1, tsFlag);
  int log2w = bitLength((unsigned)w) - 1;
  bool isChroma = comp > 0;
  int ch = isChroma ? 1 : 0;
  // grouped scan: CGs in scan order, 16 in-CG positions each
  int wg = w >> 2, hg = h >> 2;
  static thread_local int cgx[64], cgy[64], inx[16], iny[16];
  scanOrder(wg, hg, scanType, cgx, cgy);
  scanOrder(4, 4, scanType, inx, iny);
  auto blkAt = [&](int s, int k) {
    return (cgy[s] * 4 + iny[k]) * w + cgx[s] * 4 + inx[k];
  };
  int nCg = wg * hg;
  int scanPosLast = -1, blkLast = -1;
  for (int s = 0; s < nCg; s++)
    for (int k = 0; k < 16; k++) {
      int b = blkAt(s, k);
      if (coeffs[b]) { scanPosLast = s * 16 + k; blkLast = b; }
    }
  int posY = blkLast / w, posX = blkLast - posY * w;
  encodeLastSigXY(E, posX, posY, w, h, isChroma, scanType);

  int firstSigCtx;
  if (w == 4 && h == 4) firstSigCtx = kSigSet[ch][0];
  else if (w == 8 && h == 8) {
    firstSigCtx = kSigSet[ch][1];
    if (scanType != SCAN_DIAG) firstSigCtx += kNonDiag8[ch];
  } else firstSigCtx = kSigSet[ch][2];
  int sigBase = isChroma ? 28 : 0;

  int lastScanSet = scanPosLast >> 4;
  int c1 = 1;
  static thread_local int8_t sigCg[64];
  for (int i = 0; i < 64; i++) sigCg[i] = 0;
  for (int s = 0; s <= lastScanSet; s++) {
    bool any = false;
    for (int k = 0; k < 16; k++)
      if (coeffs[blkAt(s, k)]) { any = true; break; }
    sigCg[cgy[s] * wg + cgx[s]] = any ? 1 : 0;
  }
  sigCg[cgy[0] * wg + cgx[0]] = 1;
  sigCg[cgy[lastScanSet] * wg + cgx[lastScanSet]] = 1;

  int scanPos = scanPosLast;
  for (int subset = lastScanSet; subset >= 0; subset--) {
    int subPos = subset << 4;
    int goRice = 0;
    int cgX = cgx[subset], cgY = cgy[subset];
    int cgBlk = cgY * wg + cgX;
    int numNz = 0;
    int posList[16];
    if (scanPos == scanPosLast) {
      posList[numNz++] = blkLast;
      scanPos--;
    }
    if (subset != lastScanSet && subset != 0) {
      int right = cgX < wg - 1 ? sigCg[cgBlk + 1] : 0;
      int below = cgY < hg - 1 ? sigCg[cgBlk + wg] : 0;
      int ctx = (right || below) ? 1 : 0;
      E.recBin(B_SIG_CG, 2 * ch + ctx, sigCg[cgBlk]);
    }
    int pattern = 0;
    if (!(wg <= 1 && hg <= 1)) {
      int right = cgX < wg - 1 ? sigCg[cgBlk + 1] : 0;
      int below = cgY < hg - 1 ? sigCg[cgBlk + wg] : 0;
      pattern = right + (below << 1);
    }
    while (scanPos >= subPos) {
      int k = scanPos - subPos;
      int blk = blkAt(subset, k);
      int sig = coeffs[blk] ? 1 : 0;
      if (sigCg[cgBlk]) {
        if (scanPos > subPos || subset == 0 || numNz) {
          int py = blk >> log2w;
          int px = blk - (py << log2w);
          int ctx;
          if (px + py == 0) ctx = 0;
          else if (w == 4 && h == 4)
            ctx = firstSigCtx + kCtxIndMap4x4[4 * py + px];
          else {
            int xin = px & 3, yin = py & 3, cnt;
            if (pattern == 0) {
              int t = xin + yin;
              cnt = t >= 3 ? 0 : (t >= 1 ? 1 : 2);
            } else if (pattern == 1) cnt = yin >= 2 ? 0 : (yin >= 1 ? 1 : 2);
            else if (pattern == 2) cnt = xin >= 2 ? 0 : (xin >= 1 ? 1 : 2);
            else cnt = 2;
            bool notFirst = ((px >> 2) + (py >> 2)) > 0;
            ctx = firstSigCtx + cnt + (notFirst ? kNotFirst[ch] : 0);
          }
          E.recBin(B_SIG, sigBase + ctx, sig);
        }
      }
      if (sig) posList[numNz++] = blk;
      scanPos--;
    }
    if (numNz == 0) continue;
    int ctxSet = isChroma ? (4 + (c1 == 0 ? 1 : 0))
                          : ((subset > 0 ? 2 : 0) + (c1 == 0 ? 1 : 0));
    c1 = 1;
    int baseGt1 = 4 * ctxSet;
    long long absVals[16];
    for (int i = 0; i < numNz; i++) {
      long long v = coeffs[posList[i]];
      absVals[i] = v < 0 ? -v : v;
    }
    int numC1 = numNz < C1FLAG_NUMBER ? numNz : C1FLAG_NUMBER;
    int firstC2 = -1;
    for (int i = 0; i < numC1; i++) {
      int b = absVals[i] > 1 ? 1 : 0;
      E.recBin(B_GT1, baseGt1 + c1, b);
      if (b) {
        c1 = 0;
        if (firstC2 == -1) firstC2 = i;
      } else if (c1 > 0 && c1 < 3) c1++;
    }
    if (c1 == 0 && firstC2 != -1)
      E.recBin(B_GT2, ctxSet, absVals[firstC2] > 2 ? 1 : 0);
    bool hide = false;
    if (signHiding && numNz) {
      int first = -1, last = -1;
      int top = (subPos + 16 <= w * h) ? 16 : (w * h - subPos);
      for (int sp = 0; sp < top; sp++)
        if (coeffs[blkAt(subset, sp)]) {
          if (first < 0) first = sp;
          last = sp;
        }
      hide = (last - first) >= 4;  // SBH_THRESHOLD
    }
    int nSigns = hide ? numNz - 1 : numNz;
    for (int i = 0; i < nSigns; i++)
      E.recBypass(coeffs[posList[i]] < 0 ? 1 : 0);
    int firstCoeff2 = 1;
    for (int i = 0; i < numNz; i++) {
      long long baseLevel = i < C1FLAG_NUMBER ? (2 + firstCoeff2) : 1;
      if (absVals[i] >= baseLevel) {
        encodeCoefRemain(E, absVals[i] - baseLevel, goRice);
        if (absVals[i] > (3LL << goRice))
          goRice = goRice + 1 < 4 ? goRice + 1 : 4;
      }
      if (absVals[i] >= 2) firstCoeff2 = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// TU forward path wrapper (encoder.py _tu_fwd native branch)
// ---------------------------------------------------------------------------
static const int kChromaScale420[58] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 33, 33, 34, 34,
    35, 35, 36, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51};

static int qpForComp(const Ctx& E, int comp) {
  if (comp == 0) return E.curQp + 6 * (E.bd - 8);
  int offBd = 6 * (E.bd - 8);
  int qpi = std::max(-offBd, std::min(57, E.curQp));
  if (qpi >= 0) {
    if (E.cfmt == 1) qpi = kChromaScale420[qpi];
    else qpi = std::min(qpi, 51);
  }
  return qpi + offBd;
}

struct TuOut {
  int32_t lev[32 * 32];
  int32_t rec[32 * 32];
  int cbf;
  int ts;  // -1 = no transform_skip flag carried
};

static void tuFwd(Ctx& E, const int32_t* resi, int n, bool useDst, int comp,
                  int scan, bool isIntra, TuOut* out) {
  prof::Scope _ps(prof::P_TUFWD);
  int qp = qpForComp(E, comp);
  double lam = E.rdLambda / E.cw[comp];
  int tsEn = (E.tsEnabled && n == 4) ? 1 : 0;
  double norm = (double)(1 << (2 * (E.bd - 8)));
  int lg = 0;
  while ((1 << lg) < n) lg++;
  const int32_t* mat =
      E.scalOn ? E.scalMat[lg - 2][(isIntra ? 0 : 3) + comp] : nullptr;
  int flags = enc_tu_fwd(
      resi, n, useDst ? 1 : 0, comp > 0 ? 1 : 0, qp, E.bd, isIntra ? 1 : 0,
      scan, E.rdoqOn, lam, E.sdh, tsEn, lam * norm, E.bank[B_SIG],
      E.bank[B_SIG_CG], E.bank[B_GT1], E.bank[B_GT2], E.bank[B_LAST_X],
      E.bank[B_LAST_Y], out->lev, out->rec, mat);
  out->cbf = flags & 1;
  out->ts = (flags >> 1) - 1;
}

// estimated trial bits of ops[mark:] plus one NOT-recorded residual block
// (encoder.py _residual_trial_bits; the native pricer enc_residual_bits is
// bit-identical to record-then-price in the same accumulation order)
static double residualTrialBits(Ctx& E, const int32_t* lev, int n, int comp,
                                int scan, size_t mark, int ts) {
  prof::Scope _ps(prof::P_RESBITS);
  double nb = rdoq::residualBits(
      lev, n, n, comp, scan, E.sdh, ts, E.bank[B_SIG], E.bank[B_SIG_CG],
      E.bank[B_GT1], E.bank[B_GT2], E.bank[B_LAST_X], E.bank[B_LAST_Y],
      E.bank[B_TSKIP], E.estOpsRaw(mark));
  return nb / kFrac;
}

// ---------------------------------------------------------------------------
// CU state snapshot (encoder.py _save_cu_state / _restore_cu_state; the
// context rollback rides on ops.truncate, exactly like the Python)
// ---------------------------------------------------------------------------
struct CuSnap {
  int x, y, size, m;
  std::vector<int8_t> i8[11];   // depth,pred,part,skip,intraY,intraC,
                                // chromaDm,qp,cbfY,interDir x .. see order
  std::vector<uint8_t> edge;
  std::vector<int32_t> mvS, refPocS;
  std::vector<int8_t> refIdxS, refLtS;
  std::vector<int32_t> rec[3];
  size_t nops;
  int lastQpS, qpPredS, cuDeltaS;
  bool dqpCodedS;
};

static void saveCu(Ctx& E, int x, int y, int size, CuSnap* s) {
  prof::Scope _ps(prof::P_SNAP);
  s->x = x; s->y = y; s->size = size;
  int m = size >> 2;
  s->m = m;
  int8_t* maps8[11] = {E.depth, E.predMode, E.partSize, E.skip, E.intraY,
                       E.intraC, E.chromaDm, E.qpMap, E.cbfY, E.interDir,
                       nullptr};
  for (int k = 0; k < 10; k++) {
    s->i8[k].resize((size_t)m * m);
    for (int j = 0; j < m; j++)
      std::memcpy(&s->i8[k][(size_t)j * m],
                  maps8[k] + (size_t)((y >> 2) + j) * E.w4 + (x >> 2), m);
  }
  s->edge.resize((size_t)m * m);
  s->mvS.resize((size_t)m * m * 4);
  s->refPocS.resize((size_t)m * m * 2);
  s->refIdxS.resize((size_t)m * m * 2);
  s->refLtS.resize((size_t)m * m * 2);
  for (int j = 0; j < m; j++) {
    size_t row = (size_t)((y >> 2) + j) * E.w4 + (x >> 2);
    std::memcpy(&s->edge[(size_t)j * m], E.edgeFlags + row, m);
    std::memcpy(&s->mvS[(size_t)j * m * 4], E.mv + row * 4,
                (size_t)m * 4 * sizeof(int32_t));
    std::memcpy(&s->refPocS[(size_t)j * m * 2], E.refPocM + row * 2,
                (size_t)m * 2 * sizeof(int32_t));
    std::memcpy(&s->refIdxS[(size_t)j * m * 2], E.refIdx + row * 2, m * 2);
    std::memcpy(&s->refLtS[(size_t)j * m * 2], E.refIsLt + row * 2, m * 2);
  }
  for (int c = 0; c < E.ncomp(); c++) {
    int ssx = c ? E.chromaShiftX() : 0;
    int ssy = c ? E.chromaShiftY() : 0;
    int wC = size >> ssx, hC = size >> ssy;
    s->rec[c].resize((size_t)wC * hC);
    for (int j = 0; j < hC; j++)
      std::memcpy(&s->rec[c][(size_t)j * wC],
                  E.recon[c] + (size_t)((y >> ssy) + j) * E.planeW[c] +
                      (x >> ssx),
                  (size_t)wC * sizeof(int32_t));
  }
  s->nops = E.ops.size();
  s->lastQpS = E.lastQpEnc; s->qpPredS = E.qpPredEnc;
  s->cuDeltaS = E.cuDeltaEnc; s->dqpCodedS = E.dqpCoded;
}

static void applyMapsRecon(Ctx& E, const CuSnap& s) {
  prof::Scope _ps(prof::P_SNAP);
  int x = s.x, y = s.y, size = s.size, m = s.m;
  int8_t* maps8[11] = {E.depth, E.predMode, E.partSize, E.skip, E.intraY,
                       E.intraC, E.chromaDm, E.qpMap, E.cbfY, E.interDir,
                       nullptr};
  for (int k = 0; k < 10; k++)
    for (int j = 0; j < m; j++)
      std::memcpy(maps8[k] + (size_t)((y >> 2) + j) * E.w4 + (x >> 2),
                  &s.i8[k][(size_t)j * m], m);
  for (int j = 0; j < m; j++) {
    size_t row = (size_t)((y >> 2) + j) * E.w4 + (x >> 2);
    std::memcpy(E.edgeFlags + row, &s.edge[(size_t)j * m], m);
    std::memcpy(E.mv + row * 4, &s.mvS[(size_t)j * m * 4],
                (size_t)m * 4 * sizeof(int32_t));
    std::memcpy(E.refPocM + row * 2, &s.refPocS[(size_t)j * m * 2],
                (size_t)m * 2 * sizeof(int32_t));
    std::memcpy(E.refIdx + row * 2, &s.refIdxS[(size_t)j * m * 2], m * 2);
    std::memcpy(E.refIsLt + row * 2, &s.refLtS[(size_t)j * m * 2], m * 2);
  }
  for (int c = 0; c < E.ncomp(); c++) {
    int ssx = c ? E.chromaShiftX() : 0;
    int ssy = c ? E.chromaShiftY() : 0;
    int wC = size >> ssx, hC = size >> ssy;
    for (int j = 0; j < hC; j++)
      std::memcpy(E.recon[c] + (size_t)((y >> ssy) + j) * E.planeW[c] +
                      (x >> ssx),
                  &s.rec[c][(size_t)j * wC], (size_t)wC * sizeof(int32_t));
  }
  E.lastQpEnc = s.lastQpS; E.qpPredEnc = s.qpPredS;
  E.cuDeltaEnc = s.cuDeltaS; E.dqpCoded = s.dqpCodedS;
}

static void restoreCu(Ctx& E, const CuSnap& s) {
  applyMapsRecon(E, s);
  E.truncate(s.nops);
}

// ---------------------------------------------------------------------------
// RD costs
// ---------------------------------------------------------------------------
static double sseRect(const Ctx& E, int comp, int x, int y, int w, int h) {
  int ssx = comp ? E.chromaShiftX() : 0;
  int ssy = comp ? E.chromaShiftY() : 0;
  const int32_t* o = E.orig[comp];
  const int32_t* r = E.recon[comp];
  int stride = E.planeW[comp];
  long long sse = 0;
  for (int j = y >> ssy; j < (y + h) >> ssy; j++)
    for (int i = x >> ssx; i < (x + w) >> ssx; i++) {
      long long d = (long long)o[(size_t)j * stride + i] -
                    r[(size_t)j * stride + i];
      sse += d * d;
    }
  return (double)sse;
}

static double lumaRdCost(const Ctx& E, int x, int y, int size, size_t lo) {
  double norm = (double)(1 << (2 * (E.bd - 8)));
  return sseRect(E, 0, x, y, size, size) / norm +
         E.rdLambda * E.estOpsBits(lo);
}

static double cuRdCost(const Ctx& E, int x, int y, int size, size_t lo) {
  double norm = (double)(1 << (2 * (E.bd - 8)));
  double sse = 0.0;
  for (int c = 0; c < E.ncomp(); c++)
    sse += E.cw[c] * (sseRect(E, c, x, y, size, size) / norm);
  return sse + E.rdLambda * E.estOpsBits(lo);
}

static int mdcsScan(const Ctx& E, int n, int mode, int comp) {
  int sx = comp ? E.chromaShiftX() : 0;
  if (n <= (8 >> sx)) {
    if (std::abs(mode - 26) <= 4) return SCAN_HOR;
    if (std::abs(mode - 10) <= 4) return SCAN_VER;
  }
  return SCAN_DIAG;
}

// NxN pick_scan (encoder.py _encode_cu_intra_nxn.pick_scan): checks both
// subsampled axes
static int pickScanNxN(int n, int mode, int sx, int sy) {
  if (n <= (8 >> sx) && n <= (8 >> sy)) {
    if (std::abs(mode - 26) <= 4) return SCAN_HOR;
    if (std::abs(mode - 10) <= 4) return SCAN_VER;
  }
  return SCAN_DIAG;
}

static int ttMinTu(const Ctx& E, int log2size, bool isIntra, int extra = 0) {
  int hier = isIntra ? E.maxTrIntra : E.maxTrInter;
  int maxTrDepth = 1 + hier;
  int lo = E.log2MinTb + maxTrDepth - 1 + extra;
  if (log2size < lo) return E.log2MinTb;
  return std::min(log2size - (maxTrDepth - 1 + extra), E.log2MaxTb);
}

static bool subdivCoded(const Ctx& E, int l2, int minTu) {
  return l2 <= E.log2MaxTb && l2 != E.log2MinTb && l2 != minTu;
}

// ---------------------------------------------------------------------------
// intra luma mode signalling (encoder.py _intra_mode_rd_trial_bits)
// ---------------------------------------------------------------------------
static int mpmIndex(const int mpm[3], int mode) {
  for (int i = 0; i < 3; i++)
    if (mpm[i] == mode) return i;
  return -1;
}

static void recordLumaModeBins(Ctx& E, int mode, const int mpm[3]) {
  int idx = mpmIndex(mpm, mode);
  if (idx >= 0) {
    E.recBin(B_MPM, 0, 1);
    if (idx == 0) E.recBypass(0);
    else {
      E.recBypass(1);
      E.recBypass(idx - 1);
    }
  } else {
    E.recBin(B_MPM, 0, 0);
    int rem = mode;
    int sorted3[3] = {mpm[0], mpm[1], mpm[2]};
    std::sort(sorted3, sorted3 + 3, std::greater<int>());
    for (int p : sorted3)
      if (rem > p) rem--;
    E.recBypassBins(rem, 5);
  }
}

// ---------------------------------------------------------------------------
// intra transform-tree decide / chroma / emit (encoder.py _intra_tt_*)
// ---------------------------------------------------------------------------
struct TtNode {
  bool split;
  int l2, x, y, depth;
  int32_t lev[32 * 32];
  int cbf, ts, scan;
  TtNode* kids[4];
  int cb[2], cr[2];
  bool hasChroma;
  struct CTu {
    int32_t lev[32 * 32];
    int cbf, ts, scan;
  };
  CTu* ch[3];  // [comp] -> array of nSub entries (comp 1, 2)
  int nSub;
  TtNode() : split(false), cbf(0), ts(-1), scan(SCAN_DIAG),
             hasChroma(false), nSub(0) {
    kids[0] = kids[1] = kids[2] = kids[3] = nullptr;
    ch[0] = ch[1] = ch[2] = nullptr;
    cb[0] = cb[1] = cr[0] = cr[1] = 0;
  }
  ~TtNode() {
    for (int i = 0; i < 4; i++) delete kids[i];
    delete[] ch[1];
    delete[] ch[2];
  }
};

static thread_local int curCuLog2ForTt;  // encoder.py cu_log2_for_tt (per-thread single)

static TtNode* intraTtDecide(Ctx& E, int x, int y, int l2, int depth,
                             int mode, int minTu);

static TtNode* intraTtLeafTry(Ctx& E, int x, int y, int l2, int depth,
                              int mode, int minTu) {
  int size = 1 << l2;
  TtNode* node = new TtNode();
  node->split = false;
  node->l2 = l2; node->x = x; node->y = y; node->depth = depth;
  static thread_local int32_t pred[32 * 32], resi[32 * 32];
  intraPredFull(E, 0, x, y, size, mode, pred);
  const int stride = E.planeW[0];
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++)
      resi[j * size + i] =
          E.orig[0][(size_t)(y + j) * stride + x + i] - pred[j * size + i];
  int scan = mdcsScan(E, size, mode, 0);
  TuOut tu;
  tuFwd(E, resi, size, size == 4, 0, scan, true, &tu);
  int maxv = (1 << E.bd) - 1;
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++) {
      int v = pred[j * size + i] + tu.rec[j * size + i];
      E.recon[0][(size_t)(y + j) * stride + x + i] =
          v < 0 ? 0 : (v > maxv ? maxv : v);
    }
  E.setRect8(E.cbfY, x, y, size, size, tu.cbf);
  E.markTuEdges(x, y, size);
  if (subdivCoded(E, l2, minTu)) E.recBin(B_SUBDIV, 5 - l2, 0);
  E.recBin(B_QT_CBF, depth == 0 ? 1 : 0, tu.cbf);
  if (tu.cbf)
    encodeResidual(E, tu.lev, size, size, 0, scan, E.sdh, tu.ts);
  std::memcpy(node->lev, tu.lev, (size_t)size * size * sizeof(int32_t));
  node->cbf = tu.cbf;
  node->ts = tu.ts;
  node->scan = scan;
  return node;
}

static TtNode* intraTtSplitTry(Ctx& E, int x, int y, int l2, int depth,
                               int mode, int minTu) {
  int size = 1 << l2;
  if (subdivCoded(E, l2, minTu)) E.recBin(B_SUBDIV, 5 - l2, 1);
  TtNode* node = new TtNode();
  node->split = true;
  node->l2 = l2; node->x = x; node->y = y; node->depth = depth;
  int h = size >> 1;
  static const int off[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
  for (int k = 0; k < 4; k++)
    node->kids[k] = intraTtDecide(E, x + off[k][0] * h, y + off[k][1] * h,
                                  l2 - 1, depth + 1, mode, minTu);
  return node;
}

static TtNode* intraTtDecide(Ctx& E, int x, int y, int l2, int depth,
                             int mode, int minTu) {
  if (l2 > E.log2MaxTb) return intraTtSplitTry(E, x, y, l2, depth, mode,
                                               minTu);
  if (!(l2 > minTu && l2 > E.log2MinTb))
    return intraTtLeafTry(E, x, y, l2, depth, mode, minTu);
  int size = 1 << l2;
  CuSnap st;
  saveCu(E, x, y, size, &st);
  size_t mark = st.nops;
  TtNode* leaf = intraTtLeafTry(E, x, y, l2, depth, mode, minTu);
  double costLeaf = lumaRdCost(E, x, y, size, mark);
  CuSnap leafState;
  saveCu(E, x, y, size, &leafState);
  OpsSlice leafOps = E.saveOps(mark);
  restoreCu(E, st);
  TtNode* split = intraTtSplitTry(E, x, y, l2, depth, mode, minTu);
  double costSplit = lumaRdCost(E, x, y, size, mark);
  if (costLeaf <= costSplit) {
    E.truncate(mark);
    applyMapsRecon(E, leafState);
    E.reinstate(leafOps);
    delete split;
    return leaf;
  }
  delete leaf;
  return split;
}

// chroma TUs on the decided luma tree (encoder.py _intra_tt_chroma),
// 4:2:0 / 4:4:4 / mono (4:2:2 is gated to the Python path)
static void intraTtChroma(Ctx& E, TtNode* node, int mode) {
  int idc = E.cfmt;
  int l2 = node->l2;
  if (idc == 0) {
    node->cb[0] = node->cb[1] = node->cr[0] = node->cr[1] = 0;
    if (node->split)
      for (int k = 0; k < 4; k++) intraTtChroma(E, node->kids[k], mode);
    return;
  }
  if (node->split && (idc == 3 || l2 > 3)) {
    for (int k = 0; k < 4; k++) intraTtChroma(E, node->kids[k], mode);
    int vb = 0, vr = 0;
    for (int k = 0; k < 4; k++) {
      if (node->kids[k]->cb[0] || node->kids[k]->cb[1]) vb = 1;
      if (node->kids[k]->cr[0] || node->kids[k]->cr[1]) vr = 1;
    }
    node->cb[0] = node->cb[1] = vb;
    node->cr[0] = node->cr[1] = vr;
    return;
  }
  int x = node->x, y = node->y;
  int ssx = E.chromaShiftX(), ssy = E.chromaShiftY();
  int cn = 1 << (l2 - ssx);
  int nSub = idc == 2 ? 2 : 1;
  int cx = x >> ssx, cy0 = y >> ssy;
  int cmode = idc == 2 ? kChroma422AngleMap[mode] : mode;
  node->hasChroma = true;
  node->nSub = nSub;
  int maxv = (1 << E.bd) - 1;
  static thread_local int32_t pred[32 * 32], resi[32 * 32];
  for (int comp = 1; comp <= 2; comp++) {
    node->ch[comp] = new TtNode::CTu[nSub];
    for (int s = 0; s < nSub; s++) {
      int cy = cy0 + s * cn;
      intraPredFull(E, comp, cx, cy, cn, cmode, pred);
      const int stride = E.planeW[comp];
      for (int j = 0; j < cn; j++)
        for (int i = 0; i < cn; i++)
          resi[j * cn + i] = E.orig[comp][(size_t)(cy + j) * stride + cx + i] -
                             pred[j * cn + i];
      int cscan = mdcsScan(E, cn, cmode, comp);
      TuOut tu;
      tuFwd(E, resi, cn, false, comp, cscan, true, &tu);
      for (int j = 0; j < cn; j++)
        for (int i = 0; i < cn; i++) {
          int v = pred[j * cn + i] + tu.rec[j * cn + i];
          E.recon[comp][(size_t)(cy + j) * stride + cx + i] =
              v < 0 ? 0 : (v > maxv ? maxv : v);
        }
      auto& e = node->ch[comp][s];
      std::memcpy(e.lev, tu.lev, (size_t)cn * cn * sizeof(int32_t));
      e.cbf = tu.cbf;
      e.ts = tu.ts;
      e.scan = cscan;
    }
  }
  node->cb[0] = node->ch[1][0].cbf;
  node->cb[1] = node->ch[1][nSub - 1].cbf;
  node->cr[0] = node->ch[2][0].cbf;
  node->cr[1] = node->ch[2][nSub - 1].cbf;
  if (node->split) {
    for (int k = 0; k < 4; k++) {
      node->kids[k]->cb[0] = node->kids[k]->cb[1] = 0;
      node->kids[k]->cr[0] = node->kids[k]->cr[1] = 0;
    }
  }
}

static void writeCbfChroma(Ctx& E, int log2size, int trDepth,
                           int v0, int v1, int lowest) {
  int ctx = 5 + trDepth;
  if (E.cfmt != 2) {
    E.recBin(B_QT_CBF, ctx, v0);
    return;
  }
  bool canQuad = (log2size - 1) >= 3;
  if (lowest || !canQuad) {
    E.recBin(B_QT_CBF, ctx, v0);
    E.recBin(B_QT_CBF, ctx, v1);
  } else {
    E.recBin(B_QT_CBF, ctx, v0);
  }
}

static void maybeWriteDqp(Ctx& E, bool anyCbf) {
  // cu_qp_delta_abs/sign at the first coded leaf of the quantization
  // group (encoder.py _maybe_write_dqp; decoder _parse_cu_qp_delta)
  if (!E.dqpEnabled || E.dqpCoded || !anyCbf) return;
  int v = E.curQp - E.qpPredEnc;
  int m = v < 0 ? -v : v;
  E.recBin(B_DQP, 0, m ? 1 : 0);
  if (m) {
    int k = 1;
    while (k < 5 && k < m) { E.recBin(B_DQP, 1, 1); k++; }
    if (m < 5) E.recBin(B_DQP, 1, 0);
    else E.recEg(m - 5, 0);
    E.recBypass(v < 0 ? 1 : 0);
  }
  E.cuDeltaEnc = v;
  E.dqpCoded = true;
}

static void finishCuQp(Ctx& E, int x, int y, int size) {
  // CU-final QP map entry + predictor state (encoder.py _finish_cu_qp)
  int qp = E.curQp;
  if (E.dqpEnabled) {
    qp = E.cuDeltaEnc ? ((E.qpPredEnc + E.cuDeltaEnc + 52) % 52)
                      : E.qpPredEnc;
    E.lastQpEnc = qp;
  }
  E.setRect8(E.qpMap, x, y, size, size, qp);
}

static void intraTtEmit(Ctx& E, TtNode* node, int minTu, const int parentCb[2],
                        const int parentCr[2], int blkIdx,
                        TtNode::CTu* const* parentChroma) {
  int idc = E.cfmt;
  int l2 = node->l2, depth = node->depth;
  bool subdiv = node->split;
  if (subdivCoded(E, l2, minTu)) E.recBin(B_SUBDIV, 5 - l2, subdiv ? 1 : 0);
  int cb[2] = {parentCb[0], parentCb[1]};
  int cr[2] = {parentCr[0], parentCr[1]};
  if (idc != 0 && (l2 > 2 || idc == 3)) {
    cb[0] = node->cb[0]; cb[1] = node->cb[1];
    cr[0] = node->cr[0]; cr[1] = node->cr[1];
    int lowest = subdiv ? 0 : 1;
    if (depth == 0 || parentCb[0] || parentCb[1])
      writeCbfChroma(E, l2, depth, cb[0], cb[1], lowest);
    else { cb[0] = cb[1] = 0; }
    if (depth == 0 || parentCr[0] || parentCr[1])
      writeCbfChroma(E, l2, depth, cr[0], cr[1], lowest);
    else { cr[0] = cr[1] = 0; }
  }
  if (subdiv) {
    TtNode::CTu* const* held =
        node->hasChroma ? node->ch : nullptr;
    for (int i = 0; i < 4; i++)
      intraTtEmit(E, node->kids[i], minTu, cb, cr, i, held);
    return;
  }
  int size = 1 << l2;
  int cbf = node->cbf;
  E.recBin(B_QT_CBF, depth == 0 ? 1 : 0, cbf);
  maybeWriteDqp(E, cbf || cb[0] || cb[1] || cr[0] || cr[1]);
  if (cbf)
    encodeResidual(E, node->lev, size, size, 0, node->scan, E.sdh, node->ts);
  bool chromaHere = idc != 0 && (l2 - E.chromaShiftX()) >= 2;
  TtNode::CTu* const* ch = nullptr;
  if (chromaHere && node->hasChroma) ch = node->ch;
  else if (idc != 0 && !chromaHere && blkIdx == 3) ch = parentChroma;
  if (ch) {
    int cn = 0;  // derive from the holder's level array use below
    for (int comp = 1; comp <= 2; comp++) {
      if (!ch[comp]) continue;
      int nSub = E.cfmt == 2 ? 2 : 1;
      for (int s = 0; s < nSub; s++) {
        auto& e = ch[comp][s];
        if (e.cbf) {
          // chroma TB size: for a chroma-holding leaf it is the node's
          // own size >> ssx; for the 4th-child inherited case it is the
          // parent 8x8 node's chroma TB (4x4)
          int holderL2 = chromaHere ? l2 : (l2 + 1);
          cn = 1 << (holderL2 - E.chromaShiftX());
          encodeResidual(E, e.lev, cn, cn, comp, e.scan, E.sdh, e.ts);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// intra luma mode RD trial (encoder.py _intra_mode_rd_trial)
// ---------------------------------------------------------------------------
static double intraModeRdTrial(Ctx& E, int x, int y, int size, int mode,
                               const int mpm[3], const int32_t* pred) {
  size_t mark = E.ops.size();
  recordLumaModeBins(E, mode, mpm);
  static thread_local int32_t resi[64 * 64];
  const int stride = E.planeW[0];
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++)
      resi[j * size + i] =
          E.orig[0][(size_t)(y + j) * stride + x + i] - pred[j * size + i];
  int scan = mdcsScan(E, size, mode, 0);
  TuOut tu;
  tuFwd(E, resi, size, size == 4, 0, scan, true, &tu);
  E.recBin(B_QT_CBF, 1, tu.cbf);
  double bits;
  if (tu.cbf)
    bits = residualTrialBits(E, tu.lev, size, 0, scan, mark, tu.ts);
  else
    bits = E.estOpsBits(mark);
  int maxv = (1 << E.bd) - 1;
  long long sse = 0;
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++) {
      int v = pred[j * size + i] + tu.rec[j * size + i];
      v = v < 0 ? 0 : (v > maxv ? maxv : v);
      long long d = (long long)E.orig[0][(size_t)(y + j) * stride + x + i] - v;
      sse += d * d;
    }
  double norm = (double)(1 << (2 * (E.bd - 8)));
  double cost = (double)sse / norm + E.rdLambda * bits;
  E.truncate(mark);
  return cost;
}

// encoder.py _select_intra_luma_mode.  treeMinTu < 0 means "None".
static int selectIntraLumaMode(Ctx& E, int x, int y, int size,
                               const int mpm[3], const AllPreds& all,
                               int treeMinTu) {
  const int stride = E.planeW[0];
  static thread_local int32_t orig[64 * 64];
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++)
      orig[j * size + i] = E.orig[0][(size_t)(y + j) * stride + x + i];
  double lamPred = E.lamPred;
  std::pair<double, int> ranked[35];
  for (int m = 0; m < 35; m++) {
    int idx = mpmIndex(mpm, m);
    int bits = idx >= 0 ? (idx == 0 ? 2 : 3) : 6;
    ranked[m] = {(double)satd32(all.at(m), orig, size, size) +
                     lamPred * bits,
                 m};
  }
  std::sort(ranked, ranked + 35);
  // (native path is always the recording coder)
  std::vector<std::pair<double, int>> scored;
  if (size > (1 << E.log2MaxTb)) {
    if (treeMinTu < 0) return ranked[0].second;
    for (int i = 0; i < 3; i++)
      scored.push_back({ranked[i].first, ranked[i].second});
    for (int i = 0; i < 3; i++) {
      bool have = false;
      for (auto& s : scored)
        if (s.second == mpm[i]) have = true;
      if (!have)
        scored.push_back({std::numeric_limits<double>::infinity(), mpm[i]});
    }
  } else {
    std::vector<int> cand;
    int top = size <= 8 ? 8 : 3;
    for (int i = 0; i < top; i++) cand.push_back(ranked[i].second);
    for (int i = 0; i < 3; i++) {
      if (std::find(cand.begin(), cand.end(), mpm[i]) == cand.end())
        cand.push_back(mpm[i]);
    }
    for (int m : cand)
      scored.push_back({intraModeRdTrial(E, x, y, size, m, mpm, all.at(m)),
                        m});
    std::sort(scored.begin(), scored.end());
    if (treeMinTu < 0 || scored.size() < 2) return scored[0].second;
  }
  // stage 3: joint (mode, transform-tree) RD over the top candidates
  int log2size = bitLength((unsigned)size) - 1;
  int bestMode = -1;
  double bestCost = std::numeric_limits<double>::infinity();
  size_t ncand = (size_t)E.intraRdCands;
  if (size > (1 << E.log2MaxTb)) ncand = scored.size();
  if (ncand > scored.size()) ncand = scored.size();
  for (size_t i = 0; i < ncand; i++) {
    int m = scored[i].second;
    CuSnap st;
    saveCu(E, x, y, size, &st);
    size_t mark = E.ops.size();
    recordLumaModeBins(E, m, mpm);
    curCuLog2ForTt = log2size;
    TtNode* t = intraTtDecide(E, x, y, log2size, 0, m, treeMinTu);
    delete t;
    double c = lumaRdCost(E, x, y, size, mark);
    restoreCu(E, st);
    if (c < bestCost) { bestCost = c; bestMode = m; }
  }
  return bestMode;
}

// encoder.py _select_chroma_intra_mode (4:2:0 / 4:4:4; native path never
// runs 4:2:2).  Returns (mode, dm, idx) packed.
struct ChromaChoice { int mode; bool dm; int idx; };

static ChromaChoice selectChromaIntraMode(Ctx& E, int x, int y, int size,
                                          int lumaMode) {
  if (E.cfmt == 0) return {lumaMode, true, 0};
  int allowed[4] = {PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX};
  for (int i = 0; i < 4; i++)
    if (allowed[i] == lumaMode) { allowed[i] = 34; break; }
  bool is422 = E.cfmt == 2;
  int ssx = E.chromaShiftX(), ssy = E.chromaShiftY();
  int n = size >> ssx;
  int nSub = is422 ? 2 : 1;
  int cx = x >> ssx, cy0 = y >> ssy;
  int maxv = (1 << E.bd) - 1;
  double norm = (double)(1 << (2 * (E.bd - 8)));
  // snapshot the chroma recon rect
  std::vector<int32_t> snaps[2];
  for (int c = 1; c <= 2; c++) {
    snaps[c - 1].resize((size_t)nSub * n * n);
    for (int j = 0; j < nSub * n; j++)
      std::memcpy(&snaps[c - 1][(size_t)j * n],
                  E.recon[c] + (size_t)(cy0 + j) * E.planeW[c] + cx,
                  (size_t)n * sizeof(int32_t));
  }
  size_t mark = E.ops.size();
  ChromaChoice best = {lumaMode, true, 0};
  double bestCost = std::numeric_limits<double>::infinity();
  static thread_local int32_t pred[64 * 64], resi[32 * 32];
  for (int k = 0; k < 5; k++) {
    bool dm = k == 0;
    int cand = dm ? lumaMode : allowed[k - 1];
    if (!dm && cand == lumaMode) continue;
    int cmode = is422 ? kChroma422AngleMap[cand] : cand;
    E.recBin(B_CHROMA_MODE, 0, dm ? 0 : 1);
    if (!dm) E.recBypassBins(k - 1, 2);
    double cost = 0.0;
    int tb = std::min(n, 1 << E.log2MaxTb);
    for (int comp = 1; comp <= 2; comp++) {
      const int stride = E.planeW[comp];
      for (int s = 0; s < nSub; s++)
        for (int qy = 0; qy < n; qy += tb)
          for (int qx = 0; qx < n; qx += tb) {
            int cy = cy0 + s * n + qy;
            int cxq = cx + qx;
            intraPredFull(E, comp, cxq, cy, tb, cmode, pred);
            for (int j = 0; j < tb; j++)
              for (int i = 0; i < tb; i++)
                resi[j * tb + i] =
                    E.orig[comp][(size_t)(cy + j) * stride + cxq + i] -
                    pred[j * tb + i];
            int cscan = mdcsScan(E, tb, cmode, comp);
            TuOut tu;
            tuFwd(E, resi, tb, false, comp, cscan, true, &tu);
            long long sse = 0;
            for (int j = 0; j < tb; j++)
              for (int i = 0; i < tb; i++) {
                int v = pred[j * tb + i] + tu.rec[j * tb + i];
                v = v < 0 ? 0 : (v > maxv ? maxv : v);
                E.recon[comp][(size_t)(cy + j) * stride + cxq + i] = v;
                long long d =
                    (long long)E.orig[comp][(size_t)(cy + j) * stride +
                                            cxq + i] - v;
                sse += d * d;
              }
            double bits = tu.cbf
                ? residualTrialBits(E, tu.lev, tb, comp, cscan,
                                    E.ops.size(), tu.ts)
                : 0.0;
            cost += E.cw[comp] * ((double)sse / norm) + E.rdLambda * bits;
          }
    }
    cost += E.rdLambda * E.estOpsBits(mark);
    E.truncate(mark);
    if (cost < bestCost) {
      bestCost = cost;
      best = {cand, dm, dm ? 0 : k - 1};
    }
  }
  for (int c = 1; c <= 2; c++)
    for (int j = 0; j < nSub * n; j++)
      std::memcpy(E.recon[c] + (size_t)(cy0 + j) * E.planeW[c] + cx,
                  &snaps[c - 1][(size_t)j * n], (size_t)n * sizeof(int32_t));
  return best;
}

static void writeChromaMode(Ctx& E, int x, int y, int size, int lumaMode,
                            const ChromaChoice& cc) {
  if (E.cfmt == 0) return;
  E.recBin(B_CHROMA_MODE, 0, cc.dm ? 0 : 1);
  if (!cc.dm) E.recBypassBins(cc.idx, 2);
  int real = cc.dm ? lumaMode : cc.mode;
  E.setRect8(E.intraC, x, y, size, size, real);
  E.setRect8(E.chromaDm, x, y, size, size, cc.dm ? 1 : 0);
}

// ---------------------------------------------------------------------------
// intra CU paths (encoder.py _encode_cu_intra_*)
// ---------------------------------------------------------------------------
static void maybeWriteSubdiv(Ctx& E, int log2size, int value, int minTu) {
  if (log2size > E.log2MaxTb) return;
  if (log2size == E.log2MinTb || log2size == minTu) return;
  E.recBin(B_SUBDIV, 5 - log2size, value);
}

static bool intraRqtEligible(const Ctx& E, int log2size) {
  return E.maxTrIntra > 0 && log2size - 1 >= E.log2MinTb &&
         log2size <= E.log2MaxTb;
}

static void cuIntra2N(Ctx& E, int x, int y, int log2size);
static void cuIntra2NRqt(Ctx& E, int x, int y, int log2size);

// encoder.py _encode_cu_intra_2nx2n (the no-RQT flat path)
static void cuIntra2NPlain(Ctx& E, int x, int y, int log2size) {
  int size = 1 << log2size;
  E.setRect8(E.partSize, x, y, size, size, SIZE_2Nx2N);
  int mpm[3];
  intraMpm(E, x, y, mpm);
  AllPreds all;
  predictAllModes(E, 0, x, y, size, &all);
  int mode = selectIntraLumaMode(E, x, y, size, mpm, all, -1);
  E.setRect8(E.intraY, x, y, size, size, mode);
  if (log2size == E.log2MinCb) E.recBin(B_PART, 0, 1);
  recordLumaModeBins(E, mode, mpm);
  ChromaChoice cc = selectChromaIntraMode(E, x, y, size, mode);
  writeChromaMode(E, x, y, size, mode, cc);
  int cReal = cc.dm ? mode : cc.mode;
  bool is422 = E.cfmt == 2;
  int maxv = (1 << E.bd) - 1;
  // per-component transform + recon (sub-TU layout; 420: one sub each)
  struct CompRes {
    TuOut tu[2];
    int scan[2];
    int nSub;
  } res[3];
  static thread_local int32_t pred[64 * 64], resi[64 * 64];
  for (int comp = 0; comp < E.ncomp(); comp++) {
    int ssx = comp ? E.chromaShiftX() : 0;
    int ssy = comp ? E.chromaShiftY() : 0;
    int n = size >> ssx;
    int nSub = (comp && is422) ? 2 : 1;
    int cx = x >> ssx;
    int cmode = comp == 0 ? mode : cReal;
    if (comp && is422) cmode = kChroma422AngleMap[cReal];
    res[comp].nSub = nSub;
    int tuScan = SCAN_DIAG;
    if (n <= (8 >> ssx) && n <= (8 >> ssy)) {
      if (std::abs(cmode - 26) <= 4) tuScan = SCAN_HOR;
      else if (std::abs(cmode - 10) <= 4) tuScan = SCAN_VER;
    }
    const int stride = E.planeW[comp];
    for (int s = 0; s < nSub; s++) {
      int cy = (y >> ssy) + s * n;
      intraPredFull(E, comp, cx, cy, n, cmode, pred);
      for (int j = 0; j < n; j++)
        for (int i = 0; i < n; i++)
          resi[j * n + i] =
              E.orig[comp][(size_t)(cy + j) * stride + cx + i] -
              pred[j * n + i];
      bool useDst = comp == 0 && n == 4;
      tuFwd(E, resi, n, useDst, comp, tuScan, true, &res[comp].tu[s]);
      for (int j = 0; j < n; j++)
        for (int i = 0; i < n; i++) {
          int v = pred[j * n + i] + res[comp].tu[s].rec[j * n + i];
          E.recon[comp][(size_t)(cy + j) * stride + cx + i] =
              v < 0 ? 0 : (v > maxv ? maxv : v);
        }
      res[comp].scan[s] = tuScan;
    }
  }
  curCuLog2ForTt = log2size;
  maybeWriteSubdiv(E, log2size, 0, ttMinTu(E, log2size, true));
  if (E.ncomp() > 1) {
    for (int s = 0; s < res[1].nSub; s++)
      E.recBin(B_QT_CBF, 5, res[1].tu[s].cbf);
    for (int s = 0; s < res[2].nSub; s++)
      E.recBin(B_QT_CBF, 5, res[2].tu[s].cbf);
  }
  E.recBin(B_QT_CBF, 1, res[0].tu[0].cbf);
  bool anyChroma = false;
  if (E.ncomp() > 1)
    for (int c = 1; c <= 2; c++)
      for (int s = 0; s < res[c].nSub; s++) anyChroma |= res[c].tu[s].cbf;
  maybeWriteDqp(E, res[0].tu[0].cbf || anyChroma);
  for (int comp = 0; comp < E.ncomp(); comp++) {
    int ssx = comp ? E.chromaShiftX() : 0;
    int ssy = comp ? E.chromaShiftY() : 0;
    int n = size >> ssx;
    int smode = comp == 0 ? mode : cReal;
    if (comp && is422) smode = kChroma422AngleMap[cReal];
    for (int s = 0; s < res[comp].nSub; s++) {
      if (!res[comp].tu[s].cbf) continue;
      int scan = SCAN_DIAG;
      if (n <= (8 >> ssx) && n <= (8 >> ssy)) {
        if (std::abs(smode - 26) <= 4) scan = SCAN_HOR;
        else if (std::abs(smode - 10) <= 4) scan = SCAN_VER;
      }
      encodeResidual(E, res[comp].tu[s].lev, n, n, comp, scan, E.sdh,
                     res[comp].tu[s].ts);
    }
  }
  // the Python plain path does not write pic.cbf_y (intra deblocking
  // strength does not consult it) — mirrored here
  finishCuQp(E, x, y, size);
}

// encoder.py _encode_cu_intra_2nx2n_rqt
static void cuIntra2NRqt(Ctx& E, int x, int y, int log2size) {
  int size = 1 << log2size;
  E.setRect8(E.partSize, x, y, size, size, SIZE_2Nx2N);
  E.setRect8(E.predMode, x, y, size, size, MODE_INTRA);
  int mpm[3];
  intraMpm(E, x, y, mpm);
  AllPreds all;
  predictAllModes(E, 0, x, y, size, &all);
  curCuLog2ForTt = log2size;
  int minTu = ttMinTu(E, log2size, true);
  int mode = selectIntraLumaMode(E, x, y, size, mpm, all, minTu);
  E.setRect8(E.intraY, x, y, size, size, mode);
  E.setRect8(E.intraC, x, y, size, size, mode);
  E.markEdges(x, y, size);
  if (log2size == E.log2MinCb) E.recBin(B_PART, 0, 1);
  recordLumaModeBins(E, mode, mpm);
  ChromaChoice cc = selectChromaIntraMode(E, x, y, size, mode);
  writeChromaMode(E, x, y, size, mode, cc);
  int cReal = cc.dm ? mode : cc.mode;
  curCuLog2ForTt = log2size;
  size_t mark = E.ops.size();
  TtNode* tree = intraTtDecide(E, x, y, log2size, 0, mode, minTu);
  E.truncate(mark);  // luma-only trial syntax
  intraTtChroma(E, tree, cReal);
  int zero2[2] = {0, 0};
  intraTtEmit(E, tree, minTu, zero2, zero2, 0, nullptr);
  delete tree;
  finishCuQp(E, x, y, size);
}

// encoder.py _encode_cu_intra_nxn
static void cuIntraNxN(Ctx& E, int x, int y, int log2size) {
  int size = 1 << log2size;
  int half = size >> 1;
  bool is422 = E.cfmt == 2;
  int maxv = (1 << E.bd) - 1;
  int puPos[4][2] = {{x, y}, {x + half, y}, {x, y + half},
                     {x + half, y + half}};
  E.setRect8(E.partSize, x, y, size, size, SIZE_NxN);
  E.recBin(B_PART, 0, 0);  // NxN
  int modes[4], mpms[4][3];
  TuOut lum[4];
  int lumScan[4];
  static thread_local int32_t pred[32 * 32], resi[32 * 32];
  for (int j4 = 0; j4 < 4; j4++) {
    int px = puPos[j4][0], py = puPos[j4][1];
    intraMpm(E, px, py, mpms[j4]);
    AllPreds all;
    predictAllModes(E, 0, px, py, half, &all);
    int mode = selectIntraLumaMode(E, px, py, half, mpms[j4], all, -1);
    E.setRect8(E.intraY, px, py, half, half, mode);
    intraPredFull(E, 0, px, py, half, mode, pred);
    const int stride = E.planeW[0];
    for (int j = 0; j < half; j++)
      for (int i = 0; i < half; i++)
        resi[j * half + i] =
            E.orig[0][(size_t)(py + j) * stride + px + i] -
            pred[j * half + i];
    bool useDst = half == 4;
    int scan = pickScanNxN(half, mode, 0, 0);
    tuFwd(E, resi, half, useDst, 0, scan, true, &lum[j4]);
    for (int j = 0; j < half; j++)
      for (int i = 0; i < half; i++) {
        int v = pred[j * half + i] + lum[j4].rec[j * half + i];
        E.recon[0][(size_t)(py + j) * stride + px + i] =
            v < 0 ? 0 : (v > maxv ? maxv : v);
      }
    E.setRect8(E.cbfY, px, py, half, half, lum[j4].cbf);
    E.markTuEdges(px, py, half);
    modes[j4] = mode;
    lumScan[j4] = scan;
  }
  for (int j = 0; j < 4; j++)
    E.recBin(B_MPM, 0, mpmIndex(mpms[j], modes[j]) >= 0 ? 1 : 0);
  for (int j = 0; j < 4; j++) {
    int idx = mpmIndex(mpms[j], modes[j]);
    if (idx >= 0) {
      if (idx == 0) E.recBypass(0);
      else {
        E.recBypass(1);
        E.recBypass(idx - 1);
      }
    } else {
      int rem = modes[j];
      int s3[3] = {mpms[j][0], mpms[j][1], mpms[j][2]};
      std::sort(s3, s3 + 3, std::greater<int>());
      for (int p : s3)
        if (rem > p) rem--;
      E.recBypassBins(rem, 5);
    }
  }
  bool hasChroma = E.cfmt != 0;
  int cReal = modes[0];
  if (hasChroma) {
    ChromaChoice cc = selectChromaIntraMode(E, x, y, size, modes[0]);
    writeChromaMode(E, x, y, size, modes[0], cc);
    cReal = cc.dm ? modes[0] : cc.mode;
  }
  TuOut cTu[3][2];
  int cScan = SCAN_DIAG;
  int nSub = is422 ? 2 : 1;
  if (hasChroma) {
    int ssx = E.chromaShiftX(), ssy = E.chromaShiftY();
    int n = size >> ssx;
    int cmode = is422 ? kChroma422AngleMap[cReal] : cReal;
    cScan = pickScanNxN(n, cmode, ssx, ssy);
    int cx = x >> ssx, cy0 = y >> ssy;
    for (int comp = 1; comp <= 2; comp++) {
      const int stride = E.planeW[comp];
      for (int s = 0; s < nSub; s++) {
        int cy = cy0 + s * n;
        intraPredFull(E, comp, cx, cy, n, cmode, pred);
        for (int j = 0; j < n; j++)
          for (int i = 0; i < n; i++)
            resi[j * n + i] =
                E.orig[comp][(size_t)(cy + j) * stride + cx + i] -
                pred[j * n + i];
        tuFwd(E, resi, n, false, comp, cScan, true, &cTu[comp][s]);
        for (int j = 0; j < n; j++)
          for (int i = 0; i < n; i++) {
            int v = pred[j * n + i] + cTu[comp][s].rec[j * n + i];
            E.recon[comp][(size_t)(cy + j) * stride + cx + i] =
                v < 0 ? 0 : (v > maxv ? maxv : v);
          }
      }
    }
  }
  if (hasChroma) {
    for (int comp = 1; comp <= 2; comp++)
      for (int s = 0; s < nSub; s++)
        E.recBin(B_QT_CBF, 5, cTu[comp][s].cbf);
  }
  bool anyC = false;
  if (hasChroma)
    for (int comp = 1; comp <= 2; comp++)
      for (int s = 0; s < nSub; s++) anyC |= cTu[comp][s].cbf;
  int ssxC = E.chromaShiftX();
  int nC = size >> ssxC;
  for (int j = 0; j < 4; j++) {
    E.recBin(B_QT_CBF, 0, lum[j].cbf);
    maybeWriteDqp(E, lum[j].cbf || anyC);
    if (lum[j].cbf)
      encodeResidual(E, lum[j].lev, half, half, 0, lumScan[j], E.sdh,
                     lum[j].ts);
    if (j == 3 && hasChroma) {
      for (int comp = 1; comp <= 2; comp++)
        for (int s = 0; s < nSub; s++)
          if (cTu[comp][s].cbf)
            encodeResidual(E, cTu[comp][s].lev, nC, nC, comp, cScan, E.sdh,
                           cTu[comp][s].ts);
    }
  }
  finishCuQp(E, x, y, size);
}

// encoder.py _encode_cu_intra_2nx2n dispatch
static void cuIntra2N(Ctx& E, int x, int y, int log2size) {
  if (log2size > E.log2MaxTb || intraRqtEligible(E, log2size)) {
    cuIntra2NRqt(E, x, y, log2size);
    return;
  }
  cuIntra2NPlain(E, x, y, log2size);
}

// encoder.py _encode_cu_intra_body (PCM gated off in native eligibility)
static void cuIntraBody(Ctx& E, int x, int y, int log2size, int depth) {
  int size = 1 << log2size;
  E.setRect8(E.depth, x, y, size, size, depth);
  E.setRect8(E.predMode, x, y, size, size, MODE_INTRA);
  E.setRect8(E.skip, x, y, size, size, 0);
  E.markEdges(x, y, size);
  if (log2size == E.log2MinCb && E.rdoCu && E.cfmt != 3) {
    CuSnap st;
    saveCu(E, x, y, size, &st);
    cuIntra2N(E, x, y, log2size);
    double cost2n = cuRdCost(E, x, y, size, st.nops);
    restoreCu(E, st);
    cuIntraNxN(E, x, y, log2size);
    double costNn = cuRdCost(E, x, y, size, st.nops);
    if (cost2n <= costNn) {
      restoreCu(E, st);
      cuIntra2N(E, x, y, log2size);
    }
    return;
  }
  cuIntra2N(E, x, y, log2size);
}

// encoder.py encode_cu for I slices (no bypass flag / PCM natively)
static void encodeCuIntra(Ctx& E, int x, int y, int log2size, int depth) {
  cuIntraBody(E, x, y, log2size, depth);
}

void encodeCuInter(Ctx& E, int x, int y, int log2size, int depth);  // fwd

// encoder.py encode_cqt
static int splitCtx(const Ctx& E, int x, int y, int depth) {
  int ctx = 0;
  if (E.available(x - 1, y, x, y, false) &&
      E.depth[E.mi(x - 1, y)] > depth)
    ctx++;
  if (E.available(x, y - 1, x, y, false) &&
      E.depth[E.mi(x, y - 1)] > depth)
    ctx++;
  return ctx;
}

static void encodeLeaf(Ctx& E, int x, int y, int log2size, int depth) {
  if (E.sliceType == 0 || E.sliceType == 1)
    encodeCuInter(E, x, y, log2size, depth);
  else
    encodeCuIntra(E, x, y, log2size, depth);
}

static void encodeCqt(Ctx& E, int x, int y, int log2size, int depth) {
  int size = 1 << log2size;
  bool inside = (x + size <= E.width) && (y + size <= E.height);
  int targetLog2 = std::max(
      E.log2MinCb,
      std::min(log2size, bitLength((unsigned)E.cuSizeTarget) - 1));
  bool wantSplit = log2size > targetLog2;

  if (inside && !wantSplit && log2size > E.log2MinCb && E.rdoCu) {
    CuSnap st;
    saveCu(E, x, y, size, &st);
    E.recBin(B_SPLIT, splitCtx(E, x, y, depth), 0);
    encodeLeaf(E, x, y, log2size, depth);
    double costLeaf = cuRdCost(E, x, y, size, st.nops);
    CuSnap leafState;
    saveCu(E, x, y, size, &leafState);
    OpsSlice leafOps = E.saveOps(st.nops);
    restoreCu(E, st);
    E.recBin(B_SPLIT, splitCtx(E, x, y, depth), 1);
    {
      int h2 = size >> 1;
      static const int off[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
      for (int k = 0; k < 4; k++) {
        int nx = x + off[k][0] * h2, ny = y + off[k][1] * h2;
        if (nx < E.width && ny < E.height)
          encodeCqt(E, nx, ny, log2size - 1, depth + 1);
      }
    }
    double costSplit = cuRdCost(E, x, y, size, st.nops);
    if (costLeaf <= costSplit) {
      restoreCu(E, st);
      E.reinstate(leafOps);
      applyMapsRecon(E, leafState);
    }
    return;
  }
  bool split;
  if (inside && log2size > E.log2MinCb) {
    E.recBin(B_SPLIT, splitCtx(E, x, y, depth), wantSplit ? 1 : 0);
    split = wantSplit;
  } else {
    split = log2size > E.log2MinCb;  // forced at boundary
  }
  if (split) {
    int h = size >> 1;
    static const int off[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
    for (int k = 0; k < 4; k++) {
      int nx = x + off[k][0] * h, ny = y + off[k][1] * h;
      if (nx < E.width && ny < E.height)
        encodeCqt(E, nx, ny, log2size - 1, depth + 1);
    }
    return;
  }
  encodeLeaf(E, x, y, log2size, depth);
}

// inter CU compress — implemented in the inter section below
void encodeCuInter(Ctx& E, int x, int y, int log2size, int depth);

}  // namespace encctu
}  // namespace hevc

// ---------------------------------------------------------------------------
// C API (ctypes bridge: encoder.py _native_compress_*)
// ---------------------------------------------------------------------------
extern "C" {

// iargs layout — MUST match encoder.py _native_ctx_args
enum {
  EI_WIDTH = 0, EI_HEIGHT, EI_BD, EI_CFMT, EI_LOG2CTB, EI_LOG2MINCB,
  EI_LOG2MINTB, EI_LOG2MAXTB, EI_MAXTRINTRA, EI_MAXTRINTER, EI_AMP,
  EI_STRONGSMOOTH, EI_SMOOTHDIS, EI_SDH, EI_RDOQ, EI_TSEN, EI_SLICETYPE,
  EI_QP, EI_NUMREF0, EI_NUMREF1, EI_MAXMERGE, EI_SEARCHRANGE, EI_FASTSEARCH,
  EI_TMVP, EI_COLFROML0, EI_COLREFIDX, EI_POC, EI_RDOCU, EI_CUSIZE,
  EI_INTRARDCANDS, EI_RDPARTS, EI_RDUNI, EI_W4, EI_H4, EI_NCTBX,
  EI_ALLREFSBEFORE, EI_LOG2PARMRG, EI_MVDL1ZERO, EI_FASTENC, EI_DQPEN,
  EI_N_IARGS
};
enum { ED_RDLAMBDA = 0, ED_LAMMOTION, ED_LAMPRED, ED_CW1, ED_CW2,
       ED_N_DARGS };
// map pointer slots — MUST match encoder.py _native_map_ptrs
enum {
  EP_DEPTH = 0, EP_PREDMODE, EP_PARTSIZE, EP_SKIP, EP_PCM, EP_INTRAY,
  EP_INTRAC, EP_CHROMADM, EP_QP, EP_CBFY, EP_EDGE, EP_INTERDIR, EP_MV,
  EP_REFIDX, EP_REFPOC, EP_REFISLT, EP_SLICEIDX, EP_ZMAP, EP_TILEMAP,
  EP_ORIG0, EP_ORIG1, EP_ORIG2, EP_RECON0, EP_RECON1, EP_RECON2,
  EP_NEXTMPS, EP_NEXTLPS, EP_PLANEW0, EP_PLANEH0, EP_PLANEW1, EP_PLANEH1,
  EP_N_PTRS
};

void* enc_ctu_create(const int64_t* ia, const double* da, const int64_t* mp,
                     const int64_t* bankp) {
  using namespace hevc::encctu;
  Ctx* E = new Ctx();
  E->width = (int)ia[EI_WIDTH]; E->height = (int)ia[EI_HEIGHT];
  E->bd = (int)ia[EI_BD]; E->cfmt = (int)ia[EI_CFMT];
  E->log2Ctb = (int)ia[EI_LOG2CTB]; E->log2MinCb = (int)ia[EI_LOG2MINCB];
  E->log2MinTb = (int)ia[EI_LOG2MINTB]; E->log2MaxTb = (int)ia[EI_LOG2MAXTB];
  E->maxTrIntra = (int)ia[EI_MAXTRINTRA];
  E->maxTrInter = (int)ia[EI_MAXTRINTER];
  E->ampEnabled = (int)ia[EI_AMP];
  E->strongSmoothing = (int)ia[EI_STRONGSMOOTH];
  E->smoothingDisabled = (int)ia[EI_SMOOTHDIS];
  E->sdh = (int)ia[EI_SDH]; E->rdoqOn = (int)ia[EI_RDOQ];
  E->tsEnabled = (int)ia[EI_TSEN];
  E->sliceType = (int)ia[EI_SLICETYPE]; E->qp = (int)ia[EI_QP];
  E->numRef[0] = (int)ia[EI_NUMREF0]; E->numRef[1] = (int)ia[EI_NUMREF1];
  E->maxMerge = (int)ia[EI_MAXMERGE];
  E->searchRange = (int)ia[EI_SEARCHRANGE];
  E->fastSearch = (int)ia[EI_FASTSEARCH];
  E->tmvp = (int)ia[EI_TMVP]; E->colFromL0 = (int)ia[EI_COLFROML0];
  E->colRefIdx = (int)ia[EI_COLREFIDX]; E->poc = (int)ia[EI_POC];
  E->rdoCu = (int)ia[EI_RDOCU]; E->cuSizeTarget = (int)ia[EI_CUSIZE];
  E->intraRdCands = (int)ia[EI_INTRARDCANDS];
  E->rdParts = (int)ia[EI_RDPARTS]; E->rdUni = (int)ia[EI_RDUNI];
  E->w4 = (int)ia[EI_W4]; E->h4 = (int)ia[EI_H4];
  E->nctbX = (int)ia[EI_NCTBX];
  E->allRefsBefore = (int)ia[EI_ALLREFSBEFORE];
  E->log2ParMrg = (int)ia[EI_LOG2PARMRG];
  E->mvdL1Zero = (int)ia[EI_MVDL1ZERO];
  E->fastEnc = (int)ia[EI_FASTENC];
  E->rdLambda = da[ED_RDLAMBDA]; E->lamMotion = da[ED_LAMMOTION];
  E->lamPred = da[ED_LAMPRED];
  E->cw[0] = 1.0; E->cw[1] = da[ED_CW1]; E->cw[2] = da[ED_CW2];
  E->depth = (int8_t*)mp[EP_DEPTH];
  E->predMode = (int8_t*)mp[EP_PREDMODE];
  E->partSize = (int8_t*)mp[EP_PARTSIZE];
  E->skip = (int8_t*)mp[EP_SKIP];
  E->pcm = (int8_t*)mp[EP_PCM];
  E->intraY = (int8_t*)mp[EP_INTRAY];
  E->intraC = (int8_t*)mp[EP_INTRAC];
  E->chromaDm = (int8_t*)mp[EP_CHROMADM];
  E->qpMap = (int8_t*)mp[EP_QP];
  E->cbfY = (int8_t*)mp[EP_CBFY];
  E->edgeFlags = (uint8_t*)mp[EP_EDGE];
  E->interDir = (int8_t*)mp[EP_INTERDIR];
  E->mv = (int32_t*)mp[EP_MV];
  E->refIdx = (int8_t*)mp[EP_REFIDX];
  E->refPocM = (int32_t*)mp[EP_REFPOC];
  E->refIsLt = (int8_t*)mp[EP_REFISLT];
  E->sliceIdx = (int32_t*)mp[EP_SLICEIDX];
  E->zmap = (int64_t*)mp[EP_ZMAP];
  E->tileMap = (int32_t*)mp[EP_TILEMAP];
  for (int c = 0; c < 3; c++) {
    E->orig[c] = (int32_t*)mp[EP_ORIG0 + c];
    E->recon[c] = (int32_t*)mp[EP_RECON0 + c];
  }
  E->planeW[0] = (int)mp[EP_PLANEW0];
  E->planeH[0] = (int)mp[EP_PLANEH0];
  E->planeW[1] = E->planeW[2] = (int)mp[EP_PLANEW1];
  E->planeH[1] = E->planeH[2] = (int)mp[EP_PLANEH1];
  int ssx = E->chromaShiftX(), ssy = E->chromaShiftY();
  E->compW[0] = E->width; E->compH[0] = E->height;
  E->compW[1] = E->compW[2] = E->width >> ssx;
  E->compH[1] = E->compH[2] = E->height >> ssy;
  E->nextMps = (const int32_t*)mp[EP_NEXTMPS];
  E->nextLps = (const int32_t*)mp[EP_NEXTLPS];
  for (int s = 0; s < NSETS; s++) E->bank[s] = (int32_t*)bankp[s];
  E->dqpEnabled = (int)ia[EI_DQPEN];
  E->curQp = E->qp;
  E->lastQpEnc = E->qp;
  return E;
}

void enc_ctu_destroy(void* h) {
  delete static_cast<hevc::encctu::Ctx*>(h);
  hevc::encctu::prof::dump();
}

// scaling-list matrix for one (sizeIdx, listIdx); caller keeps the array
// alive for the context's lifetime (encoder.py _scaling_matrix tables)
void enc_ctu_set_scaling(void* h, int sizeIdx, int listIdx,
                         const int32_t* mat) {
  using namespace hevc::encctu;
  Ctx* E = static_cast<Ctx*>(h);
  if (sizeIdx < 0 || sizeIdx > 3 || listIdx < 0 || listIdx > 5) return;
  E->scalMat[sizeIdx][listIdx] = mat;
  if (mat) E->scalOn = true;
}

// per-(list, ref) weighted-prediction entry (encoder.py cur_wp/cur_wp_l1
// from wp_analysis.analyse_picture)
void enc_ctu_set_wp(void* h, int l, int r, int w0, int w1, int w2, int o0,
                    int o1, int o2, int denom, int flag) {
  using namespace hevc::encctu;
  Ctx* E = static_cast<Ctx*>(h);
  if (l < 0 || l > 1 || r < 0 || r > 15) return;
  Ctx::WpEntry& e = E->wpTab[l][r];
  e.w[0] = w0; e.w[1] = w1; e.w[2] = w2;
  e.o[0] = o0; e.o[1] = o1; e.o[2] = o2;
  e.denom = denom;
  e.flag = flag != 0;
  if (e.flag) E->wpOn = true;
}

// quantization-group start (one QG per CTU): set the CTU's target QP and
// lambdas, reset the dqp predictor chain (encoder.py ctu_qg_start)
void enc_ctu_qg_start(void* h, int qp, double rdLambda, double lamMotion,
                      double lamPred) {
  using namespace hevc::encctu;
  Ctx* E = static_cast<Ctx*>(h);
  E->curQp = qp;
  if (rdLambda > 0) {
    E->rdLambda = rdLambda;
    E->lamMotion = lamMotion;
    E->lamPred = lamPred;
  }
  E->qpPredEnc = E->lastQpEnc;
  E->dqpCoded = false;
  E->cuDeltaEnc = 0;
}

// estimated trial bits of ops[lo:] (per-LCU rate-control feedback —
// encoder.py _rc_lcu_close uses _est_ops_bits the same way)
double enc_ctu_est_bits(void* h, int64_t lo) {
  using namespace hevc::encctu;
  Ctx* E = static_cast<Ctx*>(h);
  return E->estOpsBits((size_t)lo);
}

// compress one CTU; returns the total op count afterwards (the caller's
// per-CTU marks)
int64_t enc_ctu_compress(void* h, int x, int y) {
  using namespace hevc::encctu;
  Ctx* E = static_cast<Ctx*>(h);
  E->ctuX = x; E->ctuY = y;
  encodeCqt(*E, x, y, E->log2Ctb, 0);
  return (int64_t)E->ops.size();
}

void enc_ctu_fetch_ops(void* h, uint8_t* kind, int32_t* a, int32_t* b) {
  using namespace hevc::encctu;
  Ctx* E = static_cast<Ctx*>(h);
  size_t n = E->ops.size();
  std::memcpy(kind, E->ops.kind.data(), n);
  std::memcpy(a, E->ops.a.data(), n * sizeof(int32_t));
  std::memcpy(b, E->ops.b.data(), n * sizeof(int32_t));
}

}  // extern "C"

namespace hevc {
namespace encctu {

// ===========================================================================
// Inter CU compression (encoder.py encode_cu_inter + helpers; motion
// derivation mirrors hostdec/motion.py MotionDeriver).  WP / dqp / lossless
// / non-4:2:0 are gated to the Python path by _native_ctu_eligible.
// ===========================================================================

// ---- chroma qpel/epel interpolation (motion.py _interp, taps=4, 4:2:0:
// frac_bits = 3 on both axes so the eighth-pel table indexes directly) ----
static void interpChromaE(const int16_t* ref, int W, int H, long long stride,
                          int x, int y, int w, int h, int mvx, int mvy,
                          int bd, bool isLast, int16_t* dst) {
  int fx = mvx & 7, fy = mvy & 7;
  int ix = x + (mvx >> 3), iy = y + (mvy >> 3);
  int headroom = kIfPrec - bd;
  int hr = headroom < 2 ? 2 : headroom;
  int maxv = (1 << bd) - 1;
  auto S = [&](int yy, int xx) -> int {
    yy = clip3(0, H - 1, yy);
    xx = clip3(0, W - 1, xx);
    return ref[(long long)yy * stride + xx];
  };
  const int* fh = kChromaF[fx];
  const int* fv = kChromaF[fy];
  if (fx == 0 && fy == 0) {
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++) {
        int v = S(iy + j, ix + i);
        dst[j * w + i] = (int16_t)(isLast ? v : (v << headroom) - kIfOffs);
      }
    return;
  }
  if (fy == 0) {
    int shift = 6, offset;
    if (isLast) offset = 1 << (shift - 1);
    else { shift -= hr; offset = -(kIfOffs << shift); }
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++) {
        int acc = 0;
        for (int k = 0; k < 4; k++) acc += fh[k] * S(iy + j, ix + i + k - 1);
        int v = (acc + offset) >> shift;
        dst[j * w + i] = (int16_t)(isLast ? clip3(0, maxv, v) : v);
      }
    return;
  }
  if (fx == 0) {
    int shift = 6, offset;
    if (isLast) offset = 1 << (shift - 1);
    else { shift -= hr; offset = -(kIfOffs << shift); }
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++) {
        int acc = 0;
        for (int k = 0; k < 4; k++) acc += fv[k] * S(iy + j + k - 1, ix + i);
        int v = (acc + offset) >> shift;
        dst[j * w + i] = (int16_t)(isLast ? clip3(0, maxv, v) : v);
      }
    return;
  }
  int sh1 = 6 - hr;
  int off1 = -(kIfOffs << sh1);
  static thread_local std::vector<int16_t> tmp;
  tmp.resize((size_t)(h + 3) * w);
  for (int j = 0; j < h + 3; j++)
    for (int i = 0; i < w; i++) {
      int acc = 0;
      for (int k = 0; k < 4; k++) acc += fh[k] * S(iy + j - 1, ix + i + k - 1);
      tmp[(size_t)j * w + i] = (int16_t)((acc + off1) >> sh1);
    }
  int sh2, off2;
  if (isLast) { sh2 = 6 + hr; off2 = (1 << (sh2 - 1)) + (kIfOffs << 6); }
  else { sh2 = 6; off2 = 0; }
  for (int j = 0; j < h; j++)
    for (int i = 0; i < w; i++) {
      int acc = 0;
      for (int k = 0; k < 4; k++) acc += fv[k] * tmp[(size_t)(j + k) * w + i];
      int v = (acc + off2) >> sh2;
      dst[j * w + i] = (int16_t)(isLast ? clip3(0, maxv, v) : v);
    }
}

// ---- prediction for one candidate (encoder.py _pred_from_cand incl. WP) ----
// dst: (h>>ssy) x (w>>ssx) int32, densely packed.
static void predFromCand(Ctx& E, int comp, int x, int y, int w, int h,
                         int dir, const int mvs[2][2], const int refIdx[2],
                         int32_t* dst) {
  prof::Scope _ps(prof::P_INTERPRED);
  int ssx = comp ? E.chromaShiftX() : 0;
  int ssy = comp ? E.chromaShiftY() : 0;
  int cw = w >> ssx, chh = h >> ssy;
  int cx = x >> ssx, cy = y >> ssy;
  int W = E.compW[comp], H = E.compH[comp];
  static thread_local std::vector<int16_t> p16a, p16b;
  p16a.resize((size_t)cw * chh);
  auto interp1 = [&](int l, bool isLast, int16_t* out) {
    int ri = refIdx[l] < 0 ? 0 : refIdx[l];
    if (ri >= (int)E.refs[l].size()) ri = (int)E.refs[l].size() - 1;
    const int16_t* plane = E.refs[l][ri].plane[comp];
    if (comp == 0)
      enc::interpLuma(plane, W, H, W, cx, cy, cw, chh,
                      mvs[l][0], mvs[l][1], E.bd, isLast, out);
    else
      interpChromaE(plane, W, H, W, cx, cy, cw, chh,
                    mvs[l][0], mvs[l][1], E.bd, isLast, out);
  };
  int maxv = (1 << E.bd) - 1;
  int hr = std::max(2, kIfPrec - E.bd);
  if (dir != 3) {
    int l = dir == 1 ? 0 : 1;
    const Ctx::WpEntry* wp = E.wpOf(l, refIdx[l]);
    if (!wp) {
      interp1(l, true, p16a.data());
      for (int i = 0; i < cw * chh; i++) dst[i] = p16a[i];
      return;
    }
    // weighted uni on IF-precision samples (encoder.py _pred_from_cand;
    // decoder _weighted_uni / reference addWeightUni)
    interp1(l, false, p16a.data());
    int wgt = wp->w[comp];
    int off = wp->o[comp] << (E.bd - 8);
    int shift = wp->denom + hr;
    int rnd = shift > 0 ? (1 << (shift - 1)) : 0;
    for (int i = 0; i < cw * chh; i++) {
      int v = (int)(((long long)wgt * ((int)p16a[i] + kIfOffs) + rnd)
                    >> shift) + off;
      dst[i] = clip3(0, maxv, v);
    }
    return;
  }
  p16b.resize((size_t)cw * chh);
  interp1(0, false, p16a.data());
  interp1(1, false, p16b.data());
  const Ctx::WpEntry* wp0 = E.wpOf(0, refIdx[0]);
  const Ctx::WpEntry* wp1 = E.wpOf(1, refIdx[1]);
  if (wp0 || wp1) {
    // flag-0 references carry identity weights and still take the
    // weighted rounding path (encoder.py _pred_from_cand)
    Ctx::WpEntry ident;
    ident.denom = (wp0 ? wp0 : wp1)->denom;
    ident.w[0] = ident.w[1] = ident.w[2] = 1 << ident.denom;
    if (!wp0) wp0 = &ident;
    if (!wp1) wp1 = &ident;
    int scale = 1 << (E.bd - 8);
    int o0 = wp0->o[comp] * scale;
    int o1 = wp1->o[comp] * scale;
    int shift = (wp0->denom + 1) + hr;
    long long rnd = 1LL << (shift - 1);
    long long obias = ((long long)(o0 + o1)) << (shift - 1);
    int w0 = wp0->w[comp], w1 = wp1->w[comp];
    for (int i = 0; i < cw * chh; i++) {
      long long v = ((long long)w0 * ((int)p16a[i] + kIfOffs) +
                     (long long)w1 * ((int)p16b[i] + kIfOffs) + rnd +
                     obias) >> shift;
      dst[i] = clip3(0, maxv, (int)v);
    }
    return;
  }
  int shift = kIfPrec + 1 - E.bd;
  int off = (1 << (shift - 1)) + 2 * kIfOffs;
  for (int i = 0; i < cw * chh; i++) {
    int v = ((int)p16a[i] + (int)p16b[i] + off) >> shift;
    dst[i] = clip3(0, maxv, v);
  }
}

// ---------------------------------------------------------------------------
// motion derivation (hostdec/motion.py MotionDeriver)
// ---------------------------------------------------------------------------
static void mvScaleE(const int mv[2], int tb, int td, int out[2]) {
  if (tb == td) { out[0] = mv[0]; out[1] = mv[1]; return; }
  tb = clip3(-128, 127, tb);
  td = clip3(-128, 127, td);
  int tx = (16384 + (std::abs(td) >> 1)) / td;
  int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
  long long px = (long long)dsf * mv[0];
  long long py = (long long)dsf * mv[1];
  out[0] = (int)clip3((long long)-32768, (long long)32767,
                      (px + 127 + (px < 0 ? 1 : 0)) >> 8);
  out[1] = (int)clip3((long long)-32768, (long long)32767,
                      (py + 127 + (py < 0 ? 1 : 0)) >> 8);
}

struct BlkE {
  bool ok = false;
  int dir = 0;
  int mv[2][2] = {{0, 0}, {0, 0}};
  int refIdx[2] = {-1, -1};
  int refPoc[2] = {0, 0};
  int refLt[2] = {0, 0};
};

static BlkE blkE(const Ctx& E, int x, int y, int curX, int curY,
                 bool checkZ = true) {
  BlkE b;
  if (!E.available(x, y, curX, curY, checkZ)) return b;
  size_t i = E.mi(x, y);
  if (E.predMode[i] != MODE_INTER) return b;
  b.ok = true;
  b.dir = E.interDir[i];
  for (int l = 0; l < 2; l++) {
    b.mv[l][0] = E.mv[i * 4 + l * 2];
    b.mv[l][1] = E.mv[i * 4 + l * 2 + 1];
    b.refIdx[l] = E.refIdx[i * 2 + l];
    b.refPoc[l] = E.refPocM[i * 2 + l];
    b.refLt[l] = E.refIsLt[i * 2 + l];
  }
  return b;
}

struct MergeCandE {
  int dir = 0;
  int mv[2][2] = {{0, 0}, {0, 0}};
  int refIdx[2] = {-1, -1};
  bool sameMotion(const MergeCandE& o) const {
    if (dir != o.dir) return false;
    for (int l = 0; l < 2; l++)
      if (dir & (1 << l)) {
        if (mv[l][0] != o.mv[l][0] || mv[l][1] != o.mv[l][1] ||
            refIdx[l] != o.refIdx[l])
          return false;
      }
    return true;
  }
};

static int refPocOf(const Ctx& E, int l, int idx) {
  if (E.refs[l].empty()) return 0;
  if (idx >= (int)E.refs[l].size()) idx = (int)E.refs[l].size() - 1;
  return E.refs[l][idx].poc;
}
static int refLtOf(const Ctx& E, int l, int idx) {
  if (E.refs[l].empty()) return 0;
  if (idx >= (int)E.refs[l].size()) idx = (int)E.refs[l].size() - 1;
  return E.refs[l][idx].isLt;
}

// motion.py _tmvp — returns true + out[2] on success
static bool tmvpE(const Ctx& E, int x, int y, int w, int h, int targetList,
                  int targetRefIdx, int out[2]) {
  if (!E.col.valid) return false;
  int candPos[2][2];
  int nCand = 0;
  int brX = x + w, brY = y + h;
  if ((brY >> E.log2Ctb) == (y >> E.log2Ctb) && brY < E.height &&
      brX < E.width) {
    candPos[nCand][0] = (brX >> 4) << 4;
    candPos[nCand][1] = (brY >> 4) << 4;
    nCand++;
  }
  candPos[nCand][0] = ((x + (w >> 1)) >> 4) << 4;
  candPos[nCand][1] = ((y + (h >> 1)) >> 4) << 4;
  nCand++;
  int tgtPoc = refPocOf(E, targetList, targetRefIdx);
  int tgtLt = refLtOf(E, targetList, targetRefIdx);
  for (int k = 0; k < nCand; k++) {
    int x4 = candPos[k][0] >> 2, y4 = candPos[k][1] >> 2;
    if (x4 >= E.col.w4 || y4 >= E.col.h4) continue;
    size_t i = (size_t)y4 * E.col.w4 + x4;
    if (E.col.predMode[i] != MODE_INTER) continue;
    int cdir = E.col.interDir[i];
    if (cdir == 0) continue;
    int use;
    if (!(cdir & 1)) use = 1;
    else if (!(cdir & 2)) use = 0;
    else use = E.allRefsBefore ? targetList : E.colFromL0;
    int colMv[2] = {E.col.mv[i * 4 + use * 2], E.col.mv[i * 4 + use * 2 + 1]};
    int colRefPoc = E.col.refPoc[i * 2 + use];
    int colRefLt = E.col.refIsLt[i * 2 + use] ? 1 : 0;
    if (colRefLt != (tgtLt ? 1 : 0)) continue;
    if (tgtLt) { out[0] = colMv[0]; out[1] = colMv[1]; return true; }
    int tb = E.poc - tgtPoc;
    int td = E.col.poc - colRefPoc;
    if (td == 0) { out[0] = colMv[0]; out[1] = colMv[1]; return true; }
    mvScaleE(colMv, tb, td, out);
    return true;
  }
  return false;
}

// motion.py merge_candidate_list — fills out[0..maxMerge-1], padded
static void mergeCandListE(const Ctx& E, int x, int y, int w, int h, int cx,
                           int cy, int cuSize, int puIdx, int partSize,
                           MergeCandE out[5]) {
  int plevel = E.log2ParMrg;
  if (plevel > 2 && cuSize == 8) {
    x = cx; y = cy; w = cuSize; h = cuSize;
    puIdx = 0;
    partSize = SIZE_2Nx2N;
  }
  auto parOk = [&](int nx, int ny) {
    return (x >> plevel != nx >> plevel) || (y >> plevel != ny >> plevel);
  };
  auto toCand = [](const BlkE& b) {
    MergeCandE c;
    c.dir = b.dir;
    for (int l = 0; l < 2; l++) {
      c.mv[l][0] = b.mv[l][0]; c.mv[l][1] = b.mv[l][1];
      c.refIdx[l] = b.refIdx[l];
    }
    return c;
  };
  MergeCandE cands[5];
  int n = 0;
  int maxCand = E.maxMerge;

  BlkE a1, b1;
  bool haveA1 = false, haveB1 = false;
  if (!(puIdx == 1 && (partSize == SIZE_Nx2N || partSize == SIZE_nLx2N ||
                       partSize == SIZE_nRx2N))) {
    int nx = x - 1, ny = y + h - 1;
    if (parOk(nx, ny)) { a1 = blkE(E, nx, ny, x, y, false); haveA1 = a1.ok; }
  }
  MergeCandE cA1, cB1;
  if (haveA1) { cA1 = toCand(a1); if (n < 5) cands[n++] = cA1; }
  if (!(puIdx == 1 && (partSize == SIZE_2NxN || partSize == SIZE_2NxnU ||
                       partSize == SIZE_2NxnD))) {
    int nx = x + w - 1, ny = y - 1;
    if (parOk(nx, ny)) { b1 = blkE(E, nx, ny, x, y, false); haveB1 = b1.ok; }
  }
  if (haveB1) {
    cB1 = toCand(b1);
    if (!(haveA1 && cB1.sameMotion(cA1)) && n < 5) cands[n++] = cB1;
  }
  {
    int nx = x + w, ny = y - 1;
    if (parOk(nx, ny)) {
      BlkE b0 = blkE(E, nx, ny, x, y);
      if (b0.ok) {
        MergeCandE c = toCand(b0);
        if (!(haveB1 && c.sameMotion(cB1)) && n < 5) cands[n++] = c;
      }
    }
  }
  {
    int nx = x - 1, ny = y + h;
    if (parOk(nx, ny)) {
      BlkE a0 = blkE(E, nx, ny, x, y);
      if (a0.ok) {
        MergeCandE c = toCand(a0);
        if (!(haveA1 && c.sameMotion(cA1)) && n < 5) cands[n++] = c;
      }
    }
  }
  if (n < 4) {
    int nx = x - 1, ny = y - 1;
    if (parOk(nx, ny)) {
      BlkE b2 = blkE(E, nx, ny, x, y);
      if (b2.ok) {
        MergeCandE c = toCand(b2);
        if (!(haveA1 && c.sameMotion(cA1)) &&
            !(haveB1 && c.sameMotion(cB1)) && n < 5)
          cands[n++] = c;
      }
    }
  }
  if (E.tmvp && n < maxCand && E.col.valid) {
    MergeCandE c;
    int mv0[2];
    if (tmvpE(E, x, y, w, h, 0, 0, mv0)) {
      c.dir |= 1;
      c.mv[0][0] = mv0[0]; c.mv[0][1] = mv0[1];
      c.refIdx[0] = 0;
    }
    if (E.sliceType == 0) {
      int mv1[2];
      if (tmvpE(E, x, y, w, h, 1, 0, mv1)) {
        c.dir |= 2;
        c.mv[1][0] = mv1[0]; c.mv[1][1] = mv1[1];
        c.refIdx[1] = 0;
      }
    }
    if (c.dir && n < 5) cands[n++] = c;
  }
  if (E.sliceType == 0 && n > 1 && n < maxCand) {
    static const int pairs[12][2] = {{0, 1}, {1, 0}, {0, 2}, {2, 0},
                                     {1, 2}, {2, 1}, {0, 3}, {3, 0},
                                     {1, 3}, {3, 1}, {2, 3}, {3, 2}};
    int norig = n;
    for (auto& pr : pairs) {
      if (n >= maxCand) break;
      if (pr[0] >= norig || pr[1] >= norig) break;
      const MergeCandE& ci = cands[pr[0]];
      const MergeCandE& cj = cands[pr[1]];
      if (!(ci.dir & 1) || !(cj.dir & 2)) continue;
      if (refPocOf(E, 0, ci.refIdx[0]) == refPocOf(E, 1, cj.refIdx[1]) &&
          ci.mv[0][0] == cj.mv[1][0] && ci.mv[0][1] == cj.mv[1][1])
        continue;
      MergeCandE c;
      c.dir = 3;
      c.mv[0][0] = ci.mv[0][0]; c.mv[0][1] = ci.mv[0][1];
      c.mv[1][0] = cj.mv[1][0]; c.mv[1][1] = cj.mv[1][1];
      c.refIdx[0] = ci.refIdx[0];
      c.refIdx[1] = cj.refIdx[1];
      if (n < 5) cands[n++] = c;
    }
  }
  int nref = E.sliceType == 0 ? std::min(E.numRef[0], E.numRef[1])
                              : E.numRef[0];
  int zeroIdx = 0;
  while (n < maxCand && n < 5) {
    int r = zeroIdx < nref ? zeroIdx : 0;
    MergeCandE c;
    if (E.sliceType == 0) { c.dir = 3; c.refIdx[0] = r; c.refIdx[1] = r; }
    else { c.dir = 1; c.refIdx[0] = r; c.refIdx[1] = -1; }
    c.mv[0][0] = c.mv[0][1] = c.mv[1][0] = c.mv[1][1] = 0;
    cands[n++] = c;
    zeroIdx++;
  }
  for (int i = 0; i < maxCand && i < 5; i++) out[i] = cands[i];
}

// motion.py amvp_candidates
static void amvpCandsE(const Ctx& E, int x, int y, int w, int h,
                       int targetList, int targetRefIdx, int out[2][2]) {
  int tgtPoc = refPocOf(E, targetList, targetRefIdx);
  int tgtLt = refLtOf(E, targetList, targetRefIdx) ? 1 : 0;
  BlkE a0 = blkE(E, x - 1, y + h, x, y);
  BlkE a1 = blkE(E, x - 1, y + h - 1, x, y, false);
  bool isScaled = a0.ok || a1.ok;

  auto matchUnscaled = [&](const BlkE& b, int mv[2]) {
    if (!b.ok) return false;
    int order[2] = {targetList, 1 - targetList};
    for (int li = 0; li < 2; li++) {
      int l = order[li];
      if ((b.dir & (1 << l)) && b.refPoc[l] == tgtPoc &&
          (b.refLt[l] ? 1 : 0) == tgtLt) {
        mv[0] = b.mv[l][0]; mv[1] = b.mv[l][1];
        return true;
      }
    }
    return false;
  };
  auto matchScaled = [&](const BlkE& b, int mv[2]) {
    if (!b.ok) return false;
    int order[2] = {targetList, 1 - targetList};
    for (int li = 0; li < 2; li++) {
      int l = order[li];
      if ((b.dir & (1 << l)) && (b.refLt[l] ? 1 : 0) == tgtLt) {
        if (tgtLt) { mv[0] = b.mv[l][0]; mv[1] = b.mv[l][1]; }
        else mvScaleE(b.mv[l], E.poc - tgtPoc, E.poc - b.refPoc[l], mv);
        return true;
      }
    }
    return false;
  };

  int mvA[2];
  bool haveA = matchUnscaled(a0, mvA) || matchUnscaled(a1, mvA);
  if (!haveA) haveA = matchScaled(a0, mvA) || matchScaled(a1, mvA);

  BlkE b0 = blkE(E, x + w, y - 1, x, y);
  BlkE b1 = blkE(E, x + w - 1, y - 1, x, y, false);
  BlkE b2 = blkE(E, x - 1, y - 1, x, y);
  int mvB[2];
  bool haveB = matchUnscaled(b0, mvB) || matchUnscaled(b1, mvB) ||
               matchUnscaled(b2, mvB);
  if (!isScaled) {
    if (!haveA && haveB) { mvA[0] = mvB[0]; mvA[1] = mvB[1]; haveA = true; }
    haveB = matchScaled(b0, mvB) || matchScaled(b1, mvB) ||
            matchScaled(b2, mvB);
  }
  int nc = 0;
  int cands[3][2];
  if (haveA) { cands[nc][0] = mvA[0]; cands[nc][1] = mvA[1]; nc++; }
  if (haveB && !(haveA && mvB[0] == mvA[0] && mvB[1] == mvA[1])) {
    cands[nc][0] = mvB[0]; cands[nc][1] = mvB[1]; nc++;
  }
  if (nc < 2 && E.tmvp && E.col.valid) {
    int tmv[2];
    if (tmvpE(E, x, y, w, h, targetList, targetRefIdx, tmv)) {
      cands[nc][0] = tmv[0]; cands[nc][1] = tmv[1]; nc++;
    }
  }
  while (nc < 2) { cands[nc][0] = 0; cands[nc][1] = 0; nc++; }
  out[0][0] = cands[0][0]; out[0][1] = cands[0][1];
  out[1][0] = cands[1][0]; out[1][1] = cands[1][1];
}

// motion.py _write_pu (map writes only; the encoder keeps no InterPU list —
// deblock BS inputs and future TMVP read the 4x4 maps, dir-gated, so the
// unused-list cells keep their previous values exactly like the Python)
static void writePuMapsE(Ctx& E, int x, int y, int w, int h, int dir,
                         const int mvs[2][2], const int refIdx[2]) {
  int x0 = x >> 2, x1 = (x + w) >> 2, y0 = y >> 2, y1 = (y + h) >> 2;
  for (int yy = y0; yy < y1; yy++) {
    size_t i = (size_t)yy * E.w4 + x0;
    for (int xx = x0; xx < x1; xx++, i++) {
      E.interDir[i] = (int8_t)dir;
      for (int l = 0; l < 2; l++) {
        if (dir & (1 << l)) {
          E.mv[i * 4 + l * 2] = mvs[l][0];
          E.mv[i * 4 + l * 2 + 1] = mvs[l][1];
          E.refIdx[i * 2 + l] = (int8_t)refIdx[l];
          E.refPocM[i * 2 + l] = refPocOf(E, l, refIdx[l]);
          E.refIsLt[i * 2 + l] = (int8_t)(refLtOf(E, l, refIdx[l]) ? 1 : 0);
        } else {
          E.refIdx[i * 2 + l] = -1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// PU decision (encoder.py _best_pu_motion / _pu_me_lists)
// ---------------------------------------------------------------------------
struct PuDesc {
  bool isMerge = false;
  int mergeIdx = 0;
  MergeCandE cand;  // merge motion (as derived)
  int mergeDir = 0;  // clamped dir for merge
  int dir = 0;       // amvp
  int refIdx[2] = {-1, -1};
  int mv[2][2] = {{0, 0}, {0, 0}};
  int mvd[2][2] = {{0, 0}, {0, 0}};
  int mvpIdx[2] = {0, 0};
};

// motion.py apply_merge / apply_amvp equivalents over Ctx maps
static void applyPuE(Ctx& E, const PuDesc& d, int px, int py, int w, int h,
                     int cx, int cy, int cuSize, int puIdx) {
  if (d.isMerge) {
    int partSize = E.partSize[E.mi(cx, cy)];
    MergeCandE cl[5];
    mergeCandListE(E, px, py, w, h, cx, cy, cuSize, puIdx, partSize, cl);
    MergeCandE c = cl[d.mergeIdx];
    int dir = c.dir;
    if (E.numRef[1] == 0) dir &= 1;
    if (w + h == 12 && dir == 3) {
      dir = 1;
      c.refIdx[1] = -1;
      c.mv[1][0] = c.mv[1][1] = 0;
    }
    writePuMapsE(E, px, py, w, h, dir, c.mv, c.refIdx);
    return;
  }
  int mvs[2][2] = {{0, 0}, {0, 0}};
  for (int l = 0; l < 2; l++) {
    if (d.dir & (1 << l)) {
      int cands[2][2];
      amvpCandsE(E, px, py, w, h, l, d.refIdx[l], cands);
      mvs[l][0] = cands[d.mvpIdx[l]][0] + d.mvd[l][0];
      mvs[l][1] = cands[d.mvpIdx[l]][1] + d.mvd[l][1];
    }
  }
  writePuMapsE(E, px, py, w, h, d.dir, mvs, d.refIdx);
}

static int refBitsE(int r, int nref) {
  if (nref <= 1) return 0;
  return std::min(r + 1, nref - 1);
}

// TEncSearch::xGetBlkBits (encoder.py _blk_bits)
static void blkBitsE(int part, bool pSlice, int puIdx, int lastMode,
                     int out[3]) {
  if (part == SIZE_2Nx2N || part == SIZE_NxN) {
    if (pSlice) { out[0] = 1; out[1] = 3; out[2] = 5; }
    else { out[0] = 3; out[1] = 3; out[2] = 5; }
    return;
  }
  if (pSlice) { out[0] = 3; out[1] = 0; out[2] = 0; return; }
  static const int tabH[2][3][3] = {
      {{0, 0, 3}, {0, 0, 0}, {0, 0, 0}},
      {{5, 7, 7}, {7, 5, 7}, {6, 6, 6}}};
  static const int tabV[2][3][3] = {
      {{0, 2, 3}, {0, 0, 0}, {0, 0, 0}},
      {{5, 7, 7}, {5, 5, 7}, {6, 6, 6}}};
  bool horiz = part == SIZE_2NxN || part == SIZE_2NxnU || part == SIZE_2NxnD;
  const int (*tab)[3][3] = horiz ? tabH : tabV;
  int row = puIdx < 1 ? 0 : 1;
  for (int k = 0; k < 3; k++) out[k] = tab[row][lastMode][k];
}

// encoder.py _pu_me_lists.  orig32: contiguous w*h int32.  Appends (cost,
// desc) AMVP candidates to out (best uni per list + bi).
static void puMeListsE(Ctx& E, int px, int py, int w, int h,
                       const int32_t* orig32, int partSize, int puIdx,
                       std::vector<std::pair<double, PuDesc>>& out) {
  prof::Scope _ps(prof::P_ME);
  double lamM = E.lamMotion;
  int dshift = 2 * (E.bd - 8);
  int nl = (E.sliceType == 0 && E.numRef[1]) ? 2 : 1;
  int blk[3];
  blkBitsE(partSize, nl == 1, puIdx, E.puLastMode, blk);
  static thread_local std::vector<int16_t> o16;
  o16.resize((size_t)w * h);
  for (int i = 0; i < w * h; i++) o16[i] = (int16_t)orig32[i];
  struct Uni {
    bool have = false;
    double cost = 0;
    int r = 0, mv[2] = {0, 0}, mvd[2] = {0, 0}, mvpIdx = 0;
    int amvp[2][2];
  } bestUni[2];
  // (l, r) -> running cMvTemp + amvp + mvp for the bi passes
  struct Rec { int mv[2]; int amvp[2][2]; int mvp; };
  Rec uniRec[2][16];
  // plane-dedup (GPB duplicate lists): planeId -> (mv, cost)
  struct PC { int id; int mv[2]; long long cost; };
  std::vector<PC> planeCache;
  // mvd_l1_zero: track the cheapest L1 (ref, AMVP cand) used AS the MV
  // (encoder.py best_bip; reference TEncSearch.cpp:3214 bestBiPDist)
  bool mvdl1 = nl == 2 && E.mvdL1Zero != 0;
  bool haveBip = false;
  long long bipDist = 0;
  int bipMvp = 0, bipRef = 0;
  for (int l = 0; l < nl; l++) {
    for (int r = 0; r < E.numRef[l]; r++) {
      int amvp[2][2];
      amvpCandsE(E, px, py, w, h, l, r, amvp);
      if (mvdl1 && l == 1) {
        static thread_local std::vector<int32_t> pT;
        pT.resize((size_t)w * h);
        for (int mi = 0; mi < 2; mi++) {
          int mvsT[2][2] = {{0, 0}, {amvp[mi][0], amvp[mi][1]}};
          int refsT[2] = {-1, r};
          predFromCand(E, 0, px, py, w, h, 2, mvsT, refsT, pT.data());
          long long dBi = satd32(pT.data(), orig32, w, h) >> dshift;
          if (!haveBip || dBi < bipDist) {
            haveBip = true; bipDist = dBi; bipMvp = mi; bipRef = r;
          }
        }
      }
      const Ctx::Ref& ref = E.refs[l][r];
      int mv[2];
      long long pcost = 0;
      bool hit = false;
      for (auto& pc : planeCache)
        if (pc.id == ref.planeId) {
          mv[0] = pc.mv[0]; mv[1] = pc.mv[1];
          pcost = pc.cost;
          hit = true;
          break;
        }
      if (!hit) {
        enc::MeArgs a;
        a.padded = ref.padded;
        a.pw = ref.padW; a.ph = ref.padH; a.pad = E.searchRange + 8;
        a.orig = o16.data();
        a.px = px; a.py = py; a.w = w; a.h = h;
        a.R = E.searchRange;
        a.pmx = amvp[0][0]; a.pmy = amvp[0][1];
        a.lam = lamM;
        a.bd = E.bd;
        a.fast = E.fastSearch;
        // FEN: subsampled SAD rows for blocks taller than 8
        a.subShift = (E.fastEnc && h > 8) ? 1 : 0;
        int64_t res[3];
        enc::meSearch(a, res);
        mv[0] = (int)res[0]; mv[1] = (int)res[1];
        pcost = res[2];
        planeCache.push_back({ref.planeId, {mv[0], mv[1]}, pcost});
      }
      double best = 0;
      int bestMi = -1, bestMvd[2] = {0, 0};
      for (int mi = 0; mi < 2; mi++) {
        int mvd[2] = {mv[0] - amvp[mi][0], mv[1] - amvp[mi][1]};
        int bits = blk[l] + enc::mvBits(mvd[0], mvd[1]) + 1 +
                   refBitsE(r, E.numRef[l]);
        double c = (double)pcost + lamM * bits;
        if (bestMi < 0 || c < best) {
          best = c;
          bestMi = mi;
          bestMvd[0] = mvd[0]; bestMvd[1] = mvd[1];
        }
      }
      uniRec[l][r].mv[0] = mv[0]; uniRec[l][r].mv[1] = mv[1];
      std::memcpy(uniRec[l][r].amvp, amvp, sizeof(amvp));
      uniRec[l][r].mvp = bestMi;
      if (!bestUni[l].have || best < bestUni[l].cost) {
        bestUni[l].have = true;
        bestUni[l].cost = best;
        bestUni[l].r = r;
        bestUni[l].mv[0] = mv[0]; bestUni[l].mv[1] = mv[1];
        bestUni[l].mvd[0] = bestMvd[0]; bestUni[l].mvd[1] = bestMvd[1];
        bestUni[l].mvpIdx = bestMi;
        std::memcpy(bestUni[l].amvp, amvp, sizeof(amvp));
      }
    }
  }
  for (int l = 0; l < nl; l++) {
    if (!bestUni[l].have) continue;
    PuDesc d;
    d.isMerge = false;
    d.dir = l + 1;
    d.refIdx[l] = bestUni[l].r;
    d.mv[l][0] = bestUni[l].mv[0]; d.mv[l][1] = bestUni[l].mv[1];
    d.mvd[l][0] = bestUni[l].mvd[0]; d.mvd[l][1] = bestUni[l].mvd[1];
    d.mvpIdx[l] = bestUni[l].mvpIdx;
    out.push_back({bestUni[l].cost, d});
  }
  // bi-prediction refinement (B slices, 8x4/4x8 excluded)
  if (nl == 2 && bestUni[0].have && bestUni[1].have && w + h != 12) {
    int refs2[2] = {bestUni[0].r, bestUni[1].r};
    int mvs2[2][2] = {{bestUni[0].mv[0], bestUni[0].mv[1]},
                      {bestUni[1].mv[0], bestUni[1].mv[1]}};
    int mvds2[2][2] = {{bestUni[0].mvd[0], bestUni[0].mvd[1]},
                       {bestUni[1].mvd[0], bestUni[1].mvd[1]}};
    int mvps2[2] = {bestUni[0].mvpIdx, bestUni[1].mvpIdx};
    int nref[2] = {E.numRef[0], E.numRef[1]};
    int motBits[2];
    if (mvdl1 && haveBip) {
      // L1 pinned to its best AMVP candidate: no L1 MVD is coded;
      // motBits[1] keeps HM's uiMbBits[1] charge (TEncSearch.cpp:3327)
      refs2[1] = bipRef;
      mvs2[1][0] = uniRec[1][bipRef].amvp[bipMvp][0];
      mvs2[1][1] = uniRec[1][bipRef].amvp[bipMvp][1];
      mvds2[1][0] = 0; mvds2[1][1] = 0;
      mvps2[1] = bipMvp;
      uniRec[1][bipRef].mv[0] = mvs2[1][0];
      uniRec[1][bipRef].mv[1] = mvs2[1][1];
      uniRec[1][bipRef].mvp = bipMvp;
      motBits[0] = enc::mvBits(bestUni[0].mvd[0], bestUni[0].mvd[1]) + 1 +
                   refBitsE(refs2[0], nref[0]);
      motBits[1] = blk[1] + 1 + refBitsE(bipRef, nref[1]);
    } else {
      motBits[0] = enc::mvBits(bestUni[0].mvd[0], bestUni[0].mvd[1]) + 1 +
                   refBitsE(refs2[0], nref[0]);
      motBits[1] = enc::mvBits(bestUni[1].mvd[0], bestUni[1].mvd[1]) + 1 +
                   refBitsE(refs2[1], nref[1]);
    }
    bool haveCost = false;
    double costBi = 0;
    static thread_local std::vector<int32_t> pOther;
    static thread_local std::vector<int16_t> target;
    pOther.resize((size_t)w * h);
    target.resize((size_t)w * h);
    // iteration policy (TEncSearch.cpp:3345-3380): FEN or mvd_l1_zero
    // run ONE pass — FEN refines the weaker list, mvd_l1_zero list 0
    int nIter = (E.fastEnc || mvdl1) ? 1 : 4;
    for (int it = 0; it < nIter; it++) {
      int l;
      if (mvdl1) l = 0;
      else if (E.fastEnc) l = bestUni[0].cost <= bestUni[1].cost ? 1 : 0;
      else l = it % 2;
      int other = 1 - l;
      predFromCand(E, 0, px, py, w, h, other + 1, mvs2, refs2,
                   pOther.data());
      for (int i = 0; i < w * h; i++)
        target[i] = (int16_t)(2 * orig32[i] - pOther[i]);
      bool changed = false;
      for (int r = 0; r < nref[l]; r++) {
        Rec& rec = uniRec[l][r];
        int predMv[2] = {rec.amvp[rec.mvp][0], rec.amvp[rec.mvp][1]};
        const Ctx::Ref& ref = E.refs[l][r];
        enc::MeArgs a;
        a.padded = ref.padded;
        a.pw = ref.padW; a.ph = ref.padH; a.pad = E.searchRange + 8;
        a.orig = target.data();
        a.px = px; a.py = py; a.w = w; a.h = h;
        a.R = E.searchRange;
        a.pmx = predMv[0]; a.pmy = predMv[1];
        a.lam = lamM;
        a.bd = E.bd;
        a.fast = E.fastSearch;
        a.subShift = (E.fastEnc && h > 8) ? 1 : 0;
        int64_t res[3];
        enc::biRefine(a, rec.mv[0], rec.mv[1], res);
        int mv2[2] = {(int)res[0], (int)res[1]};
        long long dist = res[2];
        rec.mv[0] = mv2[0]; rec.mv[1] = mv2[1];
        // xCheckBestMVP: re-pick the AMVP candidate minimizing mvd bits
        int mi2 = 0;
        int bb = enc::mvBits(mv2[0] - rec.amvp[0][0],
                             mv2[1] - rec.amvp[0][1]);
        int bb1 = enc::mvBits(mv2[0] - rec.amvp[1][0],
                              mv2[1] - rec.amvp[1][1]);
        if (bb1 < bb) mi2 = 1;
        rec.mvp = mi2;
        int mvd2[2] = {mv2[0] - rec.amvp[mi2][0], mv2[1] - rec.amvp[mi2][1]};
        int bits = blk[2] + motBits[other] + 1 + refBitsE(r, nref[l]) +
                   enc::mvBits(mvd2[0], mvd2[1]);
        double c = (double)(dist >> 1) + lamM * bits;
        if (!haveCost || c < costBi) {
          changed = true;
          haveCost = true;
          costBi = c;
          refs2[l] = r;
          mvs2[l][0] = mv2[0]; mvs2[l][1] = mv2[1];
          mvds2[l][0] = mvd2[0]; mvds2[l][1] = mvd2[1];
          mvps2[l] = mi2;
          motBits[l] = bits - blk[2] - motBits[other];
        }
      }
      if (!changed) break;
    }
    static thread_local std::vector<int32_t> predBi;
    predBi.resize((size_t)w * h);
    predFromCand(E, 0, px, py, w, h, 3, mvs2, refs2, predBi.data());
    int bits;
    if (mvdl1)
      // uiBits[2] = mbBits[2] + motBits[0] + motBits[1] — no L1 MVD bits
      bits = blk[2] + motBits[0] + motBits[1];
    else
      bits = blk[2] + enc::mvBits(mvds2[0][0], mvds2[0][1]) +
             enc::mvBits(mvds2[1][0], mvds2[1][1]) + 2 +
             refBitsE(refs2[0], E.numRef[0]) +
             refBitsE(refs2[1], E.numRef[1]);
    double c = (double)(satd32(predBi.data(), orig32, w, h) >> dshift) +
               lamM * bits;
    PuDesc d;
    d.isMerge = false;
    d.dir = 3;
    d.refIdx[0] = refs2[0]; d.refIdx[1] = refs2[1];
    std::memcpy(d.mv, mvs2, sizeof(mvs2));
    std::memcpy(d.mvd, mvds2, sizeof(mvds2));
    d.mvpIdx[0] = mvps2[0]; d.mvpIdx[1] = mvps2[1];
    out.push_back({c, d});
  }
}

// encoder.py _best_pu_motion.  Returns the winning (cost, desc); fills
// mergeCands (deduped merge candidates) and meAll (the ME candidate list).
static double bestPuMotionE(Ctx& E, int px, int py, int w, int h, int cx,
                            int cy, int cuSize, int puIdx, int partSize,
                            PuDesc* bestDesc,
                            std::vector<PuDesc>* mergeCands,
                            std::vector<std::pair<double, PuDesc>>* meAll) {
  static thread_local std::vector<int32_t> orig32, pred;
  orig32.resize((size_t)w * h);
  pred.resize((size_t)w * h);
  const int stride = E.planeW[0];
  for (int j = 0; j < h; j++)
    for (int i = 0; i < w; i++)
      orig32[(size_t)j * w + i] =
          E.orig[0][(size_t)(py + j) * stride + px + i];
  double lamM = E.lamMotion;
  int dshift = 2 * (E.bd - 8);
  bool haveBest = false;
  double bestCost = 0;
  PuDesc best;
  MergeCandE clist[5];
  mergeCandListE(E, px, py, w, h, cx, cy, cuSize, puIdx, partSize, clist);
  if (mergeCands) mergeCands->clear();
  std::vector<MergeCandE> seen;  // clamped-motion dedup (Python seen_motion)
  for (int mi = 0; mi < E.maxMerge; mi++) {
    MergeCandE cand = clist[mi];
    int dir = cand.dir;
    if (E.numRef[1] == 0) dir &= 1;
    if (w + h == 12 && dir == 3) dir = 1;
    if (!dir) continue;
    // dedup key: (dir, per-used-list (mv, ref))
    MergeCandE key = cand;
    key.dir = dir;
    bool dup = false;
    for (auto& s : seen)
      if (s.sameMotion(key)) { dup = true; break; }
    if (!dup) {
      seen.push_back(key);
      if (mergeCands) {
        PuDesc d;
        d.isMerge = true;
        d.mergeIdx = mi;
        d.cand = cand;
        d.mergeDir = dir;
        mergeCands->push_back(d);
      }
    }
    predFromCand(E, 0, px, py, w, h, dir, cand.mv, cand.refIdx, pred.data());
    double cost = (double)(satd32(pred.data(), orig32.data(), w, h) >>
                           dshift) +
                  lamM * (mi + 2);
    if (!haveBest || cost < bestCost) {
      haveBest = true;
      bestCost = cost;
      best = PuDesc();
      best.isMerge = true;
      best.mergeIdx = mi;
      best.cand = cand;
      best.mergeDir = dir;
    }
  }
  std::vector<std::pair<double, PuDesc>> me;
  puMeListsE(E, px, py, w, h, orig32.data(), partSize, puIdx, me);
  if (meAll) *meAll = me;
  for (auto& cd : me) {
    if (!haveBest || cd.first < bestCost) {
      haveBest = true;
      bestCost = cd.first;
      best = cd.second;
    }
  }
  // uiLastMode for the second PU's xGetBlkBits row
  int d = best.isMerge ? best.mergeDir : best.dir;
  E.puLastMode = d == 3 ? 2 : d - 1;
  *bestDesc = best;
  return bestCost;
}

// ---------------------------------------------------------------------------
// PU / CU syntax writers (encoder.py _write_*)
// ---------------------------------------------------------------------------
static void writeMergeIdxE(Ctx& E, int idx) {
  int n = E.maxMerge;
  if (n > 1) {
    E.recBin(B_MERGE_IDX, 0, idx > 0 ? 1 : 0);
    if (idx > 0) {
      for (int k = 1; k < idx; k++) E.recBypass(1);
      if (idx < n - 1) E.recBypass(0);
    }
  }
}

static void writeMvdE(Ctx& E, const int mvd[2]) {
  int ax = std::abs(mvd[0]), ay = std::abs(mvd[1]);
  E.recBin(B_MVD, 0, ax ? 1 : 0);
  E.recBin(B_MVD, 0, ay ? 1 : 0);
  if (ax) E.recBin(B_MVD, 1, ax > 1 ? 1 : 0);
  if (ay) E.recBin(B_MVD, 1, ay > 1 ? 1 : 0);
  if (ax) {
    if (ax > 1) E.recEg(ax - 2, 1);
    E.recBypass(mvd[0] < 0 ? 1 : 0);
  }
  if (ay) {
    if (ay > 1) E.recEg(ay - 2, 1);
    E.recBypass(mvd[1] < 0 ? 1 : 0);
  }
}

static void writeRefIdxE(Ctx& E, int l, int r) {
  int nref = E.numRef[l];
  if (nref <= 1) return;
  E.recBin(B_REF_IDX, 0, r > 0 ? 1 : 0);
  if (r > 0) {
    int nrem = nref - 2;
    for (int i = 0; i < r - 1; i++) {
      if (i == 0) E.recBin(B_REF_IDX, 1, 1);
      else E.recBypass(1);
    }
    if (r - 1 < nrem) {
      if (r - 1 == 0) E.recBin(B_REF_IDX, 1, 0);
      else E.recBypass(0);
    }
  }
}

static void writePuSyntaxE(Ctx& E, const PuDesc& d, int cuSize,
                           int partSize) {
  if (d.isMerge) {
    E.recBin(B_MERGE_FLAG, 0, 1);
    writeMergeIdxE(E, d.mergeIdx);
    return;
  }
  E.recBin(B_MERGE_FLAG, 0, 0);
  if (E.sliceType == 0) {
    if (partSize == SIZE_2Nx2N || cuSize != 8)
      E.recBin(B_INTER_DIR, E.curDepth, d.dir == 3 ? 1 : 0);
    if (d.dir != 3) E.recBin(B_INTER_DIR, 4, d.dir - 1);
  }
  for (int l = 0; l < 2; l++) {
    bool use = (d.dir == 3) || (d.dir == l + 1);
    if (!use || E.numRef[l] == 0) continue;
    writeRefIdxE(E, l, d.refIdx[l]);
    // mvd_l1_zero_flag: bi PUs code no L1 MVD (Rec. 7.3.8.6)
    if (!(l == 1 && d.dir == 3 && E.mvdL1Zero)) writeMvdE(E, d.mvd[l]);
    E.recBin(B_MVP, 0, d.mvpIdx[l]);
  }
}

static int skipCtxE(const Ctx& E, int x, int y) {
  int ctx = 0;
  if (E.available(x - 1, y, x, y, false) && E.skip[E.mi(x - 1, y)]) ctx++;
  if (E.available(x, y - 1, x, y, false) && E.skip[E.mi(x, y - 1)]) ctx++;
  return ctx;
}

// encoder.py _write_inter_part_size
static void writeInterPartSizeE(Ctx& E, int part, int log2size) {
  bool atMin = log2size == E.log2MinCb;
  int base = part;
  int ampBin = -1;  // -1 = none
  if (part == SIZE_2NxnU || part == SIZE_2NxnD) {
    base = SIZE_2NxN;
    ampBin = part == SIZE_2NxnU ? 0 : 1;
  } else if (part == SIZE_nLx2N || part == SIZE_nRx2N) {
    base = SIZE_Nx2N;
    ampBin = part == SIZE_nLx2N ? 0 : 1;
  }
  int maxBits = (atMin && (1 << log2size) != 8) ? 3 : 2;
  for (int i = 0; i < std::min(base, maxBits); i++) E.recBin(B_PART, i, 0);
  if (base < maxBits) E.recBin(B_PART, base, 1);
  if (E.ampEnabled && !atMin && (base == SIZE_2NxN || base == SIZE_Nx2N)) {
    if (ampBin < 0) E.recBin(B_PART, 3, 1);
    else {
      E.recBin(B_PART, 3, 0);
      E.recBypass(ampBin);
    }
  }
}

// ---------------------------------------------------------------------------
// PU partitions (slicedec.pu_partitions)
// ---------------------------------------------------------------------------
static int puPartitionsE(int part, int size, int out[4][4]) {
  int s = size, q = size >> 2, h = size >> 1;
  switch (part) {
    case SIZE_2Nx2N: {
      int v[1][4] = {{0, 0, s, s}};
      std::memcpy(out, v, sizeof(v));
      return 1;
    }
    case SIZE_2NxN: {
      int v[2][4] = {{0, 0, s, h}, {0, h, s, h}};
      std::memcpy(out, v, sizeof(v));
      return 2;
    }
    case SIZE_Nx2N: {
      int v[2][4] = {{0, 0, h, s}, {h, 0, h, s}};
      std::memcpy(out, v, sizeof(v));
      return 2;
    }
    case SIZE_NxN: {
      int v[4][4] = {{0, 0, h, h}, {h, 0, h, h}, {0, h, h, h}, {h, h, h, h}};
      std::memcpy(out, v, sizeof(v));
      return 4;
    }
    case SIZE_2NxnU: {
      int v[2][4] = {{0, 0, s, q}, {0, q, s, s - q}};
      std::memcpy(out, v, sizeof(v));
      return 2;
    }
    case SIZE_2NxnD: {
      int v[2][4] = {{0, 0, s, s - q}, {0, s - q, s, q}};
      std::memcpy(out, v, sizeof(v));
      return 2;
    }
    case SIZE_nLx2N: {
      int v[2][4] = {{0, 0, q, s}, {q, 0, s - q, s}};
      std::memcpy(out, v, sizeof(v));
      return 2;
    }
    default: {  // SIZE_nRx2N
      int v[2][4] = {{0, 0, s - q, s}, {s - q, 0, q, s}};
      std::memcpy(out, v, sizeof(v));
      return 2;
    }
  }
}

// ---------------------------------------------------------------------------
// inter residual coding (encoder.py _encode_inter_res_* / _inter_tt_*)
// ---------------------------------------------------------------------------
// per-CU prediction buffers: [comp] -> (size>>ssx) x (size>>ssy), packed
struct CuPreds {
  std::vector<int32_t> p[3];
  int cw[3], chh[3];
};

// inter transform-tree node (Python dict in _inter_tt_decide)
struct ITt {
  bool split = false;
  int l2 = 0, x = 0, y = 0, depth = 0;
  std::vector<int32_t> lev, rec;
  int cbf = 0, ts = -1;
  ITt* kids[4] = {nullptr, nullptr, nullptr, nullptr};
  int cb[2] = {0, 0}, cr[2] = {0, 0};
  bool hasChroma = false;
  struct CTu {
    std::vector<int32_t> lev, rec;
    int cbf = 0, ts = -1;
  };
  CTu* ch[3] = {nullptr, nullptr, nullptr};
  ~ITt() {
    for (int i = 0; i < 4; i++) delete kids[i];
    delete[] ch[1];
    delete[] ch[2];
  }
};

static ITt* interTtDecide(Ctx& E, int x, int y, int l2, int depth, int minTu,
                          const int32_t* resiL, int resiStride, int ox,
                          int oy);

static ITt* interTtLeafTry(Ctx& E, int x, int y, int l2, int depth,
                           int minTu, const int32_t* resiL, int resiStride,
                           int ox, int oy) {
  int size = 1 << l2;
  ITt* node = new ITt();
  node->l2 = l2; node->x = x; node->y = y; node->depth = depth;
  static thread_local std::vector<int32_t> sub;
  sub.resize((size_t)size * size);
  for (int j = 0; j < size; j++)
    std::memcpy(&sub[(size_t)j * size],
                resiL + (size_t)(oy + j) * resiStride + ox,
                (size_t)size * sizeof(int32_t));
  TuOut tu;
  tuFwd(E, sub.data(), size, false, 0, SCAN_DIAG, false, &tu);
  if (subdivCoded(E, l2, minTu)) E.recBin(B_SUBDIV, 5 - l2, 0);
  E.recBin(B_QT_CBF, depth == 0 ? 1 : 0, tu.cbf);
  if (tu.cbf)
    encodeResidual(E, tu.lev, size, size, 0, SCAN_DIAG, E.sdh, tu.ts);
  node->lev.assign(tu.lev, tu.lev + (size_t)size * size);
  node->rec.assign(tu.rec, tu.rec + (size_t)size * size);
  node->cbf = tu.cbf;
  node->ts = tu.ts;
  return node;
}

static ITt* interTtSplitTry(Ctx& E, int x, int y, int l2, int depth,
                            int minTu, const int32_t* resiL, int resiStride,
                            int ox, int oy) {
  if (subdivCoded(E, l2, minTu)) E.recBin(B_SUBDIV, 5 - l2, 1);
  ITt* node = new ITt();
  node->split = true;
  node->l2 = l2; node->x = x; node->y = y; node->depth = depth;
  int h = 1 << (l2 - 1);
  static const int off[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
  for (int k = 0; k < 4; k++)
    node->kids[k] = interTtDecide(E, x + off[k][0] * h, y + off[k][1] * h,
                                  l2 - 1, depth + 1, minTu, resiL,
                                  resiStride, ox + off[k][0] * h,
                                  oy + off[k][1] * h);
  return node;
}

static double interTreeSse(const ITt* node, const int32_t* resiL,
                           int resiStride, int ox, int oy) {
  if (node->split) {
    int hh = 1 << (node->l2 - 1);
    static const int off[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
    double s = 0;
    for (int k = 0; k < 4; k++)
      s += interTreeSse(node->kids[k], resiL, resiStride,
                        ox + off[k][0] * hh, oy + off[k][1] * hh);
    return s;
  }
  int n = 1 << node->l2;
  long long sse = 0;
  for (int j = 0; j < n; j++)
    for (int i = 0; i < n; i++) {
      long long d = resiL[(size_t)(oy + j) * resiStride + ox + i];
      if (node->cbf) d -= node->rec[(size_t)j * n + i];
      sse += d * d;
    }
  return (double)sse;
}

static ITt* interTtDecide(Ctx& E, int x, int y, int l2, int depth, int minTu,
                          const int32_t* resiL, int resiStride, int ox,
                          int oy) {
  if (l2 > E.log2MaxTb)
    return interTtSplitTry(E, x, y, l2, depth, minTu, resiL, resiStride, ox,
                           oy);
  if (!(l2 > minTu && l2 > E.log2MinTb))
    return interTtLeafTry(E, x, y, l2, depth, minTu, resiL, resiStride, ox,
                          oy);
  size_t mark = E.ops.size();
  ITt* leaf = interTtLeafTry(E, x, y, l2, depth, minTu, resiL, resiStride,
                             ox, oy);
  double norm = (double)(1 << (2 * (E.bd - 8)));
  double costLeaf = interTreeSse(leaf, resiL, resiStride, ox, oy) / norm +
                    E.rdLambda * E.estOpsBits(mark);
  OpsSlice leafOps = E.saveOps(mark);
  E.truncate(mark);
  ITt* split = interTtSplitTry(E, x, y, l2, depth, minTu, resiL, resiStride,
                               ox, oy);
  double costSplit = interTreeSse(split, resiL, resiStride, ox, oy) / norm +
                     E.rdLambda * E.estOpsBits(mark);
  if (costLeaf <= costSplit) {
    E.truncate(mark);
    E.reinstate(leafOps);
    delete split;
    return leaf;
  }
  delete leaf;
  return split;
}

// encoder.py _inter_tt_chroma (4:2:0 only on the native path)
static void interTtChroma(Ctx& E, ITt* node, const CuPreds& preds, int cuX,
                          int cuY) {
  int idc = E.cfmt;
  int l2 = node->l2;
  if (idc == 0) {
    node->cb[0] = node->cb[1] = node->cr[0] = node->cr[1] = 0;
    if (node->split)
      for (int k = 0; k < 4; k++) interTtChroma(E, node->kids[k], preds,
                                                cuX, cuY);
    return;
  }
  if (node->split && (idc == 3 || l2 > 3)) {
    for (int k = 0; k < 4; k++) interTtChroma(E, node->kids[k], preds, cuX,
                                              cuY);
    int vb = 0, vr = 0;
    for (int k = 0; k < 4; k++) {
      if (node->kids[k]->cb[0] || node->kids[k]->cb[1]) vb = 1;
      if (node->kids[k]->cr[0] || node->kids[k]->cr[1]) vr = 1;
    }
    node->cb[0] = node->cb[1] = vb;
    node->cr[0] = node->cr[1] = vr;
    return;
  }
  int x = node->x, y = node->y;
  int ssx = E.chromaShiftX(), ssy = E.chromaShiftY();
  int cn = 1 << (l2 - ssx);
  int cx = x >> ssx, cy0 = y >> ssy;
  int px0 = (x - cuX) >> ssx, py0 = (y - cuY) >> ssy;
  node->hasChroma = true;
  static thread_local std::vector<int32_t> resi;
  resi.resize((size_t)cn * cn);
  for (int comp = 1; comp <= 2; comp++) {
    node->ch[comp] = new ITt::CTu[1];
    int cy = cy0;
    const int stride = E.planeW[comp];
    for (int j = 0; j < cn; j++)
      for (int i = 0; i < cn; i++)
        resi[(size_t)j * cn + i] =
            E.orig[comp][(size_t)(cy + j) * stride + cx + i] -
            preds.p[comp][(size_t)(py0 + j) * preds.cw[comp] + px0 + i];
    TuOut tu;
    tuFwd(E, resi.data(), cn, false, comp, SCAN_DIAG, false, &tu);
    auto& e = node->ch[comp][0];
    e.lev.assign(tu.lev, tu.lev + (size_t)cn * cn);
    e.rec.assign(tu.rec, tu.rec + (size_t)cn * cn);
    e.cbf = tu.cbf;
    e.ts = tu.ts;
  }
  node->cb[0] = node->cb[1] = node->ch[1][0].cbf;
  node->cr[0] = node->cr[1] = node->ch[2][0].cbf;
  if (node->split) {
    for (int k = 0; k < 4; k++) {
      node->kids[k]->cb[0] = node->kids[k]->cb[1] = 0;
      node->kids[k]->cr[0] = node->kids[k]->cr[1] = 0;
    }
  }
}

static bool interTtAnyLuma(const ITt* node) {
  if (node->split) {
    for (int k = 0; k < 4; k++)
      if (interTtAnyLuma(node->kids[k])) return true;
    return false;
  }
  return node->cbf != 0;
}

// chroma recon for one chroma-holding node (encoder.py _inter_tt_chroma_recon)
static void interTtChromaRecon(Ctx& E, const ITt* node, ITt::CTu* const* ch,
                               const CuPreds& preds, int cuX, int cuY) {
  int ssx = E.chromaShiftX(), ssy = E.chromaShiftY();
  int cn = 1 << (node->l2 - ssx);
  int cx = node->x >> ssx, cy = node->y >> ssy;
  int px0 = (node->x - cuX) >> ssx, py0 = (node->y - cuY) >> ssy;
  int maxv = (1 << E.bd) - 1;
  for (int comp = 1; comp <= 2; comp++) {
    const auto& e = ch[comp][0];
    const int stride = E.planeW[comp];
    for (int j = 0; j < cn; j++)
      for (int i = 0; i < cn; i++) {
        int v = preds.p[comp][(size_t)(py0 + j) * preds.cw[comp] + px0 + i];
        if (e.cbf) v += e.rec[(size_t)j * cn + i];
        E.recon[comp][(size_t)(cy + j) * stride + cx + i] =
            clip3(0, maxv, v);
      }
  }
}

// encoder.py _inter_tt_emit
static void interTtEmit(Ctx& E, ITt* node, int minTu, const int parentCb[2],
                        const int parentCr[2], int blkIdx,
                        ITt::CTu* const* parentChroma, const ITt* parentNode,
                        const CuPreds& preds, int cuX, int cuY) {
  int idc = E.cfmt;
  int l2 = node->l2, depth = node->depth;
  bool subdiv = node->split;
  int maxv = (1 << E.bd) - 1;
  if (subdivCoded(E, l2, minTu)) E.recBin(B_SUBDIV, 5 - l2, subdiv ? 1 : 0);
  int cb[2] = {parentCb[0], parentCb[1]};
  int cr[2] = {parentCr[0], parentCr[1]};
  if (idc != 0 && (l2 > 2 || idc == 3)) {
    cb[0] = node->cb[0]; cb[1] = node->cb[1];
    cr[0] = node->cr[0]; cr[1] = node->cr[1];
    int lowest = subdiv ? 0 : 1;
    if (depth == 0 || parentCb[0] || parentCb[1])
      writeCbfChroma(E, l2, depth, cb[0], cb[1], lowest);
    else { cb[0] = cb[1] = 0; }
    if (depth == 0 || parentCr[0] || parentCr[1])
      writeCbfChroma(E, l2, depth, cr[0], cr[1], lowest);
    else { cr[0] = cr[1] = 0; }
  }
  if (subdiv) {
    ITt::CTu* const* held = node->hasChroma ? node->ch : nullptr;
    for (int i = 0; i < 4; i++)
      interTtEmit(E, node->kids[i], minTu, cb, cr, i, held, node, preds,
                  cuX, cuY);
    if (held) interTtChromaRecon(E, node, held, preds, cuX, cuY);
    return;
  }
  int x = node->x, y = node->y;
  int size = 1 << l2;
  int cbf = node->cbf;
  if (depth > 0 || cb[0] || cb[1] || cr[0] || cr[1])
    E.recBin(B_QT_CBF, depth == 0 ? 1 : 0, cbf);
  maybeWriteDqp(E, cbf || cb[0] || cb[1] || cr[0] || cr[1]);
  if (cbf)
    encodeResidual(E, node->lev.data(), size, size, 0, SCAN_DIAG, E.sdh,
                   node->ts);
  const int stride = E.planeW[0];
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++) {
      int v = preds.p[0][(size_t)(y - cuY + j) * preds.cw[0] + x - cuX + i];
      if (cbf) v += node->rec[(size_t)j * size + i];
      E.recon[0][(size_t)(y + j) * stride + x + i] = clip3(0, maxv, v);
    }
  E.setRect8(E.cbfY, x, y, size, size, cbf);
  E.markTuEdges(x, y, size);
  (void)parentNode;
  bool chromaHere = idc != 0 && (l2 - E.chromaShiftX()) >= 2;
  ITt::CTu* const* ch = nullptr;
  if (chromaHere && node->hasChroma) ch = node->ch;
  else if (idc != 0 && !chromaHere && blkIdx == 3 && parentChroma)
    ch = parentChroma;
  if (ch) {
    for (int comp = 1; comp <= 2; comp++) {
      const auto& e = ch[comp][0];
      if (e.cbf) {
        int holderL2 = chromaHere ? l2 : (l2 + 1);
        int cn = 1 << (holderL2 - E.chromaShiftX());
        encodeResidual(E, e.lev.data(), cn, cn, comp, SCAN_DIAG, E.sdh,
                       e.ts);
      }
    }
    if (chromaHere) interTtChromaRecon(E, node, ch, preds, cuX, cuY);
  }
}

// prediction-only reconstruction of the whole CU (skip / zero-cbf paths)
static void predReconCu(Ctx& E, int x, int y, int size,
                        const CuPreds& preds) {
  int maxv = (1 << E.bd) - 1;
  for (int c = 0; c < E.ncomp(); c++) {
    int ssx = c ? E.chromaShiftX() : 0;
    int ssy = c ? E.chromaShiftY() : 0;
    int nx = size >> ssx, ny = size >> ssy;
    const int stride = E.planeW[c];
    for (int j = 0; j < ny; j++)
      for (int i = 0; i < nx; i++)
        E.recon[c][(size_t)((y >> ssy) + j) * stride + (x >> ssx) + i] =
            clip3(0, maxv, preds.p[c][(size_t)j * preds.cw[c] + i]);
  }
}

// encoder.py _emit_skip_cu
static void emitSkipCuE(Ctx& E, int x, int y, int log2size,
                        const PuDesc& desc, const CuPreds& preds) {
  int size = 1 << log2size;
  E.recBin(B_SKIP, skipCtxE(E, x, y), 1);
  E.setRect8(E.skip, x, y, size, size, 1);
  E.setRect8(E.cbfY, x, y, size, size, 0);
  writeMergeIdxE(E, desc.mergeIdx);
  predReconCu(E, x, y, size, preds);
  finishCuQp(E, x, y, size);
}

static void encodeInterRes2nx2nTree(Ctx& E, int x, int y, int log2size,
                                    const PuDesc& desc,
                                    const CuPreds& preds);

// encoder.py _encode_inter_res_2nx2n (single-TU path + dispatch to tree)
static void encodeInterRes2nx2n(Ctx& E, int x, int y, int log2size,
                                const PuDesc& desc, const CuPreds& preds) {
  int size = 1 << log2size;
  bool useMerge = desc.isMerge;
  if (log2size > E.log2MaxTb ||
      (E.maxTrInter > 0 && log2size - 1 >= E.log2MinTb)) {
    encodeInterRes2nx2nTree(E, x, y, log2size, desc, preds);
    return;
  }
  // flat single-TU path (4:2:0: one sub-TU per comp)
  TuOut tu[3];
  static thread_local std::vector<int32_t> resi;
  for (int comp = 0; comp < E.ncomp(); comp++) {
    int ssx = comp ? E.chromaShiftX() : 0;
    int ssy = comp ? E.chromaShiftY() : 0;
    int n = size >> ssx;
    int cxp = x >> ssx, cyp = y >> ssy;
    resi.resize((size_t)n * n);
    const int stride = E.planeW[comp];
    for (int j = 0; j < n; j++)
      for (int i = 0; i < n; i++)
        resi[(size_t)j * n + i] =
            E.orig[comp][(size_t)(cyp + j) * stride + cxp + i] -
            preds.p[comp][(size_t)j * preds.cw[comp] + i];
    tuFwd(E, resi.data(), n, false, comp, SCAN_DIAG, false, &tu[comp]);
  }
  bool anyCbf = tu[0].cbf != 0;
  if (E.ncomp() > 1) anyCbf = anyCbf || tu[1].cbf || tu[2].cbf;
  E.setRect8(E.cbfY, x, y, size, size, tu[0].cbf);

  bool isSkip = useMerge && !anyCbf;
  E.recBin(B_SKIP, skipCtxE(E, x, y), isSkip ? 1 : 0);
  E.setRect8(E.skip, x, y, size, size, isSkip ? 1 : 0);
  if (isSkip) {
    writeMergeIdxE(E, desc.mergeIdx);
    predReconCu(E, x, y, size, preds);
    finishCuQp(E, x, y, size);
    return;
  }
  E.recBin(B_PREDMODE, 0, 0);
  E.recBin(B_PART, 0, 1);  // 2Nx2N
  writePuSyntaxE(E, desc, size, SIZE_2Nx2N);
  if (!useMerge) E.recBin(B_ROOT_CBF, 0, anyCbf ? 1 : 0);
  int minTuI = ttMinTu(E, log2size, false);
  if (anyCbf) {
    if (E.maxTrInter > 0) maybeWriteSubdiv(E, log2size, 0, minTuI);
    if (E.ncomp() > 1) {
      E.recBin(B_QT_CBF, 5, tu[1].cbf);
      E.recBin(B_QT_CBF, 5, tu[2].cbf);
      if (tu[1].cbf || tu[2].cbf) E.recBin(B_QT_CBF, 1, tu[0].cbf);
    }
    maybeWriteDqp(E, true);
    for (int comp = 0; comp < E.ncomp(); comp++) {
      int ssx = comp ? E.chromaShiftX() : 0;
      int n = size >> ssx;
      if (tu[comp].cbf)
        encodeResidual(E, tu[comp].lev, n, n, comp, SCAN_DIAG, E.sdh,
                       tu[comp].ts);
    }
  }
  int maxv = (1 << E.bd) - 1;
  for (int comp = 0; comp < E.ncomp(); comp++) {
    int ssx = comp ? E.chromaShiftX() : 0;
    int ssy = comp ? E.chromaShiftY() : 0;
    int n = size >> ssx;
    int cxp = x >> ssx, cyp = y >> ssy;
    const int stride = E.planeW[comp];
    for (int j = 0; j < n; j++)
      for (int i = 0; i < n; i++) {
        int v = preds.p[comp][(size_t)j * preds.cw[comp] + i];
        if (tu[comp].cbf) v += tu[comp].rec[(size_t)j * n + i];
        E.recon[comp][(size_t)(cyp + j) * stride + cxp + i] =
            clip3(0, maxv, v);
      }
  }
  finishCuQp(E, x, y, size);
}

// encoder.py _encode_inter_res_2nx2n_tree
static void encodeInterRes2nx2nTree(Ctx& E, int x, int y, int log2size,
                                    const PuDesc& desc,
                                    const CuPreds& preds) {
  int size = 1 << log2size;
  bool useMerge = desc.isMerge;
  std::vector<int32_t> resiL((size_t)size * size);
  const int stride = E.planeW[0];
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++)
      resiL[(size_t)j * size + i] =
          E.orig[0][(size_t)(y + j) * stride + x + i] -
          preds.p[0][(size_t)j * preds.cw[0] + i];
  int minTu = ttMinTu(E, log2size, false);
  size_t mark = E.ops.size();
  ITt* tree = interTtDecide(E, x, y, log2size, 0, minTu, resiL.data(),
                            size, 0, 0);
  E.truncate(mark);  // luma-only trial syntax
  interTtChroma(E, tree, preds, x, y);
  bool anyCbf = interTtAnyLuma(tree) || tree->cb[0] || tree->cb[1] ||
                tree->cr[0] || tree->cr[1];
  bool isSkip = useMerge && !anyCbf;
  E.recBin(B_SKIP, skipCtxE(E, x, y), isSkip ? 1 : 0);
  E.setRect8(E.skip, x, y, size, size, isSkip ? 1 : 0);
  if (isSkip) {
    writeMergeIdxE(E, desc.mergeIdx);
    E.setRect8(E.cbfY, x, y, size, size, 0);
    predReconCu(E, x, y, size, preds);
    finishCuQp(E, x, y, size);
    delete tree;
    return;
  }
  E.recBin(B_PREDMODE, 0, 0);
  E.recBin(B_PART, 0, 1);  // 2Nx2N
  writePuSyntaxE(E, desc, size, SIZE_2Nx2N);
  if (!useMerge) E.recBin(B_ROOT_CBF, 0, anyCbf ? 1 : 0);
  if (anyCbf) {
    int zero2[2] = {0, 0};
    interTtEmit(E, tree, minTu, zero2, zero2, 0, nullptr, nullptr, preds,
                x, y);
  } else {
    E.setRect8(E.cbfY, x, y, size, size, 0);
    predReconCu(E, x, y, size, preds);
  }
  finishCuQp(E, x, y, size);
  delete tree;
}

// encoder.py _encode_inter_res_part_tree (non-2Nx2N, hierarchy > 0)
static void encodeInterResPartTree(Ctx& E, int x, int y, int log2size,
                                   const std::vector<PuDesc>& descs,
                                   int part, const CuPreds& preds) {
  int size = 1 << log2size;
  std::vector<int32_t> resiL((size_t)size * size);
  const int stride = E.planeW[0];
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++)
      resiL[(size_t)j * size + i] =
          E.orig[0][(size_t)(y + j) * stride + x + i] -
          preds.p[0][(size_t)j * preds.cw[0] + i];
  int minTu = ttMinTu(E, log2size, false);
  size_t mark = E.ops.size();
  ITt* tree = interTtDecide(E, x, y, log2size, 0, minTu, resiL.data(),
                            size, 0, 0);
  E.truncate(mark);
  interTtChroma(E, tree, preds, x, y);
  bool anyCbf = interTtAnyLuma(tree) || tree->cb[0] || tree->cb[1] ||
                tree->cr[0] || tree->cr[1];
  E.recBin(B_SKIP, skipCtxE(E, x, y), 0);
  E.setRect8(E.skip, x, y, size, size, 0);
  E.recBin(B_PREDMODE, 0, 0);
  writeInterPartSizeE(E, part, log2size);
  for (const auto& d : descs) writePuSyntaxE(E, d, size, part);
  E.recBin(B_ROOT_CBF, 0, anyCbf ? 1 : 0);
  if (anyCbf) {
    int zero2[2] = {0, 0};
    interTtEmit(E, tree, minTu, zero2, zero2, 0, nullptr, nullptr, preds,
                x, y);
  } else {
    E.setRect8(E.cbfY, x, y, size, size, 0);
    predReconCu(E, x, y, size, preds);
  }
  finishCuQp(E, x, y, size);
  delete tree;
}

// encoder.py _encode_inter_res_split (non-2Nx2N, hierarchy == 0: forced
// one-level quadtree)
static void encodeInterResSplit(Ctx& E, int x, int y, int log2size,
                                const std::vector<PuDesc>& descs, int part,
                                const CuPreds& preds) {
  int size = 1 << log2size;
  int half = size >> 1;
  int maxv = (1 << E.bd) - 1;
  static const int off[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
  TuOut ctu[4][3];
  static thread_local std::vector<int32_t> resi;
  for (int ci = 0; ci < 4; ci++) {
    int dx = off[ci][0] * half, dy = off[ci][1] * half;
    for (int comp = 0; comp < E.ncomp(); comp++) {
      int ssx = comp ? E.chromaShiftX() : 0;
      int ssy = comp ? E.chromaShiftY() : 0;
      int n = half >> ssx;
      int ox = (x + dx) >> ssx, oy = (y + dy) >> ssy;
      resi.resize((size_t)n * n);
      const int stride = E.planeW[comp];
      for (int j = 0; j < n; j++)
        for (int i = 0; i < n; i++)
          resi[(size_t)j * n + i] =
              E.orig[comp][(size_t)(oy + j) * stride + ox + i] -
              preds.p[comp][(size_t)((dy >> ssy) + j) * preds.cw[comp] +
                            (dx >> ssx) + i];
      tuFwd(E, resi.data(), n, false, comp, SCAN_DIAG, false, &ctu[ci][comp]);
    }
  }
  int rootCb = 0, rootCr = 0;
  for (int ci = 0; ci < 4; ci++) {
    if (E.ncomp() > 1) {
      rootCb |= ctu[ci][1].cbf;
      rootCr |= ctu[ci][2].cbf;
    }
  }
  bool anyCbf = rootCb || rootCr;
  for (int ci = 0; ci < 4; ci++) anyCbf = anyCbf || ctu[ci][0].cbf;

  E.recBin(B_SKIP, skipCtxE(E, x, y), 0);
  E.setRect8(E.skip, x, y, size, size, 0);
  E.recBin(B_PREDMODE, 0, 0);
  writeInterPartSizeE(E, part, log2size);
  for (const auto& d : descs) writePuSyntaxE(E, d, size, part);
  E.recBin(B_ROOT_CBF, 0, anyCbf ? 1 : 0);
  if (anyCbf) {
    int minTuI = ttMinTu(E, log2size, false);
    if (E.maxTrInter > 0) maybeWriteSubdiv(E, log2size, 1, minTuI);
    if (E.cfmt) {
      E.recBin(B_QT_CBF, 5, rootCb);
      E.recBin(B_QT_CBF, 5, rootCr);
    }
    for (int ci = 0; ci < 4; ci++) {
      if (E.maxTrInter > 0 && log2size - 1 != E.log2MinTb &&
          log2size - 1 != minTuI && log2size - 1 <= E.log2MaxTb)
        E.recBin(B_SUBDIV, 5 - (log2size - 1), 0);
      if (rootCb) E.recBin(B_QT_CBF, 6, ctu[ci][1].cbf);
      if (rootCr) E.recBin(B_QT_CBF, 6, ctu[ci][2].cbf);
      E.recBin(B_QT_CBF, 0, ctu[ci][0].cbf);
      maybeWriteDqp(E, ctu[ci][0].cbf || (rootCb && ctu[ci][1].cbf) ||
                           (rootCr && ctu[ci][2].cbf));
      for (int comp = 0; comp < E.ncomp(); comp++) {
        if (comp == 1 && !rootCb) continue;
        if (comp == 2 && !rootCr) continue;
        int ssx = comp ? E.chromaShiftX() : 0;
        int n = half >> ssx;
        if (ctu[ci][comp].cbf)
          encodeResidual(E, ctu[ci][comp].lev, n, n, comp, SCAN_DIAG, E.sdh,
                         ctu[ci][comp].ts);
      }
    }
  }
  // recon + cbf map + TU edge flags per child
  for (int ci = 0; ci < 4; ci++) {
    int dx = off[ci][0] * half, dy = off[ci][1] * half;
    int cx0 = x + dx, cy0 = y + dy;
    E.markTuEdges(cx0, cy0, half);
    E.setRect8(E.cbfY, cx0, cy0, half, half, ctu[ci][0].cbf);
    for (int comp = 0; comp < E.ncomp(); comp++) {
      int ssx = comp ? E.chromaShiftX() : 0;
      int ssy = comp ? E.chromaShiftY() : 0;
      int n = half >> ssx;
      int ox = cx0 >> ssx, oy = cy0 >> ssy;
      bool cbfOk = ctu[ci][comp].cbf &&
                   (comp == 0 || (comp == 1 ? rootCb : rootCr));
      const int stride = E.planeW[comp];
      for (int j = 0; j < n; j++)
        for (int i = 0; i < n; i++) {
          int v = preds.p[comp][(size_t)((dy >> ssy) + j) * preds.cw[comp] +
                                (dx >> ssx) + i];
          if (cbfOk) v += ctu[ci][comp].rec[(size_t)j * n + i];
          E.recon[comp][(size_t)(oy + j) * stride + ox + i] =
              clip3(0, maxv, v);
        }
    }
  }
  finishCuQp(E, x, y, size);
}

// encoder.py _inter_2nx2n_rd (merge 2Nx2N: forced-skip vs coded-residual)
static void inter2nx2nRd(Ctx& E, int x, int y, int log2size,
                         const PuDesc& desc, const CuPreds& preds) {
  if (!desc.isMerge) {
    encodeInterRes2nx2n(E, x, y, log2size, desc, preds);
    return;
  }
  int size = 1 << log2size;
  CuSnap st;
  saveCu(E, x, y, size, &st);
  size_t mark = st.nops;
  emitSkipCuE(E, x, y, log2size, desc, preds);
  double costSkip = cuRdCost(E, x, y, size, mark);
  restoreCu(E, st);
  encodeInterRes2nx2n(E, x, y, log2size, desc, preds);
  double costFull = cuRdCost(E, x, y, size, mark);
  if (costSkip < costFull) {
    restoreCu(E, st);
    emitSkipCuE(E, x, y, log2size, desc, preds);
  }
}

// apply PU maps + PU edge flags, compute per-comp predictions
// (encoder.py encode_cu_inter.apply_and_preds)
static void applyAndPredsE(Ctx& E, int x, int y, int size, int part,
                           const std::vector<PuDesc>& descs, CuPreds* out) {
  int pus[4][4];
  int npu = puPartitionsE(part, size, pus);
  for (int pu = 0; pu < npu; pu++) {
    int dx = pus[pu][0], dy = pus[pu][1], w = pus[pu][2], h = pus[pu][3];
    applyPuE(E, descs[pu], x + dx, y + dy, w, h, x, y, size, pu);
    for (int j = (y + dy) >> 2; j < (y + dy + h) >> 2; j++)
      E.edgeFlags[(size_t)j * E.w4 + ((x + dx) >> 2)] |= EDGE_PU_LEFT;
    for (int i = (x + dx) >> 2; i < (x + dx + w) >> 2; i++)
      E.edgeFlags[(size_t)((y + dy) >> 2) * E.w4 + i] |= EDGE_PU_TOP;
  }
  static thread_local std::vector<int32_t> blk;
  for (int comp = 0; comp < E.ncomp(); comp++) {
    int ssx = comp ? E.chromaShiftX() : 0;
    int ssy = comp ? E.chromaShiftY() : 0;
    int cw = size >> ssx, chh = size >> ssy;
    out->cw[comp] = cw;
    out->chh[comp] = chh;
    out->p[comp].assign((size_t)cw * chh, 0);
    for (int pu = 0; pu < npu; pu++) {
      int dx = pus[pu][0], dy = pus[pu][1], w = pus[pu][2], h = pus[pu][3];
      const PuDesc& d = descs[pu];
      int dir;
      const int (*mvs)[2];
      const int* ridx;
      if (d.isMerge) {
        dir = d.mergeDir;
        mvs = d.cand.mv;
        ridx = d.cand.refIdx;
      } else {
        dir = d.dir;
        mvs = d.mv;
        ridx = d.refIdx;
      }
      int bw = w >> ssx, bh = h >> ssy;
      blk.resize((size_t)bw * bh);
      int mvs2[2][2] = {{mvs[0][0], mvs[0][1]}, {mvs[1][0], mvs[1][1]}};
      int ridx2[2] = {ridx[0], ridx[1]};
      predFromCand(E, comp, x + dx, y + dy, w, h, dir, mvs2, ridx2,
                   blk.data());
      for (int j = 0; j < bh; j++)
        std::memcpy(&out->p[comp][(size_t)((dy >> ssy) + j) * cw +
                                  (dx >> ssx)],
                    &blk[(size_t)j * bw], (size_t)bw * sizeof(int32_t));
    }
  }
}

// motion-map snapshot over one CU rect (encoder.py _snapshot_motion)
struct MotionSnap {
  int x, y, size, m;
  std::vector<int8_t> dir, refIdxS, refLtS;
  std::vector<int32_t> mvS, refPocS;
};

static void snapshotMotion(const Ctx& E, int x, int y, int size,
                           MotionSnap* s) {
  s->x = x; s->y = y; s->size = size;
  int m = size >> 2;
  s->m = m;
  s->dir.resize((size_t)m * m);
  s->refIdxS.resize((size_t)m * m * 2);
  s->refLtS.resize((size_t)m * m * 2);
  s->mvS.resize((size_t)m * m * 4);
  s->refPocS.resize((size_t)m * m * 2);
  for (int j = 0; j < m; j++) {
    size_t row = (size_t)((y >> 2) + j) * E.w4 + (x >> 2);
    std::memcpy(&s->dir[(size_t)j * m], E.interDir + row, m);
    std::memcpy(&s->refIdxS[(size_t)j * m * 2], E.refIdx + row * 2, m * 2);
    std::memcpy(&s->refLtS[(size_t)j * m * 2], E.refIsLt + row * 2, m * 2);
    std::memcpy(&s->mvS[(size_t)j * m * 4], E.mv + row * 4,
                (size_t)m * 4 * sizeof(int32_t));
    std::memcpy(&s->refPocS[(size_t)j * m * 2], E.refPocM + row * 2,
                (size_t)m * 2 * sizeof(int32_t));
  }
}

static void restoreMotion(Ctx& E, const MotionSnap& s) {
  int m = s.m;
  for (int j = 0; j < m; j++) {
    size_t row = (size_t)((s.y >> 2) + j) * E.w4 + (s.x >> 2);
    std::memcpy(E.interDir + row, &s.dir[(size_t)j * m], m);
    std::memcpy(E.refIdx + row * 2, &s.refIdxS[(size_t)j * m * 2], m * 2);
    std::memcpy(E.refIsLt + row * 2, &s.refLtS[(size_t)j * m * 2], m * 2);
    std::memcpy(E.mv + row * 4, &s.mvS[(size_t)j * m * 4],
                (size_t)m * 4 * sizeof(int32_t));
    std::memcpy(E.refPocM + row * 2, &s.refPocS[(size_t)j * m * 2],
                (size_t)m * 2 * sizeof(int32_t));
  }
}

// intra emission inside an inter slice (encoder.py emit_intra)
static void emitIntraInInterE(Ctx& E, int x, int y, int log2size,
                              int depth) {
  int size = 1 << log2size;
  E.setRect8(E.partSize, x, y, size, size, SIZE_2Nx2N);
  E.recBin(B_SKIP, skipCtxE(E, x, y), 0);
  E.setRect8(E.skip, x, y, size, size, 0);
  E.recBin(B_PREDMODE, 0, 1);
  cuIntraBody(E, x, y, log2size, depth);
}

// encoder.py encode_cu_inter
void encodeCuInter(Ctx& E, int x, int y, int log2size, int depth) {
  int size = 1 << log2size;
  E.curDepth = depth;
  E.setRect8(E.depth, x, y, size, size, depth);
  E.markEdges(x, y, size);
  double lam = E.lamMotion;

  // ---- partition trials ----
  std::vector<int> parts;
  parts.push_back(SIZE_2Nx2N);
  if (log2size >= 4) {
    parts.push_back(SIZE_2NxN);
    parts.push_back(SIZE_Nx2N);
    if (E.ampEnabled && log2size > E.log2MinCb) {
      parts.push_back(SIZE_2NxnU);
      parts.push_back(SIZE_2NxnD);
      parts.push_back(SIZE_nLx2N);
      parts.push_back(SIZE_nRx2N);
    }
  }
  struct PartTrial {
    double total;
    int part;
    std::vector<PuDesc> descs;
    int order;
  };
  std::vector<PartTrial> partTrials;
  std::vector<PuDesc> merge2nAll;
  std::vector<std::pair<double, PuDesc>> me2n;
  E.setRect8(E.predMode, x, y, size, size, MODE_INTER);
  E.setRect8(E.skip, x, y, size, size, 0);
  int bestIdx = -1;
  for (size_t pi = 0; pi < parts.size(); pi++) {
    int part = parts[pi];
    E.setRect8(E.partSize, x, y, size, size, part);
    MotionSnap snap;
    snapshotMotion(E, x, y, size, &snap);
    PartTrial t;
    t.part = part;
    t.order = (int)pi;
    t.total = lam * (part == SIZE_2Nx2N ? 1 : 2);
    E.puLastMode = 0;
    int pus[4][4];
    int npu = puPartitionsE(part, size, pus);
    std::vector<PuDesc> mc;
    std::vector<std::pair<double, PuDesc>> ma;
    for (int pu = 0; pu < npu; pu++) {
      int dx = pus[pu][0], dy = pus[pu][1], w = pus[pu][2], h = pus[pu][3];
      PuDesc d;
      double cost = bestPuMotionE(E, x + dx, y + dy, w, h, x, y, size, pu,
                                  part, &d, &mc, &ma);
      t.total += cost;
      t.descs.push_back(d);
      applyPuE(E, d, x + dx, y + dy, w, h, x, y, size, pu);
    }
    if (part == SIZE_2Nx2N) {
      merge2nAll = mc;
      me2n = ma;
    }
    restoreMotion(E, snap);
    if (bestIdx < 0 || t.total < partTrials[bestIdx].total)
      bestIdx = (int)partTrials.size();
    partTrials.push_back(std::move(t));
  }
  const PartTrial& bestPart = partTrials[bestIdx];

  // ---- intra candidate (SATD preselect) ----
  AllPreds all;
  predictAllModes(E, 0, x, y, size, &all);
  static thread_local std::vector<int32_t> orig32;
  orig32.resize((size_t)size * size);
  const int strideL = E.planeW[0];
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++)
      orig32[(size_t)j * size + i] =
          E.orig[0][(size_t)(y + j) * strideL + x + i];
  int bestMode = 0;
  long long bestSad = -1;
  for (int m = 0; m < 35; m++) {
    const int32_t* p = all.at(m);
    long long sad = 0;
    for (int i = 0; i < size * size; i++) {
      int d = p[i] - orig32[i];
      sad += d < 0 ? -d : d;
    }
    if (bestSad < 0 || sad < bestSad) { bestSad = sad; bestMode = m; }
  }
  long long bestIcost =
      satd32(all.at(bestMode), orig32.data(), size, size) >> (E.bd - 8);

  auto emitInter = [&](int part, const std::vector<PuDesc>& descs) {
    E.setRect8(E.partSize, x, y, size, size, part);
    CuPreds preds;
    applyAndPredsE(E, x, y, size, part, descs, &preds);
    if (part == SIZE_2Nx2N)
      inter2nx2nRd(E, x, y, log2size, descs[0], preds);
    else if (E.maxTrInter > 0)
      encodeInterResPartTree(E, x, y, log2size, descs, part, preds);
    else
      encodeInterResSplit(E, x, y, log2size, descs, part, preds);
  };

  // ---- full-RD CU-mode arbitration (always the recording coder natively)
  std::vector<std::function<void()>> cands;
  int nfull = E.rdParts ? E.rdParts : (int)partTrials.size();
  std::vector<int> rankedIdx(partTrials.size());
  for (size_t i = 0; i < partTrials.size(); i++) rankedIdx[i] = (int)i;
  std::stable_sort(rankedIdx.begin(), rankedIdx.end(), [&](int a, int b) {
    return partTrials[a].total < partTrials[b].total;
  });
  if ((size_t)nfull < rankedIdx.size()) rankedIdx.resize(nfull);
  bool have2n = false;
  for (int ri : rankedIdx) {
    const PartTrial& t = partTrials[ri];
    if (t.part == SIZE_2Nx2N) have2n = true;
    cands.push_back([&, ri]() {
      emitInter(partTrials[ri].part, partTrials[ri].descs);
    });
  }
  int twonIdx = 0;
  for (size_t i = 0; i < partTrials.size(); i++)
    if (partTrials[i].part == SIZE_2Nx2N) { twonIdx = (int)i; break; }
  if (!have2n)
    cands.push_back([&]() {
      emitInter(SIZE_2Nx2N, partTrials[twonIdx].descs);
    });
  // every deduped 2Nx2N merge candidate gets a full-RD trial
  const PuDesc& t2d = partTrials[twonIdx].descs[0];
  std::vector<std::vector<PuDesc>> single;
  single.reserve(merge2nAll.size() + me2n.size());
  for (const auto& mdesc : merge2nAll) {
    if (t2d.isMerge && t2d.mergeIdx == mdesc.mergeIdx) continue;
    single.push_back({mdesc});
    size_t si = single.size() - 1;
    cands.push_back([&, si]() { emitInter(SIZE_2Nx2N, single[si]); });
  }
  // uni-ME champions
  if (E.rdUni) {
    for (const auto& cd : me2n) {
      const PuDesc& mdesc = cd.second;
      if (mdesc.dir == 3 || (!t2d.isMerge && t2d.dir == mdesc.dir)) continue;
      single.push_back({mdesc});
      size_t si = single.size() - 1;
      cands.push_back([&, si]() { emitInter(SIZE_2Nx2N, single[si]); });
    }
  }
  if ((double)bestIcost < 2 * bestPart.total + lam * 48)
    cands.push_back([&]() { emitIntraInInterE(E, x, y, log2size, depth); });

  int bestCand = -1;
  double bestCost = 0;
  for (size_t ci = 0; ci < cands.size(); ci++) {
    CuSnap st;
    saveCu(E, x, y, size, &st);
    size_t mark = E.ops.size();
    cands[ci]();
    double cost = cuRdCost(E, x, y, size, mark);
    if (bestCand < 0 || cost < bestCost) {
      bestCand = (int)ci;
      bestCost = cost;
    }
    restoreCu(E, st);
  }
  cands[bestCand]();
}

}  // namespace encctu
}  // namespace hevc

// ---------------------------------------------------------------------------
// inter C API additions (ctypes bridge: encoder.py _native_compress)
// ---------------------------------------------------------------------------
extern "C" {

void enc_ctu_set_ref(void* h, int list, int idx, const int16_t* p0,
                     const int16_t* p1, const int16_t* p2,
                     const int16_t* padded, int padW, int padH, int planeId,
                     int poc, int isLt) {
  using namespace hevc::encctu;
  Ctx* E = static_cast<Ctx*>(h);
  Ctx::Ref r;
  r.plane[0] = p0;
  r.plane[1] = p1;
  r.plane[2] = p2;
  r.padded = padded;
  r.padW = padW;
  r.padH = padH;
  r.planeId = planeId;
  r.poc = poc;
  r.isLt = isLt;
  if ((int)E->refs[list].size() <= idx) E->refs[list].resize(idx + 1);
  E->refs[list][idx] = r;
}

void enc_ctu_set_col(void* h, const int8_t* predMode, const int8_t* interDir,
                     const int32_t* mv, const int32_t* refPoc,
                     const int8_t* refIsLt, int w4, int h4, int colPoc) {
  using namespace hevc::encctu;
  Ctx* E = static_cast<Ctx*>(h);
  E->col.valid = true;
  E->col.predMode = predMode;
  E->col.interDir = interDir;
  E->col.mv = mv;
  E->col.refPoc = refPoc;
  E->col.refIsLt = refIsLt;
  E->col.w4 = w4;
  E->col.h4 = h4;
  E->col.poc = colPoc;
}

}  // extern "C"
