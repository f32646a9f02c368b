// Copied from libhm_tpu/hostdec/native/rdoq.cpp
// Rate-distortion optimized quantization — native port of
// encoder/rdoq.py (itself a rebuild of reference
// TComTrQuant::xRateDistOptQuant, TComTrQuant.cpp).  Bit-exact mirror of
// the Python implementation: same double-precision operation order, same
// entropy-bit model p_LPS(s) = 0.5 * alpha^s, alpha = (0.01875/0.5)^(1/63)
// (reference ContextModel.cpp sm_aucNextStateMPS / g_entropyBits source
// model), rates in 1/32768-bit fixed point.
//
// Compiled into libhevcdec.so via api.cpp (same translation unit as
// recon.cpp / encsearch.cpp).

#include <cmath>
#include <cstdint>
#include <vector>

#include "tables_gen.h"

namespace hevc {
namespace rdoq {

constexpr double kFrac = 32768.0;
constexpr int kCoefRemainBinReduction = 3;  // residual.py:18
constexpr int kC1FlagNumber = 8;            // residual.py:20

// quant scales (tables.py QUANT_SCALES / reference g_quantScales)
static const int kQuantScales[6] = {26214, 23302, 20560, 18396, 16384, 14564};

// last-position group index (tables.py GROUP_IDX, Table 9-48 support)
static const int kGroupIdx[32] = {0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6,
                                  7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8,
                                  9, 9, 9, 9, 9, 9, 9, 9};

// 4x4 significance context map (residual.py CTX_IND_MAP_4x4, Table 9-39)
static const int kCtxIndMap4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                      6, 6, 8, 8, 7, 7, 8, 8};

// significance context set layout (residual.py SIG_SET_START,
// ContextTables.h:85); [chroma][bucket 4x4/8x8/NxN]
static const int kSigSetStart[2][3] = {{0, 9, 21}, {0, 9, 12}};
static const int kNonDiag8x8Offset[2] = {6, 0};
static const int kNotFirstGroupOffset[2] = {3, 0};

// entropy-bit tables per pState (0..63): bits for coding the LPS / MPS,
// in 1/32768 units.  Models the REAL renormalized arithmetic coder (the
// reference's corrected FAST_BIT_EST table, ContextModel.cpp:106-118):
// cost = E_{R ~ 1/R on [256,510]}[log2(R / R')] with R' from the LPS
// range table.  OPERATION-IDENTICAL to rdoq.py module init — both paths
// must price RD with bit-equal doubles for byte identity.
struct EstBits {
  double lps[64];
  double mps[64];
  EstBits() {
    double wsum = 0.0;
    for (int r = 256; r <= 510; r++) wsum += 1.0 / r;
    for (int i = 0; i < 64; i++) {
      double em = 0.0, el = 0.0;
      for (int r = 256; r <= 510; r++) {
        double w = (1.0 / r) / wsum;
        double rl = (double)kLpsTable[i * 4 + ((r >> 6) & 3)];
        // volatile temporaries block FMA contraction: the multiply must
        // round to double before the add, exactly like the Python loop
        // (byte parity requires bit-equal tables on both sides)
        volatile double tm = w * std::log2(r / ((double)r - rl));
        volatile double tl = w * std::log2(r / rl);
        em += tm;
        el += tl;
      }
      mps[i] = em * kFrac;
      lps[i] = el * kFrac;
    }
  }
};
static const EstBits kEst;

static inline double ctxBits(const int32_t* arr, int idx, int binval) {
  int state = arr[idx];
  int mps = state & 1;
  int ps = state >> 1;
  return binval == mps ? kEst.mps[ps] : kEst.lps[ps];
}

// adaptive variant: price at the current (local-copy) state, then advance
// it — the trial-coder semantics of the RD search (reference
// TEncBinCABACCounter accumulates fractional bits while the context
// model adapts through the trial).  RDOQ itself stays frozen-state, like
// the reference's per-TU estBits snapshot.
static inline double ctxBitsAdapt(int32_t* arr, int idx, int binval) {
  int state = arr[idx];
  int ps = state >> 1;
  double r = binval == (state & 1) ? kEst.mps[ps] : kEst.lps[ps];
  arr[idx] = binval == (state & 1) ? kNextStateMps[state]
                                   : kNextStateLps[state];
  return r;
}

// scan orders (tables.py scan_order): kind 0 diag-up-right, 1 hor, 2 ver.
// Writes (x, y) pairs.
static void scanOrder(int w, int h, int kind, int* xs, int* ys) {
  int i = 0;
  if (kind == 1) {
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) { xs[i] = x; ys[i] = y; i++; }
    return;
  }
  if (kind == 2) {
    for (int x = 0; x < w; x++)
      for (int y = 0; y < h; y++) { xs[i] = x; ys[i] = y; i++; }
    return;
  }
  for (int d = 0; d < w + h - 1; d++) {
    int y = d < h - 1 ? d : h - 1;
    int x = d - y;
    while (y >= 0 && x < w) { xs[i] = x; ys[i] = y; i++; y--; x++; }
  }
}

// fractional bits for |level| >= 1 given running per-CG state
// (rdoq.py _rate_abs_level / reference xGetICRateCost)
static double rateAbsLevel(long long absLevel, int c1, int ctxSet, int c1Idx,
                           int c2Idx, int goRice, const int32_t* gt1,
                           const int32_t* gt2) {
  double rate = kFrac;  // sign bypass
  int baseGt1 = 4 * ctxSet;
  long long base;
  if (c1Idx < kC1FlagNumber) {
    if (absLevel == 1) return rate + ctxBits(gt1, baseGt1 + c1, 0);
    rate += ctxBits(gt1, baseGt1 + c1, 1);
    if (c2Idx == 0) {
      if (absLevel == 2) return rate + ctxBits(gt2, ctxSet, 0);
      rate += ctxBits(gt2, ctxSet, 1);
      base = 3;
    } else {
      base = 2;
    }
  } else {
    base = 1;
  }
  long long sym = absLevel - base;
  long long length;
  if ((sym >> goRice) < kCoefRemainBinReduction) {
    length = (sym >> goRice) + 1 + goRice;
  } else {
    length = kCoefRemainBinReduction + goRice;
    long long sym2 = sym - ((long long)kCoefRemainBinReduction << goRice);
    while (sym2 >= (1LL << (length - kCoefRemainBinReduction - goRice))) {
      length++;
      if (length > 64) break;
    }
    long long L = length - kCoefRemainBinReduction - goRice;
    length = kCoefRemainBinReduction + L + 1 + L + goRice;
  }
  return rate + (double)length * kFrac;
}

// fractional bits of last_sig_coeff_x/y (rdoq.py _rate_last)
static double rateLast(int posX, int posY, int w, int h, int isChroma,
                       int scanType, const int32_t* lastX,
                       const int32_t* lastY) {
  if (scanType == 2) {
    int t = posX; posX = posY; posY = t;
    t = w; w = h; h = t;
  }
  int log2w = 31 - __builtin_clz((unsigned)w);
  int log2h = 31 - __builtin_clz((unsigned)h);
  int offX, offY, shiftX, shiftY;
  if (isChroma) {
    offX = offY = 15;
    shiftX = log2w - 2; shiftY = log2h - 2;
  } else {
    offX = 3 * (log2w - 2) + ((log2w - 1) >> 2);
    offY = 3 * (log2h - 2) + ((log2h - 1) >> 2);
    shiftX = (log2w + 1) >> 2; shiftY = (log2h + 1) >> 2;
  }
  int gx = kGroupIdx[posX], gy = kGroupIdx[posY];
  double r = 0.0;
  for (int i = 0; i < gx; i++) r += ctxBits(lastX, offX + (i >> shiftX), 1);
  if (gx < kGroupIdx[w - 1]) r += ctxBits(lastX, offX + (gx >> shiftX), 0);
  for (int i = 0; i < gy; i++) r += ctxBits(lastY, offY + (i >> shiftY), 1);
  if (gy < kGroupIdx[h - 1]) r += ctxBits(lastY, offY + (gy >> shiftY), 0);
  if (gx > 3) r += (double)((gx - 2) >> 1) * kFrac;
  if (gy > 3) r += (double)((gy - 2) >> 1) * kFrac;
  return r;
}

// RDO-quantize one square TU (rdoq.py rdoq()).  coef/out: n*n raster int32.
// Context arrays come straight from the Python bank (combined
// (pState<<1)|MPS int32 states, read-only).
static void run(const int32_t* coef, int qp, int log2Size, int bitDepth,
                int comp, int scanType, const int32_t* sig,
                const int32_t* sigCgCtx, const int32_t* gt1,
                const int32_t* gt2, const int32_t* lastX,
                const int32_t* lastY, double lam, int maxDynRange,
                int32_t* out) {
  const int n = 1 << log2Size;
  const int per = qp / 6, rem = qp % 6;
  const int tshift = maxDynRange - bitDepth - log2Size;
  const int qbits = 14 + per + tshift;
  const long long scale = kQuantScales[rem];
  // same operation order as rdoq.py: pow2 / (scale*scale) / (1<<..)
  const double errScale = std::pow(2.0, -2.0 * (double)tshift) /
                          (double)(scale * scale) /
                          (double)(1 << (2 * (bitDepth - 8)));
  const double lamBits = lam / kFrac;

  const int w = n, h = n, log2w = log2Size;
  const int isChroma = comp > 0 ? 1 : 0;
  const int ch = isChroma;
  const int n2 = w * h;

  // grouped scan: scan position -> raster blk (residual.py _grouped_scan)
  const int wg = w >> 2, hg = h >> 2;
  int cgx_[64], cgy_[64], inx[16], iny[16];
  scanOrder(wg, hg, scanType, cgx_, cgy_);
  scanOrder(4, 4, scanType, inx, iny);
  static thread_local std::vector<int> scan;
  scan.resize(n2);
  {
    int i = 0;
    for (int g = 0; g < wg * hg; g++)
      for (int k = 0; k < 16; k++) {
        scan[i++] = (cgy_[g] * 4 + iny[k]) * w + cgx_[g] * 4 + inx[k];
      }
  }

  static thread_local std::vector<long long> cs, ld, maxAbs, level;
  static thread_local std::vector<double> costCoeff, costCoeff0, costSig;
  cs.resize(n2); ld.resize(n2); maxAbs.resize(n2); level.assign(n2, 0);
  costCoeff.assign(n2, 0.0); costCoeff0.resize(n2); costSig.assign(n2, 0.0);

  int lastScanPos = -1;
  for (int i = 0; i < n2; i++) {
    long long c = coef[scan[i]];
    cs[i] = c;
    long long a = c < 0 ? -c : c;
    ld[i] = a * scale;
    maxAbs[i] = (ld[i] + (1LL << (qbits - 1))) >> qbits;
    if (maxAbs[i]) lastScanPos = i;
    double d = (double)ld[i];
    costCoeff0[i] = d * d * errScale;
  }
  for (int i = 0; i < n2; i++) out[i] = 0;
  if (lastScanPos < 0) return;

  int firstSigCtx;
  if (w == 4) firstSigCtx = kSigSetStart[ch][0];
  else if (w == 8) {
    firstSigCtx = kSigSetStart[ch][1];
    if (scanType != 0) firstSigCtx += kNonDiag8x8Offset[ch];
  } else {
    firstSigCtx = kSigSetStart[ch][2];
  }
  const int sigBase = isChroma ? 28 : 0;

  int sigCg[64] = {0};
  const int lastCg = lastScanPos >> 4;

  double baseCost = 0.0;
  int c1 = 1;
  for (int subset = lastCg; subset >= 0; subset--) {
    const int subPos = subset << 4;
    const int cgx = cgx_[subset], cgy = cgy_[subset];
    const int cgBlk = cgy * wg + cgx;
    const int right = cgx < wg - 1 ? sigCg[cgBlk + 1] : 0;
    const int below = cgy < hg - 1 ? sigCg[cgBlk + wg] : 0;
    const int pattern = (wg <= 1 && hg <= 1) ? 0 : right + (below << 1);

    int ctxSet;
    if (isChroma) ctxSet = 4 + (c1 == 0 ? 1 : 0);
    else ctxSet = (subset > 0 ? 2 : 0) + (c1 == 0 ? 1 : 0);
    c1 = 1;
    int c1Idx = 0, c2Idx = 0, goRice = 0;
    double cgCost = 0.0, cgCostZero = 0.0;
    const int top = lastScanPos < subPos + 15 ? lastScanPos : subPos + 15;
    for (int sp = top; sp >= subPos; sp--) {
      const int blk = scan[sp];
      const int py = blk >> log2w;
      const int px = blk - (py << log2w);
      int sctx;
      if (px + py == 0) {
        sctx = 0;
      } else if (w == 4) {
        sctx = firstSigCtx + kCtxIndMap4x4[4 * py + px];
      } else {
        const int xin = px & 3, yin = py & 3;
        int cnt;
        if (pattern == 0) {
          int t = xin + yin;
          cnt = t >= 3 ? 0 : (t >= 1 ? 1 : 2);
        } else if (pattern == 1) {
          cnt = yin >= 2 ? 0 : (yin >= 1 ? 1 : 2);
        } else if (pattern == 2) {
          cnt = xin >= 2 ? 0 : (xin >= 1 ? 1 : 2);
        } else {
          cnt = 2;
        }
        const int notFirst = ((px >> 2) + (py >> 2)) > 0;
        sctx = firstSigCtx + cnt + (notFirst ? kNotFirstGroupOffset[ch] : 0);
      }
      const double sig1 = lamBits * ctxBits(sig, sigBase + sctx, 1);
      const double sig0 = lamBits * ctxBits(sig, sigBase + sctx, 0);
      const bool isLast = sp == lastScanPos;

      const long long ma = maxAbs[sp];
      double bestCost = 0.0, bestSig = 0.0;
      bool haveBest = false;
      long long bestLvl = 0;
      if (!isLast) {
        bestCost = costCoeff0[sp] + sig0;
        bestSig = 0.0;
        haveBest = true;
      }
      const long long lo = ma - 1 > 1 ? ma - 1 : 1;
      for (long long l = ma; l >= lo; l--) {
        const double dd = (double)(ld[sp] - (l << qbits));
        const double d = dd * dd * errScale;
        const double r = rateAbsLevel(l, c1, ctxSet, c1Idx, c2Idx, goRice,
                                      gt1, gt2);
        const double c = d + lamBits * r + (isLast ? 0.0 : sig1);
        if (!haveBest || c < bestCost) {
          haveBest = true;
          bestCost = c;
          bestLvl = l;
          bestSig = isLast ? 0.0 : sig1;
        }
      }
      level[sp] = bestLvl;
      costCoeff[sp] = bestCost;
      costSig[sp] = bestSig;
      cgCost += bestCost;
      cgCostZero += costCoeff0[sp];
      if (bestLvl) {
        sigCg[cgBlk] = 1;
        if (c1Idx < kC1FlagNumber) {
          if (bestLvl > 1) {
            if (c2Idx == 0) c2Idx = 1;
            c1 = 0;
          } else if (c1 > 0 && c1 < 3) {
            c1++;
          }
          c1Idx++;
        }
        const long long baseLvl =
            c1Idx <= kC1FlagNumber ? (2 + (c2Idx ? 1 : 0)) : 1;
        if (bestLvl >= baseLvl && bestLvl > (3LL << goRice))
          goRice = goRice + 1 < 4 ? goRice + 1 : 4;
      }
    }

    // coefficient-group significance decision
    if (subset == lastCg || subset == 0) {
      sigCg[cgBlk] = 1;
      baseCost += cgCost;
    } else {
      const int ctxg = 2 * ch + ((right || below) ? 1 : 0);
      const double bit1 = lamBits * ctxBits(sigCgCtx, ctxg, 1);
      const double bit0 = lamBits * ctxBits(sigCgCtx, ctxg, 0);
      if (sigCg[cgBlk]) {
        const double coded = cgCost + bit1;
        const double zeroed = cgCostZero + bit0;
        if (zeroed < coded) {
          sigCg[cgBlk] = 0;
          const int end = subPos + 16 < n2 ? subPos + 16 : n2;
          for (int sp = subPos; sp < end; sp++) {
            level[sp] = 0;
            costCoeff[sp] = costCoeff0[sp];
            costSig[sp] = 0.0;
          }
          baseCost += zeroed;
          c1 = 1;
        } else {
          baseCost += coded;
        }
      } else {
        baseCost += cgCostZero + bit0;
      }
    }
  }

  // last-position sweep (reference d64BestCost loop); the all-zero cost is
  // accumulated sequentially in scan order to match the Python mirror
  double bestCost = 0.0;
  for (int sp = 0; sp <= lastScanPos; sp++) bestCost += costCoeff0[sp];
  int bestLastP1 = 0;
  for (int sp = lastScanPos; sp >= 0; sp--) {
    if (level[sp] > 0) {
      const int blk = scan[sp];
      const int py = blk >> log2w;
      const int px = blk - (py << log2w);
      const double rlast =
          lamBits * rateLast(px, py, w, h, isChroma, scanType, lastX, lastY);
      const double total = baseCost - costSig[sp] + rlast;
      if (total < bestCost) {
        bestCost = total;
        bestLastP1 = sp + 1;
      }
      if (level[sp] > 1) break;
      baseCost -= costCoeff[sp];
      baseCost += costCoeff0[sp];
    } else {
      baseCost -= costSig[sp];
    }
  }

  for (int sp = bestLastP1; sp <= lastScanPos; sp++) level[sp] = 0;
  for (int sp = 0; sp < n2; sp++) {
    long long l = level[sp] < 32767 ? level[sp] : 32767;
    out[scan[sp]] = (int32_t)(cs[sp] < 0 ? -l : (cs[sp] > 0 ? l : 0));
  }
}

// ---------------------------------------------------------------------------
// Estimated fractional bits of residual_coding() for one TU — bits-only
// mirror of encoder/residual_enc.py encode_residual followed by
// encoder/encoder.py _est_ops_bits: every context bin is priced at the
// CURRENT bank state (no state advance — trial semantics), bypass bins
// cost exactly 1.  Accumulation order equals the emission order so the
// result is bit-identical to the recorded-ops estimate.
// ---------------------------------------------------------------------------
static const int kMinInGroup[10] = {0, 1, 2, 3, 4, 6, 8, 12, 16, 24};

static double lastSigBits(int posX, int posY, int w, int h, int isChroma,
                          int scanType, int32_t* lastX,
                          int32_t* lastY, double tot) {
  if (scanType == 2) {
    int t = posX; posX = posY; posY = t;
    t = w; w = h; h = t;
  }
  int log2w = 31 - __builtin_clz((unsigned)w);
  int log2h = 31 - __builtin_clz((unsigned)h);
  int offX, offY, shiftX, shiftY;
  if (isChroma) {
    offX = offY = 15;
    shiftX = log2w - 2; shiftY = log2h - 2;
  } else {
    offX = 3 * (log2w - 2) + ((log2w - 1) >> 2);
    offY = 3 * (log2h - 2) + ((log2h - 1) >> 2);
    shiftX = (log2w + 1) >> 2; shiftY = (log2h + 1) >> 2;
  }
  int gx = kGroupIdx[posX], gy = kGroupIdx[posY];
  for (int i = 0; i < gx; i++)
    tot += ctxBitsAdapt(lastX, offX + (i >> shiftX), 1);
  if (gx < kGroupIdx[w - 1])
    tot += ctxBitsAdapt(lastX, offX + (gx >> shiftX), 0);
  for (int i = 0; i < gy; i++)
    tot += ctxBitsAdapt(lastY, offY + (i >> shiftY), 1);
  if (gy < kGroupIdx[h - 1])
    tot += ctxBitsAdapt(lastY, offY + (gy >> shiftY), 0);
  if (gx > 3) tot += (double)((gx - 2) >> 1) * kFrac;
  if (gy > 3) tot += (double)((gy - 2) >> 1) * kFrac;
  return tot;
}

// bits of encode_coef_remain (all bypass).  Python records one op per
// prefix bin plus one bypass_bins op; the estimate sums them in that
// order, so accumulate identically (FP association matters for parity).
static inline double coefRemainBits(long long v, int rice, double tot) {
  if ((v >> rice) < kCoefRemainBinReduction) {
    long long prefix = v >> rice;
    for (long long i = 0; i < prefix + 1; i++) tot += kFrac;
    tot += (double)rice * kFrac;
    return tot;
  }
  long long vr = v >> rice;
  int L = 63 - __builtin_clzll((unsigned long long)(vr - 2));
  for (int i = 0; i < kCoefRemainBinReduction + L + 1; i++) tot += kFrac;
  tot += (double)(L + rice) * kFrac;
  return tot;
}

static double residualBits(const int32_t* coeffs, int w, int h, int comp,
                           int scanType, int signHiding, int tsFlag,
                           const int32_t* sigIn, const int32_t* sigCgIn,
                           const int32_t* gt1In, const int32_t* gt2In,
                           const int32_t* lastXIn, const int32_t* lastYIn,
                           const int32_t* tsIn, double tot) {
  // local context copies: the pricer adapts states through the block
  // (trial-coder semantics) without touching the live bank
  int32_t sig[44], sigCgCtx[4], gt1[24], gt2[6], lastX[30], lastY[30],
      tsCtx[2];
  for (int i = 0; i < 44; i++) sig[i] = sigIn[i];
  for (int i = 0; i < 4; i++) sigCgCtx[i] = sigCgIn[i];
  for (int i = 0; i < 24; i++) gt1[i] = gt1In[i];
  for (int i = 0; i < 6; i++) gt2[i] = gt2In[i];
  for (int i = 0; i < 30; i++) { lastX[i] = lastXIn[i]; lastY[i] = lastYIn[i]; }
  for (int i = 0; i < 2; i++) tsCtx[i] = tsIn[i];
  const int isChroma = comp > 0 ? 1 : 0;
  const int ch = isChroma;
  const int log2w = 31 - __builtin_clz((unsigned)w);
  if (tsFlag >= 0) tot += ctxBitsAdapt(tsCtx, comp == 0 ? 0 : 1, tsFlag);

  // grouped scan
  const int wg = w >> 2, hg = h >> 2;
  int cgx_[64], cgy_[64], inx[16], iny[16];
  scanOrder(wg, hg, scanType, cgx_, cgy_);
  scanOrder(4, 4, scanType, inx, iny);
  static thread_local std::vector<int> scan;
  const int n2 = w * h;
  scan.resize(n2);
  {
    int i = 0;
    for (int g = 0; g < wg * hg; g++)
      for (int k = 0; k < 16; k++)
        scan[i++] = (cgy_[g] * 4 + iny[k]) * w + cgx_[g] * 4 + inx[k];
  }
  int scanPosLast = -1;
  for (int i = 0; i < n2; i++)
    if (coeffs[scan[i]]) scanPosLast = i;
  if (scanPosLast < 0) return tot;  // caller guarantees nonzero
  const int blkLast = scan[scanPosLast];
  const int posY0 = blkLast >> log2w;
  const int posX0 = blkLast - (posY0 << log2w);
  tot = lastSigBits(posX0, posY0, w, h, isChroma, scanType, lastX, lastY,
                    tot);

  int firstSigCtx;
  if (w == 4 && h == 4) firstSigCtx = kSigSetStart[ch][0];
  else if (w == 8 && h == 8) {
    firstSigCtx = kSigSetStart[ch][1];
    if (scanType != 0) firstSigCtx += kNonDiag8x8Offset[ch];
  } else {
    firstSigCtx = kSigSetStart[ch][2];
  }
  const int sigBase = isChroma ? 28 : 0;

  const int lastScanSet = scanPosLast >> 4;
  int sigCg[64] = {0};
  for (int s = 0; s <= lastScanSet; s++) {
    int any = 0;
    for (int k = 0; k < 16; k++)
      if (coeffs[scan[s * 16 + k]]) { any = 1; break; }
    sigCg[cgy_[s] * wg + cgx_[s]] = any;
  }
  sigCg[cgy_[0] * wg + cgx_[0]] = 1;
  sigCg[cgy_[lastScanSet] * wg + cgx_[lastScanSet]] = 1;

  int scanPos = scanPosLast;
  int c1 = 1;
  for (int subset = lastScanSet; subset >= 0; subset--) {
    const int subPos = subset << 4;
    int goRice = 0;
    const int cgx = cgx_[subset], cgy = cgy_[subset];
    const int cgBlk = cgy * wg + cgx;
    int numNz = 0;
    int posList[16];
    if (scanPos == scanPosLast) {
      posList[numNz++] = blkLast;
      scanPos--;
    }
    if (subset != lastScanSet && subset != 0) {
      const int right = cgx < wg - 1 ? sigCg[cgBlk + 1] : 0;
      const int below = cgy < hg - 1 ? sigCg[cgBlk + wg] : 0;
      const int ctx = (right || below) ? 1 : 0;
      tot += ctxBitsAdapt(sigCgCtx, 2 * ch + ctx, sigCg[cgBlk]);
    }
    int pattern;
    if (wg <= 1 && hg <= 1) pattern = 0;
    else {
      const int right = cgx < wg - 1 ? sigCg[cgBlk + 1] : 0;
      const int below = cgy < hg - 1 ? sigCg[cgBlk + wg] : 0;
      pattern = right + (below << 1);
    }
    while (scanPos >= subPos) {
      const int blk = scan[scanPos];
      const int sigv = coeffs[blk] ? 1 : 0;
      if (sigCg[cgBlk]) {
        if (scanPos > subPos || subset == 0 || numNz) {
          const int py = blk >> log2w;
          const int px = blk - (py << log2w);
          int ctx;
          if (px + py == 0) {
            ctx = 0;
          } else if (w == 4 && h == 4) {
            ctx = firstSigCtx + kCtxIndMap4x4[4 * py + px];
          } else {
            const int xin = px & 3, yin = py & 3;
            int cnt;
            if (pattern == 0) {
              int t = xin + yin;
              cnt = t >= 3 ? 0 : (t >= 1 ? 1 : 2);
            } else if (pattern == 1) {
              cnt = yin >= 2 ? 0 : (yin >= 1 ? 1 : 2);
            } else if (pattern == 2) {
              cnt = xin >= 2 ? 0 : (xin >= 1 ? 1 : 2);
            } else {
              cnt = 2;
            }
            const int notFirst = ((px >> 2) + (py >> 2)) > 0;
            ctx = firstSigCtx + cnt + (notFirst ? kNotFirstGroupOffset[ch] : 0);
          }
          tot += ctxBitsAdapt(sig, sigBase + ctx, sigv);
        }
      }
      if (sigv) posList[numNz++] = blk;
      scanPos--;
    }
    if (numNz == 0) continue;
    int ctxSet;
    if (isChroma) ctxSet = 4 + (c1 == 0 ? 1 : 0);
    else ctxSet = (subset > 0 ? 2 : 0) + (c1 == 0 ? 1 : 0);
    c1 = 1;
    const int baseGt1 = 4 * ctxSet;
    long long absVals[16];
    for (int i = 0; i < numNz; i++) {
      long long v = coeffs[posList[i]];
      absVals[i] = v < 0 ? -v : v;
    }
    const int numC1 = numNz < kC1FlagNumber ? numNz : kC1FlagNumber;
    int firstC2 = -1;
    for (int idx = 0; idx < numC1; idx++) {
      const int b = absVals[idx] > 1 ? 1 : 0;
      tot += ctxBitsAdapt(gt1, baseGt1 + c1, b);
      if (b) {
        c1 = 0;
        if (firstC2 == -1) firstC2 = idx;
      } else if (c1 > 0 && c1 < 3) {
        c1++;
      }
    }
    if (c1 == 0 && firstC2 != -1)
      tot += ctxBitsAdapt(gt2, ctxSet, absVals[firstC2] > 2 ? 1 : 0);
    // signs (bypass; lowest-scan sign hidden when the spread allows)
    int hide = 0;
    if (signHiding) {
      int first = -1, last = -1;
      const int end = subPos + 16 < n2 ? subPos + 16 : n2;
      for (int sp = subPos; sp < end; sp++)
        if (coeffs[scan[sp]]) {
          if (first < 0) first = sp;
          last = sp;
        }
      hide = (last - first) >= 4 ? 1 : 0;
    }
    {
      const int nSigns = hide ? numNz - 1 : numNz;
      for (int i = 0; i < nSigns; i++) tot += kFrac;  // one op per sign
    }
    // remaining levels
    int firstCoeff2 = 1;
    for (int idx = 0; idx < numNz; idx++) {
      const long long baseLevel =
          idx < kC1FlagNumber ? (2 + firstCoeff2) : 1;
      if (absVals[idx] >= baseLevel) {
        tot = coefRemainBits(absVals[idx] - baseLevel, goRice, tot);
        if (absVals[idx] > (3LL << goRice))
          goRice = goRice + 1 < 4 ? goRice + 1 : 4;
      }
      if (absVals[idx] >= 2) firstCoeff2 = 0;
    }
  }
  return tot;
}

}  // namespace rdoq
}  // namespace hevc

extern "C" double enc_residual_bits(
    const int32_t* coeffs, int w, int h, int comp, int scan_type,
    int sign_hiding, int ts_flag, const int32_t* sig, const int32_t* sig_cg,
    const int32_t* gt1, const int32_t* gt2, const int32_t* last_x,
    const int32_t* last_y, const int32_t* ts_ctx, double start) {
  return hevc::rdoq::residualBits(coeffs, w, h, comp, scan_type, sign_hiding,
                                  ts_flag, sig, sig_cg, gt1, gt2, last_x,
                                  last_y, ts_ctx, start);
}

extern "C" void enc_rdoq(const int32_t* coef, int qp, int log2_size,
                         int bit_depth, int comp, int scan_type,
                         const int32_t* sig, const int32_t* sig_cg,
                         const int32_t* gt1, const int32_t* gt2,
                         const int32_t* last_x, const int32_t* last_y,
                         double lam, int max_dyn_range, int32_t* out) {
  hevc::rdoq::run(coef, qp, log2_size, bit_depth, comp, scan_type, sig,
                  sig_cg, gt1, gt2, last_x, last_y, lam, max_dyn_range, out);
}

// ===========================================================================
// Whole-TU forward path: transform + (RDOQ | xQuant) + sign-data-hiding
// fix-up + dequant + inverse transform (+ 4x4 transform-skip trial), the
// native mirror of encoder.py _tu_fwd for the common configuration
// (no lossless, no scaling lists, 15-bit dynamic range).  Reference chain:
// TComTrQuant::transformNxN / xQuant / signBitHidingHDQ / invTransformNxN.
namespace hevc {
namespace tufwd {

static const int kQuantScalesF[6] = {26214, 23302, 20560, 18396, 16384, 14564};

static inline int32_t clip16i(long long v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : int32_t(v));
}

// one output row of an n-point stage: out[c] = clip16((Σ_j w[j]*rows_j[c]
// + rnd) >> shift), where rows_j are n contiguous int32 rows.  All
// accumulators fit int32 (|M| <= 90, operands clip16 => |acc| <=
// 32*90*32768 < 2^31), so the vector math is exact.
static inline void stageRow(const int32_t* base, int n, const int32_t* w,
                            int rnd, int shift, int32_t* out) {
#if defined(__AVX2__)
  if (n >= 8) {
    __m256i vr = _mm256_set1_epi32(rnd);
    __m256i vmin = _mm256_set1_epi32(-32768), vmax = _mm256_set1_epi32(32767);
    for (int c = 0; c < n; c += 8) {
      __m256i acc = _mm256_setzero_si256();
      for (int j = 0; j < n; j++) {
        __m256i row = _mm256_loadu_si256((const __m256i*)(base + j * n + c));
        acc = _mm256_add_epi32(
            acc, _mm256_mullo_epi32(_mm256_set1_epi32(w[j]), row));
      }
      __m256i v = _mm256_srai_epi32(_mm256_add_epi32(acc, vr), shift);
      v = _mm256_min_epi32(vmax, _mm256_max_epi32(vmin, v));
      _mm256_storeu_si256((__m256i*)(out + c), v);
    }
    return;
  }
  if (n == 4) {
    __m128i acc = _mm_setzero_si128();
    for (int j = 0; j < 4; j++) {
      __m128i row = _mm_loadu_si128((const __m128i*)(base + j * 4));
      acc = _mm_add_epi32(acc, _mm_mullo_epi32(_mm_set1_epi32(w[j]), row));
    }
    __m128i v = _mm_srai_epi32(_mm_add_epi32(acc, _mm_set1_epi32(rnd)),
                               shift);
    v = _mm_min_epi32(_mm_set1_epi32(32767),
                      _mm_max_epi32(_mm_set1_epi32(-32768), v));
    _mm_storeu_si128((__m128i*)out, v);
    return;
  }
#endif
  for (int c = 0; c < n; c++) {
    long long acc = 0;
    for (int j = 0; j < n; j++) acc += (long long)w[j] * base[j * n + c];
    out[c] = clip16i((acc + rnd) >> shift);
  }
}

// transposed transform matrices (for the stages that index M by column)
static const int32_t* mTransposed(const int32_t* M, int n) {
  static thread_local int32_t t4[16], t8[64], t16[256], t32[1024], td4[16];
  static thread_local const int32_t* last[5] = {};
  int32_t* buf = n == 4 ? (M == kT.dst4 ? td4 : t4)
                        : (n == 8 ? t8 : (n == 16 ? t16 : t32));
  int slot = n == 4 ? (M == kT.dst4 ? 4 : 0) : (n == 8 ? 1 : (n == 16 ? 2 : 3));
  if (last[slot] != M) {
    for (int r = 0; r < n; r++)
      for (int j = 0; j < n; j++) buf[j * n + r] = M[r * n + j];
    last[slot] = M;
  }
  return buf;
}

static void fwdTransform(const int32_t* resi, int n, bool useDst, int bd,
                         int32_t* coef) {
  int lg = 0;
  while ((1 << lg) < n) lg++;
  const int32_t* M = (useDst && n == 4) ? kT.dst4 : kT.dct[lg].data();
  const int s1 = lg + bd - 9, s2 = lg + 6;
  const int r1 = 1 << (s1 - 1), r2 = 1 << (s2 - 1);
  static thread_local int32_t tmp[32 * 32];
  // stage 1: tmp[k,:] = rows of resi weighted by M[k,:]
  for (int k = 0; k < n; k++)
    stageRow(resi, n, M + k * n, r1, s1, tmp + k * n);
  // stage 2: coef[k,r] = Σ_j tmp[k,j] * M[r,j] — vector over r via M^T
  const int32_t* Mt = mTransposed(M, n);
  for (int k = 0; k < n; k++)
    stageRow(Mt, n, tmp + k * n, r2, s2, coef + k * n);
}

static void invTransform(const int32_t* coef, int n, bool useDst, int bd,
                         int32_t* rec) {
  int lg = 0;
  while ((1 << lg) < n) lg++;
  const int32_t* M = (useDst && n == 4) ? kT.dst4 : kT.dct[lg].data();
  const int s1 = 7, s2 = 20 - bd;
  const int r1 = 1 << (s1 - 1), r2 = 1 << (s2 - 1);
  static thread_local int32_t t1[32 * 32];
  // stage 1: t1[i,c] = Σ_j M[j,i] * coef[j,c] — weights are M^T rows
  const int32_t* Mt = mTransposed(M, n);
  for (int i = 0; i < n; i++)
    stageRow(coef, n, Mt + i * n, r1, s1, t1 + i * n);
  // stage 2: rec[i,r] = Σ_j t1[i,j] * M[j,r] — vector over r via M rows
  for (int i = 0; i < n; i++)
    stageRow(M, n, t1 + i * n, r2, s2, rec + i * n);
}

static void dequantFlat(const int32_t* lev, int n, int qp, int bd,
                        int32_t* out) {
  int lg = 0;
  while ((1 << lg) < n) lg++;
  const int per = qp / 6, rem = qp % 6;
  const int tshift = 15 - bd - lg;
  const long long tmin = -(1LL << 15), tmax = (1LL << 15) - 1;
  const int scale = kInvQuantScales[rem];
  const int right = 6 - (tshift + per);
  const int targetBits = std::min(16, 32 + right - 7);
  const long long lo = -(1LL << (targetBits - 1));
  const long long hi = (1LL << (targetBits - 1)) - 1;
  for (int i = 0; i < n * n; i++) {
    long long c = lev[i];
    c = c < lo ? lo : (c > hi ? hi : c);
    long long q = right > 0 ? ((c * scale + (1LL << (right - 1))) >> right)
                            : ((c * scale) << (-right));
    out[i] = int32_t(q < tmin ? tmin : (q > tmax ? tmax : q));
  }
}

// scaling-list dequant (refimpl.dequant scaling branch: dequantCoef =
// listCoef * invQuantScale[rem], right += LOG2_SCALING_LIST_NEUTRAL (4),
// clip budget 32 + right - 15)
static void dequantScaled(const int32_t* lev, int n, int qp, int bd,
                          const int32_t* mat, int32_t* out) {
  int lg = 0;
  while ((1 << lg) < n) lg++;
  const int per = qp / 6, rem = qp % 6;
  const int tshift = 15 - bd - lg;
  const long long tmin = -(1LL << 15), tmax = (1LL << 15) - 1;
  const int scale = kInvQuantScales[rem];
  const int right = 6 - (tshift + per) + 4;
  const int targetBits = std::min(16, 32 + right - 15);
  const long long lo = -(1LL << (targetBits - 1));
  const long long hi = (1LL << (targetBits - 1)) - 1;
  for (int i = 0; i < n * n; i++) {
    long long c = lev[i];
    c = c < lo ? lo : (c > hi ? hi : c);
    long long dq = (long long)mat[i] * scale;
    long long q = right > 0 ? ((c * dq + (1LL << (right - 1))) >> right)
                            : ((c * dq) << (-right));
    out[i] = int32_t(q < tmin ? tmin : (q > tmax ? tmax : q));
  }
}

static void quantPlain(const int32_t* coef, int n, int qp, int bd,
                       bool isIntra, int32_t* lev) {
  int lg = 0;
  while ((1 << lg) < n) lg++;
  const int per = qp / 6, rem = qp % 6;
  const int tshift = 15 - bd - lg;
  const int qbits = 14 + per + tshift;
  const int scale = kQuantScalesF[rem];
  const long long offset = (long long)(isIntra ? 171 : 85) << (qbits - 9);
  for (int i = 0; i < n * n; i++) {
    long long c = coef[i];
    long long a = c < 0 ? -c : c;
    long long l = (a * scale + offset) >> qbits;
    if (l > 32767) l = 32767;
    lev[i] = int32_t(c < 0 ? -l : l);
  }
}

// parity fix-up for sign-data-hiding (residual_enc.apply_sign_hiding /
// reference TComTrQuant::signBitHidingHDQ)
static void sdhFix(int32_t* lev, const int32_t* coef, int n, int qp, int bd,
                   int scanType) {
  int lg = 0;
  while ((1 << lg) < n) lg++;
  const int per = qp / 6, rem = qp % 6;
  const int qbits = 14 + per + (15 - bd - lg);
  const int scale = kQuantScalesF[rem];
  const int wg = n >> 2;
  int cgx[64], cgy[64], inx[16], iny[16];
  rdoq::scanOrder(wg, wg, scanType, cgx, cgy);
  rdoq::scanOrder(4, 4, scanType, inx, iny);
  // last CG (in CG scan order) containing a nonzero: adjustments there
  // must not move the last-significant position
  int lastSub = -1;
  for (int g = 0; g < wg * wg; g++)
    for (int k = 0; k < 16; k++) {
      int idx = (cgy[g] * 4 + iny[k]) * n + cgx[g] * 4 + inx[k];
      if (lev[idx]) lastSub = g;
    }
  for (int g = 0; g < wg * wg; g++) {
    int idxs[16];
    for (int k = 0; k < 16; k++)
      idxs[k] = (cgy[g] * 4 + iny[k]) * n + cgx[g] * 4 + inx[k];
    int first = -1, last = -1;
    long long absSum = 0;
    for (int k = 0; k < 16; k++) {
      int l = lev[idxs[k]];
      if (l) {
        if (first < 0) first = k;
        last = k;
        absSum += l < 0 ? -l : l;
      }
    }
    if (first < 0 || last - first < 4 /* SBH_THRESHOLD */) continue;
    int signbit = lev[idxs[first]] < 0 ? 1 : 0;
    if (signbit == (absSum & 1)) continue;
    // RD-optimal +-1 adjustment by signed deltaU rounding-error cost
    // (reference xSignBitHidingHDQ): incrementing an under-quantized
    // coefficient GAINS quality, so curCost can be negative; zeros may
    // be promoted (below the first nonzero only when the source sign
    // matches the hidden sign); in the last coded CG never beyond the
    // last position.
    long long minCost = 0;
    int minPos = -1, finalChange = 0;
    bool have = false;
    int top = (g == lastSub) ? last : 15;
    for (int j = top; j >= 0; j--) {
      int blk = idxs[j];
      int l = lev[blk];
      long long c = coef[blk];
      long long al = l < 0 ? -l : l;
      long long du = (((c < 0 ? -c : c) * (long long)scale) -
                      (al << qbits)) >> (qbits - 8);
      long long curCost;
      int curChange;
      if (l != 0) {
        if (du > 0) {
          curCost = -du; curChange = 1;
        } else if (j == first && al == 1) {
          continue;   // never zero the hidden-sign coefficient
        } else {
          curCost = du; curChange = -1;
        }
      } else {
        if (j < first) {
          int srcSign = c >= 0 ? 0 : 1;
          if (srcSign != signbit) continue;
        }
        curCost = -du; curChange = 1;
      }
      if (!have || curCost < minCost) {
        have = true;
        minCost = curCost;
        minPos = blk;
        finalChange = curChange;
      }
    }
    if (minPos < 0) continue;
    int l = lev[minPos];
    if (l == 32767 || l == -32768) finalChange = -1;
    if (coef[minPos] >= 0) lev[minPos] = l + finalChange;
    else lev[minPos] = l - finalChange;
  }
}

// _rough_level_bits: cheap residual bit proxy for the TS-vs-DCT trial
static double roughLevelBits(const int32_t* lev, int n) {
  double bits = 0.0;
  int nnz = 0;
  bool cg[64] = {false};
  const int wg = n >> 2;
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) {
      int a = lev[y * n + x];
      if (a < 0) a = -a;
      if (!a) continue;
      nnz++;
      cg[(y >> 2) * wg + (x >> 2)] = true;
      bits += 2.0 * std::ceil(std::log2((double)a + 1.0));
    }
  if (!nnz) return 0.0;
  int ncg = 0;
  for (int i = 0; i < 64; i++) ncg += cg[i] ? 1 : 0;
  return bits + 1.5 * nnz + 2.0 * ncg + 8.0;
}

static bool anyNz(const int32_t* v, int n2) {
  for (int i = 0; i < n2; i++)
    if (v[i]) return true;
  return false;
}

}  // namespace tufwd
}  // namespace hevc

// Returns (cbf) | ((ts_flag + 1) << 1) where ts_flag is -1 when the block
// carries no transform_skip decision.
extern "C" int enc_tu_fwd(const int32_t* resi, int n, int use_dst, int comp,
                          int qp, int bit_depth, int is_intra, int scan_type,
                          int rdoq_on, double rdoq_lam, int sdh_on,
                          int ts_enabled, double ts_lam,
                          const int32_t* sig, const int32_t* sig_cg,
                          const int32_t* gt1, const int32_t* gt2,
                          const int32_t* last_x, const int32_t* last_y,
                          int32_t* lev_out, int32_t* rec_out,
                          const int32_t* deq_mat) {
  using namespace hevc;
  using namespace hevc::tufwd;
  const int n2 = n * n;
  int lg = 0;
  while ((1 << lg) < n) lg++;
  static thread_local int32_t coef[32 * 32], deq[32 * 32];

  fwdTransform(resi, n, use_dst != 0, bit_depth, coef);
  if (deq_mat) {
    // fold the scaling list into the forward quantiser (encoder.py
    // _tu_fwd: sign(coef) * ((|coef| * 16) // mat); reference
    // xSetScalingListEnc quantCoef = scale*16/list)
    for (int i = 0; i < n2; i++) {
      long long a = coef[i] < 0 ? -(long long)coef[i] : coef[i];
      long long v = (a * 16) / deq_mat[i];
      coef[i] = int32_t(coef[i] < 0 ? -v : v);
    }
  }
  if (rdoq_on)
    rdoq::run(coef, qp, lg, bit_depth, comp, scan_type, sig, sig_cg, gt1,
              gt2, last_x, last_y, rdoq_lam, 15, lev_out);
  else
    quantPlain(coef, n, qp, bit_depth, is_intra != 0, lev_out);
  if (sdh_on && anyNz(lev_out, n2)) sdhFix(lev_out, coef, n, qp, bit_depth,
                                           scan_type);
  int cbf = anyNz(lev_out, n2) ? 1 : 0;
  if (cbf) {
    if (deq_mat) dequantScaled(lev_out, n, qp, bit_depth, deq_mat, deq);
    else dequantFlat(lev_out, n, qp, bit_depth, deq);
    invTransform(deq, n, use_dst != 0, bit_depth, rec_out);
  } else {
    for (int i = 0; i < n2; i++) rec_out[i] = 0;
  }
  int tsFlag = -1;
  if (ts_enabled && n == 4) {
    const int tshift = 15 - bit_depth - lg;
    static thread_local int32_t coefTs[16], levTs[16], recTs[16];
    for (int i = 0; i < n2; i++)
      coefTs[i] = tshift >= 0 ? (resi[i] << tshift) : (resi[i] >> -tshift);
    if (rdoq_on)
      rdoq::run(coefTs, qp, lg, bit_depth, comp, scan_type, sig, sig_cg,
                gt1, gt2, last_x, last_y, rdoq_lam, 15, levTs);
    else
      quantPlain(coefTs, n, qp, bit_depth, is_intra != 0, levTs);
    if (sdh_on && anyNz(levTs, n2)) sdhFix(levTs, coefTs, n, qp, bit_depth,
                                           scan_type);
    if (anyNz(levTs, n2)) {
      if (deq_mat) dequantScaled(levTs, n, qp, bit_depth, deq_mat, deq);
      else dequantFlat(levTs, n, qp, bit_depth, deq);
      for (int i = 0; i < n2; i++) {
        long long c = deq[i];
        long long r = tshift >= 0
            ? ((c + (tshift == 0 ? 0 : (1LL << (tshift - 1)))) >> tshift)
            : (c << -tshift);
        recTs[i] = clip16i(r);
      }
    } else {
      for (int i = 0; i < n2; i++) recTs[i] = 0;
    }
    double costD = 0, costT = 0;
    for (int i = 0; i < n2; i++) {
      double dd = (double)(resi[i] - rec_out[i]);
      double dt = (double)(resi[i] - recTs[i]);
      costD += dd * dd;
      costT += dt * dt;
    }
    costD += ts_lam * roughLevelBits(lev_out, n);
    costT += ts_lam * roughLevelBits(levTs, n);
    tsFlag = costT < costD ? 1 : 0;
    if (tsFlag) {
      for (int i = 0; i < n2; i++) {
        lev_out[i] = levTs[i];
        rec_out[i] = recTs[i];
      }
      cbf = anyNz(lev_out, n2) ? 1 : 0;
    }
  }
  return cbf | ((tsFlag + 1) << 1);
}
