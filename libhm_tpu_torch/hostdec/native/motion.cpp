// Copied from libhm_tpu/hostdec/native/motion.cpp
// Merge / AMVP / TMVP derivation (translation of hostdec/motion.py).
// Compiled as part of api.cpp (single translation unit, after sliceparse.cpp).
#include "hevcdec.h"

namespace hevc {

bool SliceParser::tmvp(int x, int y, int w, int h, int targetList,
                       int targetRefIdx, int out[2]) {
  if (!colPic) return false;
  Picture* cp = colPic;
  // lost-reference fallback can hand out a retired picture whose motion
  // maps a lowmem decode already freed: no TMVP candidate then
  if (cp->pred_mode.empty()) return false;
  int candPos[2][2];
  int nCand = 0;
  int brX = x + w, brY = y + h;
  if ((brY >> log2Ctb) == (y >> log2Ctb) && brY < H && brX < W) {
    candPos[nCand][0] = (brX >> 4) << 4;
    candPos[nCand][1] = (brY >> 4) << 4;
    nCand++;
  }
  candPos[nCand][0] = ((x + (w >> 1)) >> 4) << 4;
  candPos[nCand][1] = ((y + (h >> 1)) >> 4) << 4;
  nCand++;
  int tgtPoc = refList[targetList][targetRefIdx].poc;
  bool tgtLt = refList[targetList][targetRefIdx].long_term;
  for (int k = 0; k < nCand; k++) {
    int x4 = candPos[k][0] >> 2, y4 = candPos[k][1] >> 2;
    if (x4 >= cp->w4 || y4 >= cp->h4) continue;
    size_t i = size_t(y4) * cp->w4 + x4;
    if (cp->pred_mode[i] != MODE_INTER) continue;
    int cdir = cp->inter_dir[i];
    if (cdir == 0) continue;
    int use;
    if (!(cdir & 1)) use = 1;
    else if (!(cdir & 2)) use = 0;
    else use = allRefsBefore ? targetList : sh->collocated_from_l0;
    int colMv[2] = {cp->mv[i * 4 + use * 2], cp->mv[i * 4 + use * 2 + 1]};
    int colRefPoc = cp->ref_poc[i * 2 + use];
    bool colRefLt = cp->ref_is_lt[i * 2 + use] != 0;
    if (colRefLt != tgtLt) continue;
    if (tgtLt) { out[0] = colMv[0]; out[1] = colMv[1]; return true; }
    int tb = poc - tgtPoc;
    int td = colPoc - colRefPoc;
    if (td == 0) { out[0] = colMv[0]; out[1] = colMv[1]; return true; }
    mvScale(colMv, tb, td, out);
    return true;
  }
  return false;
}

MergeCand SliceParser::mergeCandidate(int x, int y, int w, int h, int cx, int cy,
                                      int cuSize, int puIdx, int partSize,
                                      int mergeIdx) {
  int plevel = pps->log2_parallel_merge_level;
  if (plevel > 2 && cuSize == 8) {
    x = cx; y = cy; w = cuSize; h = cuSize;
    puIdx = 0;
    partSize = SZ_2Nx2N;
  }
  auto parOk = [&](int nx, int ny) {
    return (x >> plevel != nx >> plevel) || (y >> plevel != ny >> plevel);
  };
  auto toCand = [](const Blk& b) {
    MergeCand c;
    c.dir = b.dir;
    for (int l = 0; l < 2; l++) {
      c.mv[l][0] = b.mv[l][0]; c.mv[l][1] = b.mv[l][1];
      c.ref_idx[l] = b.ref_idx[l];
    }
    return c;
  };
  MergeCand cands[5];
  int n = 0;
  int maxCand = sh->max_num_merge_cand;

  Blk a1, b1;
  bool haveA1 = false, haveB1 = false;
  if (!(puIdx == 1 && (partSize == SZ_Nx2N || partSize == SZ_nLx2N || partSize == SZ_nRx2N))) {
    int nx = x - 1, ny = y + h - 1;
    if (parOk(nx, ny)) { a1 = blk(nx, ny, x, y, false); haveA1 = a1.ok; }
  }
  MergeCand cA1, cB1;
  if (haveA1) { cA1 = toCand(a1); cands[n++] = cA1; }
  if (!(puIdx == 1 && (partSize == SZ_2NxN || partSize == SZ_2NxnU || partSize == SZ_2NxnD))) {
    int nx = x + w - 1, ny = y - 1;
    if (parOk(nx, ny)) { b1 = blk(nx, ny, x, y, false); haveB1 = b1.ok; }
  }
  if (haveB1) {
    cB1 = toCand(b1);
    if (!(haveA1 && cB1.sameMotion(cA1)) && n < 5) cands[n++] = cB1;
  }
  {
    int nx = x + w, ny = y - 1;
    if (parOk(nx, ny)) {
      Blk b0 = blk(nx, ny, x, y);
      if (b0.ok) {
        MergeCand c = toCand(b0);
        if (!(haveB1 && c.sameMotion(cB1)) && n < 5) cands[n++] = c;
      }
    }
  }
  {
    int nx = x - 1, ny = y + h;
    if (parOk(nx, ny)) {
      Blk a0 = blk(nx, ny, x, y);
      if (a0.ok) {
        MergeCand c = toCand(a0);
        if (!(haveA1 && c.sameMotion(cA1)) && n < 5) cands[n++] = c;
      }
    }
  }
  if (n < 4) {
    int nx = x - 1, ny = y - 1;
    if (parOk(nx, ny)) {
      Blk b2 = blk(nx, ny, x, y);
      if (b2.ok) {
        MergeCand c = toCand(b2);
        if (!(haveA1 && c.sameMotion(cA1)) && !(haveB1 && c.sameMotion(cB1)) && n < 5)
          cands[n++] = c;
      }
    }
  }
  if (sh->temporal_mvp && n < maxCand && colPic) {
    MergeCand c;
    int mv0[2];
    if (tmvp(x, y, w, h, 0, 0, mv0)) {
      c.dir |= 1;
      c.mv[0][0] = mv0[0]; c.mv[0][1] = mv0[1];
      c.ref_idx[0] = 0;
    }
    if (sh->slice_type == 0) {
      int mv1[2];
      if (tmvp(x, y, w, h, 1, 0, mv1)) {
        c.dir |= 2;
        c.mv[1][0] = mv1[0]; c.mv[1][1] = mv1[1];
        c.ref_idx[1] = 0;
      }
    }
    if (c.dir) cands[n++] = c;
  }
  if (sh->slice_type == 0 && n > 1 && n < maxCand) {
    static const int pairs[12][2] = {{0, 1}, {1, 0}, {0, 2}, {2, 0}, {1, 2}, {2, 1},
                                     {0, 3}, {3, 0}, {1, 3}, {3, 1}, {2, 3}, {3, 2}};
    int norig = n;
    for (auto& pr : pairs) {
      if (n >= maxCand) break;
      if (pr[0] >= norig || pr[1] >= norig) break;
      const MergeCand& ci = cands[pr[0]];
      const MergeCand& cj = cands[pr[1]];
      if (!(ci.dir & 1) || !(cj.dir & 2)) continue;
      if (refList[0][ci.ref_idx[0]].poc == refList[1][cj.ref_idx[1]].poc &&
          ci.mv[0][0] == cj.mv[1][0] && ci.mv[0][1] == cj.mv[1][1]) continue;
      MergeCand c;
      c.dir = 3;
      c.mv[0][0] = ci.mv[0][0]; c.mv[0][1] = ci.mv[0][1];
      c.mv[1][0] = cj.mv[1][0]; c.mv[1][1] = cj.mv[1][1];
      c.ref_idx[0] = ci.ref_idx[0];
      c.ref_idx[1] = cj.ref_idx[1];
      cands[n++] = c;
    }
  }
  int nref = sh->slice_type == 0 ? std::min(sh->num_ref_idx[0], sh->num_ref_idx[1])
                                 : sh->num_ref_idx[0];
  int zeroIdx = 0;
  while (n < maxCand) {
    int r = zeroIdx < nref ? zeroIdx : 0;
    MergeCand c;
    if (sh->slice_type == 0) { c.dir = 3; c.ref_idx[0] = r; c.ref_idx[1] = r; }
    else { c.dir = 1; c.ref_idx[0] = r; c.ref_idx[1] = -1; }
    c.mv[0][0] = c.mv[0][1] = c.mv[1][0] = c.mv[1][1] = 0;
    cands[n++] = c;
    zeroIdx++;
  }
  return cands[mergeIdx];
}

void SliceParser::amvpCandidates(int x, int y, int w, int h, int targetList,
                                 int targetRefIdx, int out[2][2]) {
  int tgtPoc = refList[targetList][targetRefIdx].poc;
  bool tgtLt = refList[targetList][targetRefIdx].long_term;
  Blk a0 = blk(x - 1, y + h, x, y);
  Blk a1 = blk(x - 1, y + h - 1, x, y, false);
  bool isScaled = a0.ok || a1.ok;

  auto matchUnscaled = [&](const Blk& b, int mv[2]) {
    if (!b.ok) return false;
    int order[2] = {targetList, 1 - targetList};
    for (int li = 0; li < 2; li++) {
      int l = order[li];
      if ((b.dir & (1 << l)) && b.ref_poc[l] == tgtPoc && (b.ref_lt[l] != 0) == tgtLt) {
        mv[0] = b.mv[l][0]; mv[1] = b.mv[l][1];
        return true;
      }
    }
    return false;
  };
  auto matchScaled = [&](const Blk& b, int mv[2]) {
    if (!b.ok) return false;
    int order[2] = {targetList, 1 - targetList};
    for (int li = 0; li < 2; li++) {
      int l = order[li];
      if ((b.dir & (1 << l)) && (b.ref_lt[l] != 0) == tgtLt) {
        if (tgtLt) { mv[0] = b.mv[l][0]; mv[1] = b.mv[l][1]; }
        else mvScale(b.mv[l], poc - tgtPoc, poc - b.ref_poc[l], mv);
        return true;
      }
    }
    return false;
  };

  int mvA[2];
  bool haveA = matchUnscaled(a0, mvA) || matchUnscaled(a1, mvA);
  if (!haveA) haveA = matchScaled(a0, mvA) || matchScaled(a1, mvA);

  Blk b0 = blk(x + w, y - 1, x, y);
  Blk b1 = blk(x + w - 1, y - 1, x, y, false);
  Blk b2 = blk(x - 1, y - 1, x, y);
  int mvB[2];
  bool haveB = matchUnscaled(b0, mvB) || matchUnscaled(b1, mvB) || matchUnscaled(b2, mvB);
  if (!isScaled) {
    if (!haveA && haveB) { mvA[0] = mvB[0]; mvA[1] = mvB[1]; haveA = true; }
    haveB = matchScaled(b0, mvB) || matchScaled(b1, mvB) || matchScaled(b2, mvB);
  }
  int nc = 0;
  int cands[3][2];
  if (haveA) { cands[nc][0] = mvA[0]; cands[nc][1] = mvA[1]; nc++; }
  if (haveB && !(haveA && mvB[0] == mvA[0] && mvB[1] == mvA[1])) {
    cands[nc][0] = mvB[0]; cands[nc][1] = mvB[1]; nc++;
  }
  if (nc < 2 && sh->temporal_mvp && colPic) {
    int tmv[2];
    if (tmvp(x, y, w, h, targetList, targetRefIdx, tmv)) {
      cands[nc][0] = tmv[0]; cands[nc][1] = tmv[1]; nc++;
    }
  }
  while (nc < 2) { cands[nc][0] = 0; cands[nc][1] = 0; nc++; }
  out[0][0] = cands[0][0]; out[0][1] = cands[0][1];
  out[1][0] = cands[1][0]; out[1][1] = cands[1][1];
}

void SliceParser::applyMerge(int x, int y, int w, int h, int mergeIdx, int cx,
                             int cy, int cuSize, int puIdx) {
  int partSize = map8(pic->part_size, cx, cy);
  MergeCand c = mergeCandidate(x, y, w, h, cx, cy, cuSize, puIdx, partSize, mergeIdx);
  int dir = c.dir;
  if (sh->num_ref_idx[1] == 0) dir &= 1;
  if (w + h == 12 && dir == 3) {
    dir = 1;
    c.ref_idx[1] = -1;
    c.mv[1][0] = c.mv[1][1] = 0;
  }
  writePu(x, y, w, h, dir, c.mv, c.ref_idx, 1, mergeIdx);
}

void SliceParser::applyAmvp(int x, int y, int w, int h, int interDir,
                            const int refIdx[2], const int mvd[2][2],
                            const int mvpIdx[2]) {
  int mvs[2][2] = {{0, 0}, {0, 0}};
  for (int l = 0; l < 2; l++) {
    if (interDir & (1 << l)) {
      int cands[2][2];
      amvpCandidates(x, y, w, h, l, refIdx[l], cands);
      mvs[l][0] = cands[mvpIdx[l]][0] + mvd[l][0];
      mvs[l][1] = cands[mvpIdx[l]][1] + mvd[l][1];
    }
  }
  writePu(x, y, w, h, interDir, mvs, refIdx, 0, -1);
}

void SliceParser::writePu(int x, int y, int w, int h, int dir,
                          const int mvs[2][2], const int refIdx[2],
                          int merge, int mergeIdx) {
  // hoist the per-cell values, then fill row-wise with wide stores (this is
  // one of the hottest parse loops on big inter pictures)
  int32_t mvCell[4] = {0, 0, 0, 0};
  int32_t pocCell[2] = {0, 0};
  uint8_t riCell[2], ltCell[2] = {0, 0};
  for (int l = 0; l < 2; l++) {
    if (dir & (1 << l)) {
      mvCell[l * 2] = mvs[l][0];
      mvCell[l * 2 + 1] = mvs[l][1];
      riCell[l] = uint8_t(int8_t(refIdx[l]));
      pocCell[l] = refList[l][refIdx[l]].poc;
      ltCell[l] = refList[l][refIdx[l]].long_term ? 1 : 0;
    } else {
      riCell[l] = uint8_t(int8_t(-1));
    }
  }
  int x0 = x >> 2, x1 = (x + w) >> 2, y0 = y >> 2, y1 = (y + h) >> 2;
  int nx = x1 - x0;
  uint16_t riPat, ltPat;
  uint64_t pocPat;
  memcpy(&riPat, riCell, 2);
  memcpy(&ltPat, ltCell, 2);
  memcpy(&pocPat, pocCell, 8);
  for (int yy = y0; yy < y1; yy++) {
    size_t i = size_t(yy) * w4() + x0;
    memset(&pic->inter_dir[i], uint8_t(dir), size_t(nx));
    uint16_t* rid = reinterpret_cast<uint16_t*>(&pic->ref_idx[i * 2]);
    uint16_t* ltd = reinterpret_cast<uint16_t*>(&pic->ref_is_lt[i * 2]);
    uint64_t* pod = reinterpret_cast<uint64_t*>(&pic->ref_poc[i * 2]);
    int32_t* mvd = &pic->mv[i * 4];
    for (int k = 0; k < nx; k++) {
      memcpy(&rid[k], &riPat, 2);
      memcpy(&ltd[k], &ltPat, 2);
      memcpy(&pod[k], &pocPat, 8);
      memcpy(&mvd[k * 4], mvCell, 16);
    }
  }
  PuMeta pu;
  memset(&pu, 0, sizeof(pu));
  pu.x = x; pu.y = y; pu.w = w; pu.h = h; pu.dir = dir;
  pu.merge = merge; pu.merge_idx = mergeIdx;
  for (int l = 0; l < 2; l++) {
    pu.mv[l][0] = mvs[l][0]; pu.mv[l][1] = mvs[l][1];
    pu.ref_idx[l] = refIdx[l];
    pu.ref_poc[l] = (dir & (1 << l)) ? refList[l][refIdx[l]].poc : 0;
  }
  pu.has_wp = sh->has_wp;
  if (sh->has_wp) {
    pu.wp_denom_l = sh->wp_log2_denom_luma;
    pu.wp_denom_c = sh->wp_log2_denom_chroma;
    for (int l = 0; l < 2; l++) {
      int ri = refIdx[l] >= 0 ? refIdx[l] : 0;
      for (int c = 0; c < 3; c++) {
        pu.wp_w[l][c] = sh->wp[l][ri][c].w;
        pu.wp_o[l][c] = sh->wp[l][ri][c].o;
      }
    }
  }
  puSink->push_back(pu);
}

}  // namespace hevc
