// Copied from libhm_tpu/hostdec/native/libhmdec.cpp
// libHMDec-compatible C ABI shared library (libhmdec.so).
//
// Replicates the extern "C" surface of the reference fork's raison d'être
// (reference: source/App/libHMDecoder/libHMDecoder.h:111-298, impl
// libHMDecoder.cpp) on top of the native tensor-emitting decoder: create/
// free, push_nal_unit with the same re-push protocol (bNewPicture), output
// bumping (Rec. C.5.2.2), per-picture plane access as short*, and the
// internals API emitting CU/PU/TU-sized rectangles (libHMDecoder.cpp:451-715
// walks the quadtree; here the rectangles are reconstructed from the flat
// 4x4 maps + PU/TU lists).
#include "api.cpp"

#include <algorithm>

// ---------------------------------------------------------------------------
// MD5 (RFC 1321) for the decoded-picture-hash check.  Independent
// implementation (not the reference's libmd5).
namespace md5impl {
struct MD5 {
  uint32_t a = 0x67452301, b = 0xefcdab89, c = 0x98badcfe, d = 0x10325476;
  uint64_t nbytes = 0;
  uint8_t buf[64];

  static uint32_t rotl(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
      0xd76aa478,0xe8c7b756,0x242070db,0xc1bdceee,0xf57c0faf,0x4787c62a,
      0xa8304613,0xfd469501,0x698098d8,0x8b44f7af,0xffff5bb1,0x895cd7be,
      0x6b901122,0xfd987193,0xa679438e,0x49b40821,0xf61e2562,0xc040b340,
      0x265e5a51,0xe9b6c7aa,0xd62f105d,0x02441453,0xd8a1e681,0xe7d3fbc8,
      0x21e1cde6,0xc33707d6,0xf4d50d87,0x455a14ed,0xa9e3e905,0xfcefa3f8,
      0x676f02d9,0x8d2a4c8a,0xfffa3942,0x8771f681,0x6d9d6122,0xfde5380c,
      0xa4beea44,0x4bdecfa9,0xf6bb4b60,0xbebfbc70,0x289b7ec6,0xeaa127fa,
      0xd4ef3085,0x04881d05,0xd9d4d039,0xe6db99e5,0x1fa27cf8,0xc4ac5665,
      0xf4292244,0x432aff97,0xab9423a7,0xfc93a039,0x655b59c3,0x8f0ccc92,
      0xffeff47d,0x85845dd1,0x6fa87e4f,0xfe2ce6e0,0xa3014314,0x4e0811a1,
      0xf7537e82,0xbd3af235,0x2ad7d2bb,0xeb86d391};
    static const int S[64] = {7,12,17,22,7,12,17,22,7,12,17,22,7,12,17,22,
                              5,9,14,20,5,9,14,20,5,9,14,20,5,9,14,20,
                              4,11,16,23,4,11,16,23,4,11,16,23,4,11,16,23,
                              6,10,15,21,6,10,15,21,6,10,15,21,6,10,15,21};
    uint32_t m[16];
    for (int i = 0; i < 16; i++)
      m[i] = uint32_t(p[4*i]) | (uint32_t(p[4*i+1]) << 8) |
             (uint32_t(p[4*i+2]) << 16) | (uint32_t(p[4*i+3]) << 24);
    uint32_t A = a, B = b, C = c, D = d;
    for (int i = 0; i < 64; i++) {
      uint32_t f; int g;
      if (i < 16) { f = (B & C) | (~B & D); g = i; }
      else if (i < 32) { f = (D & B) | (~D & C); g = (5 * i + 1) & 15; }
      else if (i < 48) { f = B ^ C ^ D; g = (3 * i + 5) & 15; }
      else { f = C ^ (B | ~D); g = (7 * i) & 15; }
      uint32_t tmp = D;
      D = C; C = B;
      B = B + rotl(A + f + K[i] + m[g], S[i]);
      A = tmp;
    }
    a += A; b += B; c += C; d += D;
  }

  void update(const uint8_t* p, size_t n) {
    size_t fill = nbytes & 63;
    nbytes += n;
    if (fill) {
      size_t take = std::min(n, 64 - fill);
      memcpy(buf + fill, p, take);
      p += take; n -= take;
      if (fill + take == 64) block(buf);
      else return;
    }
    while (n >= 64) { block(p); p += 64; n -= 64; }
    if (n) memcpy(buf, p, n);
  }

  void final(uint8_t out[16]) {
    uint64_t bits = nbytes * 8;
    const uint8_t one = 0x80, zero = 0;
    update(&one, 1);
    while ((nbytes & 63) != 56) update(&zero, 1);
    uint8_t len[8];
    for (int i = 0; i < 8; i++) len[i] = uint8_t(bits >> (8 * i));
    update(len, 8);  // fills to 64 -> block() runs inside update
    uint32_t h[4] = {a, b, c, d};
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) out[i * 4 + j] = uint8_t(h[i] >> (8 * j));
  }
};
}  // namespace md5impl

// ---------------------------------------------------------------------------
typedef enum {
  LIBHMDEC_OK = 0,
  LIBHMDEC_ERROR,
  LIBHMDEC_ERROR_READ_ERROR
} libHMDec_error;

typedef enum {
  LIBHMDEC_LUMA = 0,
  LIBHMDEC_CHROMA_U,
  LIBHMDEC_CHROMA_V
} libHMDec_ColorComponent;

typedef enum {
  LIBHMDEC_CHROMA_400 = 0,
  LIBHMDEC_CHROMA_420,
  LIBHMDEC_CHROMA_422,
  LIBHMDEC_CHROMA_444,
  LIBHMDEC_CHROMA_UNKNOWN
} libHMDec_ChromaFormat;

typedef struct {
  unsigned short x, y, w, h;
  int value;
  int value2;
} libHMDec_BlockValue;

typedef enum {
  LIBHMDEC_CTU_SLICE_INDEX = 0,
  LIBHMDEC_CU_PREDICTION_MODE,
  LIBHMDEC_CU_TRQ_BYPASS,
  LIBHMDEC_CU_SKIP_FLAG,
  LIBHMDEC_CU_PART_MODE,
  LIBHMDEC_CU_INTRA_MODE_LUMA,
  LIBHMDEC_CU_INTRA_MODE_CHROMA,
  LIBHMDEC_CU_ROOT_CBF,
  LIBHMDEC_PU_MERGE_FLAG,
  LIBHMDEC_PU_MERGE_INDEX,
  LIBHMDEC_PU_UNI_BI_PREDICTION,
  LIBHMDEC_PU_REFERENCE_POC_0,
  LIBHMDEC_PU_MV_0,
  LIBHMDEC_PU_REFERENCE_POC_1,
  LIBHMDEC_PU_MV_1,
  LIBHMDEC_TU_CBF_Y,
  LIBHMDEC_TU_CBF_CB,
  LIBHMDEC_TU_CBF_CR,
  LIBHMDEC_TU_COEFF_TR_SKIP_Y,
  LIBHMDEC_TU_COEFF_TR_SKIP_Cb,
  LIBHMDEC_TU_COEFF_TR_SKIP_Cr,
  LIBHMDEC_TU_COEFF_ENERGY_Y,
  LIBHMDEC_TU_COEFF_ENERGY_CB,
  LIBHMDEC_TU_COEFF_ENERGY_CR,
} libHMDec_info_type;

namespace {

// picture -> SPS registry (the reference signatures take no context for the
// per-picture geometry getters; libHMDecoder reads TComPic-internal state)
std::map<const hevc::Picture*, const hevc::SPS*> g_picSps;
const hevc::SPS* g_lastSps = nullptr;

const hevc::SPS* spsOf(const hevc::Picture* p) {
  auto it = g_picSps.find(p);
  return it == g_picSps.end() ? nullptr : it->second;
}

struct HmDecCtx {
  hevc::Decoder dec;
  bool seiCheck = true;
  int maxTemporalLayer = -1;
  bool eofSeen = false;
  // suffix hash SEI pending for the picture being decoded
  bool havePendingHash = false;
  uint8_t pendingHash[3][16];
  int pendingHashPlanes = 0;
  // per-picture hash verify results: decode-order index -> ok
  std::vector<int> hashStatus;  // -1 unknown, 0 mismatch, 1 ok
  size_t nextOutputScan = 0;
  std::vector<libHMDec_BlockValue> internals;
  int md5Mismatch = 0;
  // pictures of an earlier coded video sequence still to be output: an
  // IRAP picture with NoRaslOutputFlag bumps them all before any of its
  // own sequence (Rec. C.5.2.2)
  std::vector<hevc::Picture*> prior;
  bool newSequence = true;   // at the start and after an end of sequence

  HmDecCtx() { dec.reconEnabled = true; }
};

void noteDpb(HmDecCtx* c) {
  for (auto& q : c->dec.dpb) {
    const hevc::SPS* s = &c->dec.spsMap[q->sps_id];
    g_picSps[q.get()] = s;
    g_lastSps = s;
  }
}

void verifyPendingHash(HmDecCtx* c) {
  // hash the last finished picture against the pending suffix SEI digest
  if (!c->havePendingHash || c->dec.doneOrder.empty()) return;
  c->havePendingHash = false;
  hevc::Picture* p = c->dec.doneOrder.back();
  c->dec.waitReconPic(p);  // pipeline: planes must be complete to hash
  const hevc::SPS& s = c->dec.spsMap[p->sps_id];
  bool ok = true;
  int ncomp = s.chroma_format_idc ? 3 : 1;
  for (int comp = 0; comp < ncomp && comp < c->pendingHashPlanes; comp++) {
    int sx = comp ? s.ssx() : 0, sy = comp ? s.ssy() : 0;
    int w = s.width >> sx, h = s.height >> sy;
    int bd = comp ? s.bit_depth_chroma : s.bit_depth_luma;
    int64_t stride = int64_t(s.picWCtbs() << s.log2_ctb) >> sx;
    md5impl::MD5 m;
    std::vector<uint8_t> row(size_t(w) * (bd > 8 ? 2 : 1));
    for (int y = 0; y < h; y++) {
      const hevc::Pel* r = p->plane[comp].data() + int64_t(y) * stride;
      if (bd > 8) {
        for (int x = 0; x < w; x++) {
          row[2 * x] = uint8_t(r[x]);
          row[2 * x + 1] = uint8_t(uint16_t(r[x]) >> 8);
        }
      } else {
        for (int x = 0; x < w; x++) row[x] = uint8_t(r[x]);
      }
      m.update(row.data(), row.size());
    }
    uint8_t digest[16];
    m.final(digest);
    if (memcmp(digest, c->pendingHash[comp], 16) != 0) ok = false;
  }
  c->hashStatus.resize(c->dec.doneOrder.size(), -1);
  c->hashStatus[c->dec.doneOrder.size() - 1] = ok ? 1 : 0;
  if (!ok) c->md5Mismatch = 1;
}

}  // namespace

extern "C" {

const char* libHMDec_get_version(void) { return "16.0"; }

void* libHMDec_new_decoder(void) { return new HmDecCtx(); }

libHMDec_error libHMDec_free_decoder(void* h) {
  delete static_cast<HmDecCtx*>(h);
  return LIBHMDEC_OK;
}

void libHMDec_set_SEI_Check(void* h, bool check) {
  static_cast<HmDecCtx*>(h)->seiCheck = check;
}

void libHMDec_set_max_temporal_layer(void* h, int max_layer) {
  static_cast<HmDecCtx*>(h)->maxTemporalLayer = max_layer;
}

libHMDec_error libHMDec_push_nal_unit(void* h, const void* data8, int length,
                                      bool eof, bool& bNewPicture,
                                      bool& checkOutputPictures) {
  HmDecCtx* c = static_cast<HmDecCtx*>(h);
  bNewPicture = false;
  checkOutputPictures = false;
  const uint8_t* p = static_cast<const uint8_t*>(data8);
  int n = length;
  if (p && n >= 4 && p[0] == 0 && p[1] == 0 && p[2] == 0 && p[3] == 1) {
    p += 4; n -= 4;
  } else if (p && n >= 3 && p[0] == 0 && p[1] == 0 && p[2] == 1) {
    p += 3; n -= 3;
  }
  if (p && n >= 2) {
    int nalType = (p[0] >> 1) & 0x3F;
    int tid = (p[1] & 7) - 1;
    bool vcl = nalType < 32;
    if (vcl && c->maxTemporalLayer >= 0 && tid > c->maxTemporalLayer) {
      // dropped sub-layer (reference libHMDecoder.cpp:147)
    } else if (vcl) {
      // peek first_slice_segment_in_pic_flag (first bit after the header)
      int firstSlice = (p[2] >> 7) & 1;
      if (firstSlice && c->dec.cur) {
        // ends the open picture: finish + ask the caller to re-push this
        // same NAL after draining outputs (reference protocol,
        // libHMDecoder.cpp:169-252 / TAppDecTop re-feed)
        c->dec.finishPicture();
        noteDpb(c);
        if (c->seiCheck) verifyPendingHash(c);
        bNewPicture = true;
        checkOutputPictures = true;
        return LIBHMDEC_OK;
      }
      if (firstSlice && nalType >= 16 && nalType <= 21) {
        // NoRaslOutputFlag: IDR, BLA, or a CRA that starts a sequence;
        // NoOutputOfPriorPicsFlag is no_output_of_prior_pics_flag (the bit
        // after first_slice_segment_in_pic_flag), inferred 1 for a CRA
        bool noRasl = nalType != 21 || c->newSequence;
        bool noOutput = nalType == 21 || ((p[2] >> 6) & 1);
        c->newSequence = false;
        if (noRasl)
          for (auto& q : c->dec.dpb)
            if (q->needed_for_output) {
              if (noOutput) q->needed_for_output = false;
              else c->prior.push_back(q.get());
            }
      }
      c->dec.decodeNal(p, size_t(n));
      noteDpb(c);
      // IRAP starts may bump prior pictures
      if (nalType >= 16 && nalType <= 21) checkOutputPictures = true;
    } else if (nalType == 39 || nalType == 40) {
      // SEI: scan for decoded_picture_hash (suffix) when checking
      std::vector<uint8_t> rbsp = hevc::stripEp(p + 2, size_t(n - 2));
      size_t i = 0;
      while (i + 1 < rbsp.size()) {
        int ptype = 0, psize = 0;
        while (i < rbsp.size() && rbsp[i] == 0xFF) { ptype += 255; i++; }
        if (i >= rbsp.size()) break;
        ptype += rbsp[i++];
        while (i < rbsp.size() && rbsp[i] == 0xFF) { psize += 255; i++; }
        if (i >= rbsp.size()) break;
        psize += rbsp[i++];
        if (ptype == 132 && i < rbsp.size() && rbsp[i] == 0 /*MD5*/) {
          int nplanes = (psize - 1) / 16;
          c->pendingHashPlanes = std::min(nplanes, 3);
          for (int pl = 0; pl < c->pendingHashPlanes; pl++)
            memcpy(c->pendingHash[pl], rbsp.data() + i + 1 + pl * 16, 16);
          c->havePendingHash = true;
        }
        i += psize;
      }
    } else {
      c->dec.decodeNal(p, size_t(n));  // VPS/SPS/PPS/EOS
      if (nalType == 36) {  // EOS flushes
        checkOutputPictures = true;
        c->newSequence = true;
      }
    }
  }
  if (eof) {
    c->eofSeen = true;
    c->dec.finishPicture();
    noteDpb(c);
    if (c->seiCheck) verifyPendingHash(c);
    checkOutputPictures = true;
  }
  return LIBHMDEC_OK;
}

// DPB bumping per Rec. C.5.2.2 (reference libHMDecoder.cpp:255-339)
void* libHMDec_get_picture(void* h) {
  HmDecCtx* c = static_cast<HmDecCtx*>(h);
  hevc::Decoder& d = c->dec;
  if (!c->prior.empty()) {
    // the earlier sequence first, in POC order (the native DPB keeps every
    // picture until the decoder is freed, so the pointers hold)
    auto it = std::min_element(
        c->prior.begin(), c->prior.end(),
        [](hevc::Picture* a, hevc::Picture* b) { return a->poc < b->poc; });
    hevc::Picture* pic = *it;
    c->prior.erase(it);
    pic->needed_for_output = false;
    d.waitReconPic(pic);
    return pic;
  }
  int notDisplayed = 0, live = 0;
  hevc::Picture* minPic = nullptr;
  for (auto& q : d.dpb) {
    // the native DPB keeps retired pictures for the internals API; the
    // C.5.2.2 occupancy only counts live entries (reference pcListPic
    // erases output+unreferenced pictures)
    if (q->is_reference || q->needed_for_output) live++;
    if (q->needed_for_output) {
      notDisplayed++;
      if (!minPic || q->poc < minPic->poc) minPic = q.get();
    }
  }
  if (!minPic) return nullptr;
  const hevc::SPS& s = d.spsMap[minPic->sps_id];
  int sl = s.max_sub_layers_minus1;
  bool flush = c->eofSeen;
  if (flush || notDisplayed > s.num_reorder_pics[sl] ||
      live >= s.max_dec_pic_buffering[sl] + 1) {
    minPic->needed_for_output = false;
    // pipeline: the client reads this picture's planes directly via
    // libHMDEC_get_image_plane — they must be reconstructed by now
    d.waitReconPic(minPic);
    return minPic;
  }
  return nullptr;
}

int libHMDEC_get_POC(void* pic) {
  return static_cast<hevc::Picture*>(pic)->poc;
}

int libHMDEC_get_picture_width(void* pic, libHMDec_ColorComponent comp) {
  auto* p = static_cast<hevc::Picture*>(pic);
  const hevc::SPS* s = spsOf(p);
  if (!s) return 0;
  return comp == LIBHMDEC_LUMA ? s->width : s->width >> s->ssx();
}

int libHMDEC_get_picture_height(void* pic, libHMDec_ColorComponent comp) {
  auto* p = static_cast<hevc::Picture*>(pic);
  const hevc::SPS* s = spsOf(p);
  if (!s) return 0;
  return comp == LIBHMDEC_LUMA ? s->height : s->height >> s->ssy();
}

int libHMDEC_get_picture_stride(void* pic, libHMDec_ColorComponent comp) {
  auto* p = static_cast<hevc::Picture*>(pic);
  const hevc::SPS* s = spsOf(p);
  if (!s) return 0;
  int sx = comp == LIBHMDEC_LUMA ? 0 : s->ssx();
  return int((int64_t(s->picWCtbs()) << s->log2_ctb) >> sx);
}

// libHMDecoder.h's planes are short*: a sample of 2^15 and up (bit depths
// above 15) travels as its 16-bit pattern, to be read back as unsigned
short* libHMDEC_get_image_plane(void* pic, libHMDec_ColorComponent comp) {
  auto* p = static_cast<hevc::Picture*>(pic);
  if (comp >= 1 && p->plane[comp].empty()) return nullptr;
  return reinterpret_cast<short*>(p->plane[comp].data());
}

libHMDec_ChromaFormat libHMDEC_get_chroma_format(void* pic) {
  const hevc::SPS* s = spsOf(static_cast<hevc::Picture*>(pic));
  if (!s) return LIBHMDEC_CHROMA_UNKNOWN;
  switch (s->chroma_format_idc) {
    case 0: return LIBHMDEC_CHROMA_400;
    case 1: return LIBHMDEC_CHROMA_420;
    case 2: return LIBHMDEC_CHROMA_422;
    case 3: return LIBHMDEC_CHROMA_444;
  }
  return LIBHMDEC_CHROMA_UNKNOWN;
}

int libHMDEC_get_internal_bit_depth(libHMDec_ColorComponent comp) {
  // matches the reference's global-bit-depth signature
  // (libHMDecoder.h:243: no picture argument; reads g_bitDepth)
  const hevc::SPS* s = g_lastSps;
  if (!s) return 8;
  return comp == LIBHMDEC_LUMA ? s->bit_depth_luma : s->bit_depth_chroma;
}

// --------------------------------------------------------------------------
// internals API: CU/PU/TU rectangles from the flat parse maps
std::vector<libHMDec_BlockValue>* libHMDEC_get_internal_info(
    void* h, void* pic, libHMDec_info_type type) {
  HmDecCtx* c = static_cast<HmDecCtx*>(h);
  auto* p = static_cast<hevc::Picture*>(pic);
  const hevc::SPS* s = spsOf(p);
  auto& out = c->internals;
  out.clear();
  if (!s) return &out;
  int w4 = p->w4, h4 = p->h4;
  int ctb = 1 << s->log2_ctb;
  auto push = [&](int x, int y, int w, int hh, int v, int v2 = 0) {
    libHMDec_BlockValue b;
    b.x = (unsigned short)x; b.y = (unsigned short)y;
    b.w = (unsigned short)w; b.h = (unsigned short)hh;
    b.value = v; b.value2 = v2;
    out.push_back(b);
  };
  if (type == LIBHMDEC_CTU_SLICE_INDEX) {
    for (int cy = 0; cy < s->picHCtbs(); cy++)
      for (int cx = 0; cx < s->picWCtbs(); cx++)
        push(cx * ctb, cy * ctb, ctb, ctb,
             int(p->slice_idx[size_t(cy * (ctb >> 2)) * w4 + cx * (ctb >> 2)]));
    return &out;
  }
  if (type >= LIBHMDEC_CU_PREDICTION_MODE && type <= LIBHMDEC_CU_ROOT_CBF) {
    // walk CU anchors from the depth map
    for (int y = 0; y < h4; y++)
      for (int x = 0; x < w4; x++) {
        size_t i = size_t(y) * w4 + x;
        if (p->slice_idx[i] < 0) continue;  // outside picture
        int size4 = (ctb >> p->depth[i]) >> 2;
        if (x % size4 || y % size4) continue;  // not the CU anchor
        int px = x << 2, py = y << 2, pw = size4 << 2;
        switch (type) {
          case LIBHMDEC_CU_PREDICTION_MODE:
            push(px, py, pw, pw, p->pred_mode[i] == 1 ? 1 : 0); break;
          case LIBHMDEC_CU_TRQ_BYPASS:
            push(px, py, pw, pw, p->tq_bypass[i]); break;
          case LIBHMDEC_CU_SKIP_FLAG:
            push(px, py, pw, pw, p->skip[i]); break;
          case LIBHMDEC_CU_PART_MODE:
            push(px, py, pw, pw, p->part_size[i]); break;
          case LIBHMDEC_CU_INTRA_MODE_LUMA:
            if (p->pred_mode[i] == 1) push(px, py, pw, pw, p->intra_y[i]);
            break;
          case LIBHMDEC_CU_INTRA_MODE_CHROMA:
            if (p->pred_mode[i] == 1) push(px, py, pw, pw, p->intra_c[i]);
            break;
          case LIBHMDEC_CU_ROOT_CBF:
            if (p->pred_mode[i] == 0 && !p->skip[i])
              push(px, py, pw, pw, p->root_cbf[i]);
            break;
          default: break;
        }
      }
    return &out;
  }
  if (type >= LIBHMDEC_PU_MERGE_FLAG && type <= LIBHMDEC_PU_MV_1) {
    for (const hevc::PuMeta& pu : p->inter_list) {
      switch (type) {
        case LIBHMDEC_PU_MERGE_FLAG:
          push(pu.x, pu.y, pu.w, pu.h, pu.merge); break;
        case LIBHMDEC_PU_MERGE_INDEX:
          if (pu.merge) push(pu.x, pu.y, pu.w, pu.h, pu.merge_idx);
          break;
        case LIBHMDEC_PU_UNI_BI_PREDICTION:
          push(pu.x, pu.y, pu.w, pu.h, pu.dir == 3 ? 1 : 0); break;
        case LIBHMDEC_PU_REFERENCE_POC_0:
          if (pu.dir & 1) push(pu.x, pu.y, pu.w, pu.h, pu.ref_poc[0]);
          break;
        case LIBHMDEC_PU_MV_0:
          if (pu.dir & 1)
            push(pu.x, pu.y, pu.w, pu.h, pu.mv[0][0], pu.mv[0][1]);
          break;
        case LIBHMDEC_PU_REFERENCE_POC_1:
          if (pu.dir & 2) push(pu.x, pu.y, pu.w, pu.h, pu.ref_poc[1]);
          break;
        case LIBHMDEC_PU_MV_1:
          if (pu.dir & 2)
            push(pu.x, pu.y, pu.w, pu.h, pu.mv[1][0], pu.mv[1][1]);
          break;
        default: break;
      }
    }
    return &out;
  }
  // TU types: coded TUs from the TU list (luma coords)
  int wantComp = 0;
  switch (type) {
    case LIBHMDEC_TU_CBF_CB: case LIBHMDEC_TU_COEFF_TR_SKIP_Cb:
    case LIBHMDEC_TU_COEFF_ENERGY_CB: wantComp = 1; break;
    case LIBHMDEC_TU_CBF_CR: case LIBHMDEC_TU_COEFF_TR_SKIP_Cr:
    case LIBHMDEC_TU_COEFF_ENERGY_CR: wantComp = 2; break;
    default: wantComp = 0;
  }
  int sx = wantComp ? s->ssx() : 0, sy = wantComp ? s->ssy() : 0;
  for (const hevc::TuMeta& t : p->tu_list) {
    if (t.comp != wantComp) continue;
    int lx = t.x << sx, ly = t.y << sy, lw = t.w << sx, lh = t.h << sy;
    switch (type) {
      case LIBHMDEC_TU_CBF_Y: case LIBHMDEC_TU_CBF_CB:
      case LIBHMDEC_TU_CBF_CR:
        push(lx, ly, lw, lh, 1); break;
      case LIBHMDEC_TU_COEFF_TR_SKIP_Y: case LIBHMDEC_TU_COEFF_TR_SKIP_Cb:
      case LIBHMDEC_TU_COEFF_TR_SKIP_Cr:
        push(lx, ly, lw, lh, t.tskip); break;
      case LIBHMDEC_TU_COEFF_ENERGY_Y: case LIBHMDEC_TU_COEFF_ENERGY_CB:
      case LIBHMDEC_TU_COEFF_ENERGY_CR: {
        int64_t e = 0;
        const int32_t* co = &p->coeffs[t.coeff_off];
        // rows past last_row are semantically zero (and may be
        // uninitialized pool memory in native-recon mode)
        for (int k = 0; k < t.w * (t.last_row + 1); k++)
          e += int64_t(co[k]) * co[k];
        push(lx, ly, lw, lh, int(std::min<int64_t>(e, INT32_MAX)));
        break;
      }
      default: break;
    }
  }
  return &out;
}

libHMDec_error libHMDEC_clear_internal_info(void* h) {
  static_cast<HmDecCtx*>(h)->internals.clear();
  return LIBHMDEC_OK;
}

// C-friendly accessors for the internals vector (extension; the reference
// returns a std::vector* which plain-C / ctypes callers cannot traverse)
int libHMDEC_internal_info_size(std::vector<libHMDec_BlockValue>* v) {
  return v ? int(v->size()) : 0;
}
libHMDec_BlockValue* libHMDEC_internal_info_data(
    std::vector<libHMDec_BlockValue>* v) {
  return (v && !v->empty()) ? v->data() : nullptr;
}

// hash check status: 1 = all checked pictures OK so far, 0 = mismatch seen
int libHMDEC_get_hash_ok(void* h) {
  return static_cast<HmDecCtx*>(h)->md5Mismatch ? 0 : 1;
}

}  // extern "C"
