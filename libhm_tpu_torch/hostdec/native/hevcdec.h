// Copied from libhm_tpu/hostdec/native/hevcdec.h
// HEVC host decode plane — native implementation.
//
// C++ translation of the validated Python parser in libhm_tpu/hostdec
// (bitstream.py, cabac.py, params.py, slicedec.py, residual.py, motion.py).
// Parses Annex-B streams into whole-picture flat tensors (mode/MV/coeff
// maps) consumed by the TPU reconstruction backend.  No pixel math here.
//
// Mirrors the behavior of the reference's TLibDecoder front half
// (TDecCAVLC/TDecSbac/TDecEntropy/TDecCu syntax parse; TComDataCU
// merge/AMVP/TMVP derivation) — re-architected as a picture-at-a-time
// tensor emitter.
#pragma once
#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>
#include <memory>
#include <array>

namespace hevc {

// Sample type: int16 like the reference's Pel (bit depths <= 14; the 16-bit
// RExt profiles would need the Int build the reference gates behind
// RExt__HIGH_BIT_DEPTH_SUPPORT, TypeDef.h:260).  Half the memory traffic and
// twice the SIMD lanes of the round-1 int32 planes.
using Pel = int16_t;

// Vector whose elements are NOT value-initialized on resize.  Picture
// planes are fully written by reconstruction (every real-area sample is
// covered by a pred/PCM block before the filters read it); zeroing 6+ MB
// per 1080p picture was a measurable share of single-thread decode time.
// The CTU-alignment padding strips are zeroed explicitly in ReconCtx::run
// so stride-sized rows exposed through the C ABI stay deterministic.
template <class T>
struct NoInitAlloc : std::allocator<T> {
  template <class U> struct rebind { using other = NoInitAlloc<U>; };
  template <class U, class... A>
  void construct(U* p, A&&... a) {
    if constexpr (sizeof...(A) > 0)
      ::new (static_cast<void*>(p)) U(std::forward<A>(a)...);
  }
};
using PelBuf = std::vector<Pel, NoInitAlloc<Pel>>;
// coefficient pool: slots are explicitly memset by the parser (fully, or
// only up to the scan bound in native-recon mode) before levels scatter in
using CoefBuf = std::vector<int32_t, NoInitAlloc<int32_t>>;

// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* data = nullptr;
  size_t nbits = 0;
  size_t pos = 0;

  void init(const uint8_t* d, size_t nbytes) { data = d; nbits = nbytes * 8; pos = 0; }
  int bit() {
    if (pos >= nbits) return 0;  // tolerate overrun like the reference
    int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t u(int n) { uint32_t v = 0; for (int i = 0; i < n; i++) v = (v << 1) | bit(); return v; }
  uint32_t ue() {
    int zeros = 0;
    while (bit() == 0 && zeros <= 32) zeros++;
    if (zeros == 0) return 0;
    return (1u << zeros) - 1 + u(zeros);
  }
  int32_t se() { uint32_t k = ue(); return (k & 1) ? int32_t((k + 1) >> 1) : -int32_t(k >> 1); }
  void byteAlign() { pos = (pos + 7) & ~size_t(7); }
};

// ---------------------------------------------------------------------------
// dequant scaling lists: base (<=8x8) lists in raster order + DC values,
// fully materialised at parse time (explicit / copied / default)
struct ScalingListData {
  bool present = false;
  uint8_t coef[4][6][64];  // [sizeId][matrixId][raster]
  int dc[4][6];
};

struct ShortTermRPS {
  int num_negative = 0, num_positive = 0;
  std::vector<int> delta_poc;
  std::vector<int> used;
  int numPics() const { return num_negative + num_positive; }
};

struct SPS {
  int sps_id = 0;
  int chroma_format_idc = 1;
  int separate_colour_plane = 0;
  int width = 0, height = 0;
  int conf_win[4] = {0, 0, 0, 0};
  int bit_depth_luma = 8, bit_depth_chroma = 8;
  int log2_max_poc_lsb = 8;
  int max_dec_pic_buffering[8] = {0};
  int num_reorder_pics[8] = {0};
  int log2_min_cb = 3, log2_ctb = 6, log2_min_tb = 2, log2_max_tb = 5;
  int max_tr_hierarchy_inter = 0, max_tr_hierarchy_intra = 0;
  int scaling_list_enabled = 0;
  int amp_enabled = 0, sao_enabled = 0;
  int pcm_enabled = 0, pcm_bd_luma = 8, pcm_bd_chroma = 8;
  int log2_min_ipcm = 3, log2_max_ipcm = 3, pcm_loop_filter_disabled = 0;
  std::vector<ShortTermRPS> st_rps;
  int long_term_ref_pics_present = 0;
  std::vector<int> lt_poc_lsb_sps, lt_used_sps;
  int temporal_mvp_enabled = 0, strong_intra_smoothing = 0;
  int max_sub_layers_minus1 = 0;
  // RExt
  int transform_skip_rotation = 0, transform_skip_context = 0;
  int implicit_rdpcm = 0, explicit_rdpcm = 0, extended_precision = 0;
  int intra_smoothing_disabled = 0, high_precision_offsets = 0;
  int persistent_rice_adaptation = 0, cabac_bypass_alignment = 0;
  ScalingListData scaling;

  int ctbSize() const { return 1 << log2_ctb; }
  int picWCtbs() const { return (width + ctbSize() - 1) >> log2_ctb; }
  int picHCtbs() const { return (height + ctbSize() - 1) >> log2_ctb; }
  int picSizeCtbs() const { return picWCtbs() * picHCtbs(); }
  int ssx() const { return (chroma_format_idc == 1 || chroma_format_idc == 2) ? 1 : 0; }
  int ssy() const { return chroma_format_idc == 1 ? 1 : 0; }
};

struct PPS {
  int pps_id = 0, sps_id = 0;
  int dependent_slice_segments_enabled = 0;
  int output_flag_present = 0;
  int num_extra_slice_header_bits = 0;
  int sign_data_hiding = 0, cabac_init_present = 0;
  int num_ref_l0_default = 1, num_ref_l1_default = 1;
  int init_qp = 26;
  int constrained_intra_pred = 0, transform_skip_enabled = 0;
  int cu_qp_delta_enabled = 0, diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0;
  int slice_chroma_qp_offsets_present = 0;
  int weighted_pred = 0, weighted_bipred = 0;
  int transquant_bypass_enabled = 0;
  int tiles_enabled = 0, entropy_coding_sync = 0;
  int num_tile_cols = 1, num_tile_rows = 1, uniform_spacing = 1;
  std::vector<int> tile_col_widths, tile_row_heights;  // explicit (n-1 entries)
  int loop_filter_across_tiles = 1, loop_filter_across_slices = 0;
  int deblocking_override_enabled = 0, deblocking_disabled = 0;
  int beta_offset_div2 = 0, tc_offset_div2 = 0;
  int lists_modification_present = 0;
  int log2_parallel_merge_level = 2;
  int slice_header_extension_present = 0;
  // RExt
  int log2_max_transform_skip_size = 2;
  int cross_component_prediction = 0;
  int chroma_qp_offset_list_enabled = 0, diff_cu_chroma_qp_offset_depth = 0;
  std::vector<std::array<int, 2>> chroma_qp_offset_list;
  int sao_offset_scale_luma = 0, sao_offset_scale_chroma = 0;
  ScalingListData scaling;
};

struct WpEntry { int w = 0, o = 0; };

struct SliceHeader {
  int nal_type = 0, temporal_id = 0;
  int first_slice_in_pic = 0, no_output_of_prior_pics = 0;
  int pps_id = 0, dependent = 0, segment_address = 0;
  int slice_type = 2;  // 0=B 1=P 2=I
  int pic_output_flag = 1;
  int poc_lsb = 0;
  int poc = 0;
  ShortTermRPS rps;
  std::vector<int> lt_poc_lsb, lt_used, lt_msb_present, lt_delta_poc_msb;
  int temporal_mvp = 0;
  int sao_luma = 0, sao_chroma = 0;
  int num_ref_idx[2] = {0, 0};
  int has_list_mod[2] = {0, 0};
  std::vector<int> list_mod[2];
  int mvd_l1_zero = 0, cabac_init_flag = 0;
  int collocated_from_l0 = 1, collocated_ref_idx = 0;
  int has_wp = 0;
  int wp_log2_denom_luma = 0, wp_log2_denom_chroma = 0;
  WpEntry wp[2][16][3];  // [list][refidx][comp]
  int max_num_merge_cand = 5;
  int qp = 26;
  int cb_qp_offset = 0, cr_qp_offset = 0;
  int cu_chroma_qp_offset_enabled = 0;
  int deblocking_disabled = 0, beta_offset_div2 = 0, tc_offset_div2 = 0;
  int loop_filter_across_slices = 0;
  std::vector<int> entry_points;
  std::vector<int> epb_positions;  // rbsp indices following removed 00 00 03
  size_t data_bit_offset = 0;
};

// ---------------------------------------------------------------------------
// CABAC (spec-form bit-oriented engine, identical to hostdec/cabac.py)
struct Cabac {
  // bit feed: 64-bit MSB-first prefetch cache; reads past the end of the
  // buffer return zero bits (the multi-slice overlap re-parse relies on
  // well-defined over-reads)
  const uint8_t* data;
  size_t nbytes;
  uint32_t range, offset;
  uint64_t cache = 0;
  int cnt = 0;        // valid bits at the top of `cache`
  size_t nextByte = 0;

  inline void refill() {
    while (cnt <= 56) {
      uint64_t b = nextByte < nbytes ? data[nextByte] : 0;
      nextByte++;
      cache |= b << (56 - cnt);
      cnt += 8;
    }
  }
  inline uint32_t take(int n) {  // n <= 32
    if (cnt < n) refill();
    uint32_t v = uint32_t(cache >> (64 - n));
    cache <<= n;
    cnt -= n;
    return v;
  }
  size_t bitPos() const { return nextByte * 8 - size_t(cnt); }
  void seekBit(size_t bit) {
    nextByte = bit >> 3;
    cache = 0;
    cnt = 0;
    refill();
    int skip = int(bit & 7);
    cache <<= skip;
    cnt -= skip;
  }
  void start(const uint8_t* d, size_t nb, size_t startBit) {
    data = d; nbytes = nb;
    seekBit(startBit);
    range = 510;
    offset = take(9);
  }
  inline int readBit() { return int(take(1)); }
  uint32_t readBits(int n) { return n ? take(n) : 0; }
  inline int bin(uint8_t& state);
  inline int bypass();
  // N bypass bins at once.  Unrolling the per-bit recurrence
  //   off <- 2*off + bit - range*b,  b = (2*off + bit >= range)
  // gives off_n = X - range*v with X = (off_0 << n) | bits and v the emitted
  // value, constrained to 0 <= off_n < range: so v = X / range (one udiv
  // replaces n serial compare-subtract steps).  Exact for any n with X in
  // 64 bits; range stays in [256, 510] during bypass runs so n <= 53.
  uint32_t bypassN(int n) {
    uint32_t v = 0;
    while (n > 22) {  // keep X comfortably in uint32 per chunk
      v = (v << 22) | bypassN(22);
      n -= 22;
    }
    if (!n) return v;
    uint32_t x = (offset << n) | take(n);
    uint32_t q = x / range;
    offset = x - q * range;
    return (v << n) | q;
  }
  inline int term();
  int egk(int k) {
    int v = 0;
    while (bypass()) { v += 1 << k; k++; }
    if (k) v += int(bypassN(k));
    return v;
  }
  void alignRange() { range = 256; }
};

// ---------------------------------------------------------------------------
// Per-picture parsed output (flat tensors)
struct TuMeta {  // one residual block
  int32_t comp, x, y, w, h, qp, use_dst, tskip, bypass, rdpcm, alpha, coeff_off;
  // exact nonzero extent of the coefficient block (raster row/col of the
  // furthest significant coefficient; -1,-1 when all-zero).  Lets the
  // reconstruction skip its row scan, and — in native-recon mode — lets
  // the parser skip zero-filling the slot beyond the covered rows.
  int32_t last_row, last_col;
};
struct IntraMeta { int32_t comp, x, y, w, h, mode, tu_index; };
struct PuMeta {
  int32_t x, y, w, h, dir;
  int32_t merge, merge_idx;  // merge_flag / merge_idx (internals API)
  int32_t mv[2][2];
  int32_t ref_idx[2];
  int32_t ref_poc[2];
  int32_t has_wp, wp_denom_l, wp_denom_c;
  int32_t wp_w[2][3], wp_o[2][3];
};
struct PcmMeta { int32_t comp, x, y, w, h, bits, sample_off; };

// coefficient/TU-pool high-water marks across pictures: fresh pictures
// reserve the previous peak so the parse never pays incremental
// reallocation+copy growth on the pools (they reach megabytes at 1080p)
inline std::atomic<size_t> g_coefHiWater{0};
inline std::atomic<size_t> g_tuHiWater{0};

struct Picture {
  int poc = 0, nal_type = 0, temporal_id = 0, output_flag = 1;
  int sps_id = 0, pps_id = 0;
  int w4 = 0, h4 = 0, nctu = 0;
  // product-list sizes recorded before a lowmem decode frees the lists
  // (hevcdec_pic_info keeps reporting the true counts)
  long long cnt_tu = -1, cnt_coef = -1, cnt_intra = -1, cnt_inter = -1;
  long long cnt_pcm = -1, cnt_pcm_samp = -1;
  // 4x4 maps [h4*w4]
  std::vector<int8_t> depth, pred_mode, part_size, skip, pcm, tq_bypass;
  std::vector<int8_t> intra_y, intra_c, chroma_dm, qp, cbf_y, inter_dir;
  std::vector<int8_t> root_cbf;   // inter CU rqt_root_cbf (internals API)
  std::vector<int8_t> ref_idx;     // [h4*w4*2]
  std::vector<int8_t> ref_is_lt;   // [h4*w4*2]
  std::vector<int32_t> mv;         // [h4*w4*2*2]
  std::vector<int32_t> ref_poc;    // [h4*w4*2]
  std::vector<int32_t> slice_idx;  // [h4*w4]
  std::vector<uint8_t> edge_flags;
  std::vector<int8_t> deblock_disable, beta_offset, tc_offset, lf_across;
  // SAO [nctu*3]
  std::vector<int8_t> sao_type, sao_band;
  std::vector<int32_t> sao_offsets;  // [nctu*3*4]
  // lists
  std::vector<TuMeta> tu_list;
  CoefBuf coeffs;                    // concatenated w*h blocks
  std::vector<IntraMeta> intra_list;
  std::vector<PuMeta> inter_list;
  std::vector<PcmMeta> pcm_list;
  std::vector<int32_t> pcm_samples;
  // reconstructed planes (filled by recon.cpp when recon is enabled),
  // padded to CTU multiples like the reference picture buffers
  PelBuf plane[3];
  // long-term flag for this picture while in DPB (decoder-side)
  bool is_long_term = false;
  bool is_reference = true;
  bool needed_for_output = true;

  void init(const SPS& s) {
    w4 = (s.picWCtbs() << s.log2_ctb) >> 2;
    h4 = (s.picHCtbs() << s.log2_ctb) >> 2;
    nctu = s.picSizeCtbs();
    size_t n = size_t(w4) * h4;
    depth.assign(n, 0); pred_mode.assign(n, 1); part_size.assign(n, 0);
    skip.assign(n, 0); pcm.assign(n, 0); tq_bypass.assign(n, 0);
    intra_y.assign(n, 1); intra_c.assign(n, 1); chroma_dm.assign(n, 0);
    qp.assign(n, 0); cbf_y.assign(n, 0); inter_dir.assign(n, 0);
    root_cbf.assign(n, 0);
    ref_idx.assign(n * 2, -1); ref_is_lt.assign(n * 2, 0);
    mv.assign(n * 4, 0); ref_poc.assign(n * 2, 0);
    slice_idx.assign(n, -1);
    edge_flags.assign(n, 0);
    deblock_disable.assign(n, 0); beta_offset.assign(n, 0);
    tc_offset.assign(n, 0); lf_across.assign(n, 1);
    sao_type.assign(size_t(nctu) * 3, -1);
    sao_band.assign(size_t(nctu) * 3, 0);
    sao_offsets.assign(size_t(nctu) * 12, 0);
    coeffs.reserve(g_coefHiWater.load(std::memory_order_relaxed));
    tu_list.reserve(g_tuHiWater.load(std::memory_order_relaxed));
  }

  // Free everything only this picture's own parse/recon consumes.  Kept
  // alive: plane[] (MC reference + output) and the five TMVP source maps
  // (pred_mode, inter_dir, mv, ref_poc, ref_is_lt) read by later
  // pictures' collocated-motion derivation until DPB retirement.
  void shrinkAfterRecon() {
    cnt_tu = (long long)tu_list.size();
    cnt_coef = (long long)coeffs.size();
    cnt_intra = (long long)intra_list.size();
    cnt_inter = (long long)inter_list.size();
    cnt_pcm = (long long)pcm_list.size();
    cnt_pcm_samp = (long long)pcm_samples.size();
    auto drop = [](auto& v) { typename std::decay<decltype(v)>::type().swap(v); };
    drop(depth); drop(part_size); drop(skip); drop(pcm); drop(tq_bypass);
    drop(intra_y); drop(intra_c); drop(chroma_dm); drop(qp); drop(cbf_y);
    drop(root_cbf); drop(ref_idx); drop(slice_idx); drop(edge_flags);
    drop(deblock_disable); drop(beta_offset); drop(tc_offset);
    drop(lf_across); drop(sao_type); drop(sao_band); drop(sao_offsets);
    drop(tu_list); drop(coeffs); drop(intra_list); drop(inter_list);
    drop(pcm_list); drop(pcm_samples);
  }

  // Retired from the DPB (not a reference for any later picture): the
  // TMVP source maps are dead too.  plane[] stays — the output API reads
  // it, and lost-reference fabrication may still MC-gather from it.
  void shrinkAtRetirement() {
    auto drop = [](auto& v) { typename std::decay<decltype(v)>::type().swap(v); };
    drop(pred_mode); drop(inter_dir); drop(mv); drop(ref_poc);
    drop(ref_is_lt);
  }
};

}  // namespace hevc
