// Copied from libhm_tpu/hostdec/native/api.cpp
// Top-level decoder (NAL loop, POC, RPS, ref lists) + C API.
// Single translation unit pulling in the whole native parser.
#include "hevcdec.cpp"
#include "sliceparse.cpp"
#include "motion.cpp"
#include "recon.cpp"
#include "encsearch.cpp"
#include "rdoq.cpp"
#include "encctu.cpp"

#include <atomic>
#include <condition_variable>
#include <deque>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <map>
#include <mutex>
#include <thread>
#ifdef __GLIBC__
#include <malloc.h>
#endif

namespace hevc {

// ---------------------------------------------------------------------------
static std::vector<uint8_t> stripEp(const uint8_t* d, size_t n,
                                    std::vector<int>* epbPos = nullptr) {
  std::vector<uint8_t> out;
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; i++) {
    uint8_t b = d[i];
    if (zeros == 2 && b == 3) {
      zeros = 0;
      if (epbPos) epbPos->push_back(int(out.size()));
      continue;
    }
    zeros = b == 0 ? zeros + 1 : 0;
    out.push_back(b);
  }
  return out;
}

static bool isVcl(int t) { return t < 32; }
static bool isIrap(int t) { return t >= 16 && t <= 23; }
static bool isIdr(int t) { return t == 19 || t == 20; }
static bool isBla(int t) { return t >= 16 && t <= 18; }
static bool isRasl(int t) { return t == 8 || t == 9; }
static bool isRadl(int t) { return t == 6 || t == 7; }
// corrupt-stream guard: reject a parsed SPS whose geometry is junk before
// it can drive allocations (the reference asserts; a library must not)
static bool spsSane(const SPS& s) {
  return s.sps_id >= 0 && s.sps_id <= 15 &&
         s.width >= 8 && s.width <= 16384 &&
         s.height >= 8 && s.height <= 16384 &&
         s.chroma_format_idc >= 0 && s.chroma_format_idc <= 3 &&
         s.bit_depth_luma >= 8 && s.bit_depth_luma <= 16 &&
         s.bit_depth_chroma >= 8 && s.bit_depth_chroma <= 16 &&
         s.log2_min_cb >= 3 && s.log2_ctb >= s.log2_min_cb &&
         s.log2_ctb <= 6 &&
         s.log2_min_tb >= 2 && s.log2_max_tb >= s.log2_min_tb &&
         s.log2_max_tb <= 5 && s.log2_max_poc_lsb <= 16;
}

static bool isSubNonRef(int t) {
  return t == 0 || t == 2 || t == 4 || t == 6 || t == 8 || t == 10 || t == 12 || t == 14;
}

struct Decoder {
  bool reconEnabled = false;
  // free per-picture parse products right after that picture's recon
  // (hevcdec bridge mode: callers read only pic_info counts + output
  // planes).  libhmdec keeps this off — its internals API reads the maps.
  bool lowmem = false;
  std::map<int, SPS> spsMap;
  std::map<int, PPS> ppsMap;
  // DPB of parse-plane pictures (kept alive for TMVP + ref poc bookkeeping)
  std::vector<std::unique_ptr<Picture>> dpb;
  std::vector<std::unique_ptr<Picture>> done;  // finished pictures in decode order
  int prevTid0Poc = 0;
  bool newSequence = true;
  bool noRaslOutput = false;
  bool assocIrapNoRasl = false;
  // current picture under construction
  std::unique_ptr<Picture> cur;
  std::unique_ptr<SliceParser> parser;
  int sliceCount = 0;
  int curSliceId = 0;
  SliceHeader curSh;  // first slice header of current picture
  SliceHeader lastIndepSh;  // for dependent-segment inheritance

  Picture* findDpbPoc(int p) {
    Picture* best = nullptr;
    for (auto& q : dpb)
      if (q->poc == p && q->is_reference) return q.get();
    // lost reference: closest poc (reference TDecTop::xCreateLostPicture)
    int bd = 1 << 30;
    for (auto& q : dpb) {
      int dd = std::abs(q->poc - p);
      if (dd < bd) { bd = dd; best = q.get(); }
    }
    return best;
  }
  Picture* findDpbLsb(int lsb, int maxLsb) {
    for (auto& q : dpb)
      if ((q->poc & (maxLsb - 1)) == lsb && q->is_reference) return q.get();
    return nullptr;
  }

  void buildRefLists(SliceParser& sp, const SliceHeader& sh, const SPS& sps) {
    std::vector<RefPicInfo> before, after, lt;
    for (int i = 0; i < sh.rps.numPics(); i++) {
      int rp = sh.poc + sh.rps.delta_poc[i];
      Picture* p = findDpbPoc(rp);
      if (sh.rps.used[i]) {
        RefPicInfo info{p, p ? p->poc : rp, p ? p->is_long_term : false};
        if (sh.rps.delta_poc[i] < 0) before.push_back(info);
        else after.push_back(info);
      }
    }
    int maxLsb = 1 << sps.log2_max_poc_lsb;
    for (size_t i = 0; i < sh.lt_poc_lsb.size(); i++) {
      Picture* p;
      if (sh.lt_msb_present[i]) {
        int rp = sh.lt_poc_lsb[i] + sh.poc - (sh.poc & (maxLsb - 1)) -
                 sh.lt_delta_poc_msb[i] * maxLsb;
        p = findDpbPoc(rp);
      } else p = findDpbLsb(sh.lt_poc_lsb[i], maxLsb);
      if (p) p->is_long_term = true;
      if (sh.lt_used[i]) lt.push_back({p, p ? p->poc : 0, true});
    }
    std::vector<RefPicInfo> l0 = before, l1 = after;
    l0.insert(l0.end(), after.begin(), after.end());
    l0.insert(l0.end(), lt.begin(), lt.end());
    l1.insert(l1.end(), before.begin(), before.end());
    l1.insert(l1.end(), lt.begin(), lt.end());
    const std::vector<RefPicInfo>* defaults[2] = {&l0, &l1};
    for (int li = 0; li < 2; li++) {
      sp.refList[li].clear();
      const auto& def = *defaults[li];
      if (def.empty()) continue;
      if (sh.has_list_mod[li]) {
        for (int j : sh.list_mod[li]) sp.refList[li].push_back(def[j]);
      } else {
        for (int i = 0; i < sh.num_ref_idx[li]; i++)
          sp.refList[li].push_back(def[i % def.size()]);
      }
    }
  }

  bool lowmemSerial() {
    return lowmem && pipelineThreads() <= 1 && !parsePipelined();
  }
  void retire(Picture* p) {
    if (p->is_reference) {
      p->is_reference = false;
      if (lowmemSerial()) p->shrinkAtRetirement();
    }
  }

  void applyRpsRetirement(const SliceHeader& sh, const SPS& sps) {
    if (isIdr(sh.nal_type) || isBla(sh.nal_type)) {
      for (auto& p : dpb) retire(p.get());
      return;
    }
    std::vector<int> keep;
    for (int i = 0; i < sh.rps.numPics(); i++)
      keep.push_back(sh.poc + sh.rps.delta_poc[i]);
    int maxLsb = 1 << sps.log2_max_poc_lsb;
    for (size_t i = 0; i < sh.lt_poc_lsb.size(); i++) {
      if (sh.lt_msb_present[i])
        keep.push_back(sh.lt_poc_lsb[i] + sh.poc - (sh.poc & (maxLsb - 1)) -
                       sh.lt_delta_poc_msb[i] * maxLsb);
      else
        for (auto& p : dpb)
          if ((p->poc & (maxLsb - 1)) == sh.lt_poc_lsb[i]) keep.push_back(p->poc);
    }
    for (auto& p : dpb) {
      bool found = false;
      for (int k : keep) if (p->poc == k) { found = true; break; }
      if (!found) retire(p.get());
    }
  }

  double tParse = 0, tParseW = 0, tRecon = 0;
  static double now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
  }

  // ---- parse/recon picture pipeline -------------------------------------
  // Two worker pools (reference frame: HM is strictly serial, TDecTop /
  // TDecSlice; the "frame pipeline" slot of SURVEY §2.5):
  //  * PARSE pool: a picture's slice data is a pure function of its rbsp
  //    bits, the parameter sets, a per-slice reference-list snapshot and
  //    the collocated picture's parsed motion field (TMVP).  Pictures
  //    therefore CABAC-parse concurrently with a single ordering edge:
  //    colPic must be parsed first (frame threading).  All DPB/RPS/POC
  //    bookkeeping stays on the main thread; workers only read
  //    snapshotted metadata and the colPic's arrays.
  //  * RECON pool: a picture reconstructs once its reference pictures are
  //    reconstructed (and its own parse finished, which is implied by the
  //    recon task being created at parse completion).
  // Scheduling is readiness-scan, not FIFO: a worker only pops a task
  // whose dependencies are already complete, so it never blocks while
  // holding work (no hold-and-wait, no deadlock; both dependency graphs
  // follow decode order and are acyclic).
  struct ReconTask {
    Picture* pic;
    const SPS* sps;
    const PPS* pps;
    std::vector<std::pair<int, Picture*>> refs;  // poc -> picture snapshot
    std::vector<Picture*> waits;                 // recon dependencies
  };
  struct SliceWork {
    std::vector<uint8_t> rbsp;
    SliceHeader* sh;                 // owned by shStore
    int sliceId = 0;
    bool firstInPic = false;
    std::vector<RefPicInfo> refList[2];  // per-slice snapshot
    bool allRefsBefore = true;
    Picture* colPic = nullptr;
    int colPoc = 0;
  };
  struct ParseTask {
    Picture* pic = nullptr;
    std::unique_ptr<SliceParser> parser;
    const SPS* sps = nullptr;
    const PPS* pps = nullptr;
    std::vector<SliceWork> slices;
  };
  std::deque<ReconTask> reconQ;
  std::deque<ParseTask> parseQ;
  std::mutex pipeMu;
  std::condition_variable pipeCv;
  std::vector<std::thread> workers;       // recon pool
  std::vector<std::thread> parseWorkers;  // parse pool
  std::map<const Picture*, int> reconState;  // 1 = queued/running, 2 = done
  std::map<const Picture*, int> parseState;  // 1 = queued/running, 2 = done
  std::vector<SliceWork> pendingSlices;      // slices of `cur` awaiting submit
  bool pipeStop = false;
  int pipeThreads = -1;       // -1 = undecided
  int parsePipeThreads = -1;  // -1 = undecided

  int pipelineThreads() {
    if (pipeThreads < 0) {
      const char* env = getenv("HEVC_THREADS");
      int want = env ? atoi(env) : int(std::thread::hardware_concurrency());
      pipeThreads = want > 1 ? std::min(want, 8) : 0;
    }
    return pipeThreads;
  }

  int parseThreads() {
    if (parsePipeThreads < 0) {
      const char* env = getenv("HEVC_PARSE_THREADS");
      if (env) {
        parsePipeThreads = std::max(0, atoi(env));
      } else {
        const char* tenv = getenv("HEVC_THREADS");
        int want = tenv ? atoi(tenv)
                        : int(std::thread::hardware_concurrency());
        parsePipeThreads = want > 1 ? std::min(want, 4) : 0;
      }
    }
    return parsePipeThreads;
  }
  bool parsePipelined() { return parseThreads() >= 2; }

  bool reconReady(const ReconTask& t) {
    for (Picture* w : t.waits) {
      auto it = reconState.find(w);
      if (it != reconState.end() && it->second != 2) return false;
    }
    return true;
  }
  bool parseReady(const ParseTask& t) {
    for (const SliceWork& s : t.slices) {
      if (!s.colPic) continue;
      auto it = parseState.find(s.colPic);
      if (it != parseState.end() && it->second != 2) return false;
    }
    return true;
  }

  void workerLoop() {
    std::unique_lock<std::mutex> lk(pipeMu);
    for (;;) {
      size_t idx = SIZE_MAX;
      pipeCv.wait(lk, [&] {
        for (size_t i = 0; i < reconQ.size(); i++)
          if (reconReady(reconQ[i])) { idx = i; return true; }
        return pipeStop && reconQ.empty();
      });
      if (idx == SIZE_MAX) { if (pipeStop && reconQ.empty()) return; continue; }
      ReconTask t = std::move(reconQ[idx]);
      reconQ.erase(reconQ.begin() + idx);
      lk.unlock();
      double t0 = now();
      reconstructPicture(*t.pic, *t.sps, *t.pps, [&t](int poc) -> Picture* {
        for (auto& pr : t.refs)
          if (pr.first == poc) return pr.second;
        return nullptr;
      });
      double dt = now() - t0;
      lk.lock();
      tRecon += dt;
      reconState[t.pic] = 2;
      pipeCv.notify_all();
    }
  }

  void runParseTask(ParseTask& t) {
    SliceParser& sp = *t.parser;
    for (SliceWork& s : t.slices) {
      sp.poc = t.pic->poc;
      for (int l = 0; l < 2; l++) sp.refList[l] = s.refList[l];
      sp.allRefsBefore = s.allRefsBefore;
      sp.colPic = s.colPic;
      sp.colPoc = s.colPoc;
      if (!s.firstInPic)
        dropProductsFromCtu(t.pic, &sp, *t.sps, *t.pps,
                            s.sh->segment_address);
      sp.decodeSlice(s.rbsp.data(), s.rbsp.size(), *s.sh, s.sliceId);
    }
  }

  void parseLoop() {
    std::unique_lock<std::mutex> lk(pipeMu);
    for (;;) {
      size_t idx = SIZE_MAX;
      pipeCv.wait(lk, [&] {
        for (size_t i = 0; i < parseQ.size(); i++)
          if (parseReady(parseQ[i])) { idx = i; return true; }
        return pipeStop && parseQ.empty();
      });
      if (idx == SIZE_MAX) { if (pipeStop && parseQ.empty()) return; continue; }
      ParseTask t = std::move(parseQ[idx]);
      parseQ.erase(parseQ.begin() + idx);
      lk.unlock();
      double t0 = now();
      runParseTask(t);
      double dt = now() - t0;
      // recon task built AFTER parse: ref pocs/pics come from the slice
      // ref-list snapshots (exactly the mapping the PUs' ref_poc used)
      ReconTask r{t.pic, t.sps, t.pps, {}, {}};
      if (reconEnabled) {
        for (SliceWork& s : t.slices)
          for (int l = 0; l < 2; l++)
            for (RefPicInfo& info : s.refList[l]) {
              bool seen = false;
              for (auto& pr : r.refs)
                if (pr.first == info.poc && pr.second == info.pic) {
                  seen = true;
                  break;
                }
              if (!seen) r.refs.push_back({info.poc, info.pic});
            }
        for (auto& pr : r.refs) {
          if (!pr.second || pr.second == t.pic) continue;
          bool seen = false;
          for (Picture* w : r.waits)
            if (w == pr.second) { seen = true; break; }
          if (!seen) r.waits.push_back(pr.second);
        }
      }
      lk.lock();
      tParseW += dt;
      parseState[t.pic] = 2;
      if (reconEnabled) reconQ.push_back(std::move(r));
      pipeCv.notify_all();
    }
  }

  void startReconPool() {
    // callers hold pipeMu
    if (workers.empty()) {
      int n = std::max(1, pipelineThreads() - 1);
      for (int i = 0; i < n; i++)
        workers.emplace_back([this] { workerLoop(); });
    }
  }

  void queueRecon(Picture* p, const SPS& sps, const PPS& pps) {
    ReconTask t{p, &sps, &pps, {}, {}};
    std::vector<int> pocs;
    for (const PuMeta& pu : p->inter_list)
      for (int l = 0; l < 2; l++) {
        if (!(pu.dir & (1 << l))) continue;
        int poc = pu.ref_poc[l];
        bool seen = false;
        for (int q : pocs) if (q == poc) { seen = true; break; }
        if (!seen) pocs.push_back(poc);
      }
    for (int poc : pocs) {
      Picture* rp = findDpbPoc(poc);
      t.refs.push_back({poc, rp});
      if (rp) t.waits.push_back(rp);
    }
    std::lock_guard<std::mutex> lk(pipeMu);
    startReconPool();
    reconState[p] = 1;
    reconQ.push_back(std::move(t));
    pipeCv.notify_all();
  }

  void waitReconPic(const Picture* p) {
    if (!parseWorkers.empty()) {
      std::unique_lock<std::mutex> lk(pipeMu);
      pipeCv.wait(lk, [&] {
        auto it = parseState.find(p);
        return it == parseState.end() || it->second == 2;
      });
    }
    if (workers.empty()) return;
    std::unique_lock<std::mutex> lk(pipeMu);
    pipeCv.wait(lk, [&] {
      auto it = reconState.find(p);
      return it == reconState.end() || it->second == 2;
    });
  }

  void drainParse() {
    if (parseWorkers.empty()) return;
    std::unique_lock<std::mutex> lk(pipeMu);
    pipeCv.wait(lk, [&] {
      if (!parseQ.empty()) return false;
      for (auto& kv : parseState)
        if (kv.second != 2) return false;
      return true;
    });
  }

  void drainRecon() {
    if (workers.empty()) return;
    std::unique_lock<std::mutex> lk(pipeMu);
    pipeCv.wait(lk, [&] {
      if (!reconQ.empty()) return false;
      for (auto& kv : reconState)
        if (kv.second != 2) return false;
      return true;
    });
  }

  ~Decoder() {
    if (!workers.empty() || !parseWorkers.empty()) {
      {
        std::lock_guard<std::mutex> lk(pipeMu);
        pipeStop = true;
      }
      pipeCv.notify_all();
      for (auto& w : parseWorkers) w.join();
      for (auto& w : workers) w.join();
    }
  }

  void finishPicture() {
    if (!cur) return;
    Picture* p = cur.get();
    const SPS& sps = spsMap[p->sps_id];
    const PPS& pps = ppsMap[p->pps_id];
    if (!pendingSlices.empty()) {
      // frame-threaded parse: submit the whole picture's slice work
      ParseTask t;
      t.pic = p;
      t.parser = std::move(parser);
      t.sps = &sps;
      t.pps = &pps;
      t.slices = std::move(pendingSlices);
      pendingSlices.clear();
      {
        std::lock_guard<std::mutex> lk(pipeMu);
        if (parseWorkers.empty()) {
          int n = parseThreads();
          for (int i = 0; i < n; i++)
            parseWorkers.emplace_back([this] { parseLoop(); });
        }
        if (reconEnabled) startReconPool();
        parseState[p] = 1;
        // recon registered before any later picture's readiness check can
        // mistake a missing entry for "done"
        if (reconEnabled) reconState[p] = 1;
        parseQ.push_back(std::move(t));
      }
      pipeCv.notify_all();
    } else if (reconEnabled) {
      if (pipelineThreads() > 1) {
        queueRecon(p, sps, pps);
      } else {
        double t0 = now();
        reconstructPicture(*p, sps, pps,
                           [this](int poc) { return findDpbPoc(poc); });
        tRecon += now() - t0;
        size_t hc = g_coefHiWater.load(std::memory_order_relaxed);
        if (p->coeffs.size() > hc)
          g_coefHiWater.store(p->coeffs.size(), std::memory_order_relaxed);
        size_t ht = g_tuHiWater.load(std::memory_order_relaxed);
        if (p->tu_list.size() > ht)
          g_tuHiWater.store(p->tu_list.size(), std::memory_order_relaxed);
        // serial mode only: with worker pools a later picture's parse may
        // still be reading this picture's arrays
        if (lowmem) p->shrinkAfterRecon();
      }
    }
    // keep a raw pointer in the DPB list for TMVP / ref bookkeeping;
    // ownership moves to `done`, DPB holds non-owning copies via shared ptrs.
    // Simpler: DPB owns; `done` records an index.
    dpb.push_back(std::move(cur));
    doneOrder.push_back(dpb.back().get());
    cur.reset();
    parser.reset();
  }
  std::vector<Picture*> doneOrder;  // decode order

  void decodeNal(const uint8_t* ebsp, size_t n) {
    if (n < 2) return;
    int nalType = (ebsp[0] >> 1) & 0x3F;
    int tid = (ebsp[1] & 7) - 1;
    std::vector<int> epbPos;
    std::vector<uint8_t> rbsp = stripEp(ebsp + 2, n - 2, &epbPos);
    if (nalType == 33) {
      // pipeline workers hold SPS/PPS pointers into the maps; a re-sent
      // parameter set overwrites the mapped value in place, so quiesce
      drainParse();
      drainRecon();
      SPS s = parseSps(rbsp.data(), rbsp.size());
      if (spsSane(s)) spsMap[s.sps_id] = s;
      return;
    }
    if (nalType == 34) {
      drainParse();
      drainRecon();
      PPS p = parsePps(rbsp.data(), rbsp.size());
      if (p.pps_id >= 0 && p.pps_id <= 63 &&
          p.sps_id >= 0 && p.sps_id <= 15)
        ppsMap[p.pps_id] = p;
      return;
    }
    if (nalType == 36) {  // EOS
      finishPicture();
      newSequence = true;
      return;
    }
    if (!isVcl(nalType)) return;

    // need pps id to parse header: peek via a throwaway header parse
    // (header parsing needs SPS/PPS; parse pps id first)
    BitReader pr; pr.init(rbsp.data(), rbsp.size());
    pr.bit();
    if (isIrap(nalType)) pr.bit();
    int ppsId = int(pr.ue());
    // corrupt-stream guards: a slice referencing an unseen parameter set
    // is dropped (the reference tolerates junk NALs the same way,
    // TDecTop.cpp:729-857)
    auto itp = ppsMap.find(ppsId);
    if (itp == ppsMap.end()) return;
    const PPS& pps = itp->second;
    auto its = spsMap.find(pps.sps_id);
    if (its == spsMap.end()) return;
    const SPS& sps = its->second;
    SliceHeader sh = parseSliceHeader(rbsp.data(), rbsp.size(), nalType, tid, sps, pps);
    if (sh.dependent) {
      // dependent segments inherit everything (incl. poc_lsb for the POC
      // derivation below) but address / entry points (Rec. 7.4.7.1)
      SliceHeader merged = lastIndepSh;
      merged.dependent = 1;
      merged.first_slice_in_pic = 0;
      merged.segment_address = sh.segment_address;
      merged.entry_points = sh.entry_points;
      merged.data_bit_offset = sh.data_bit_offset;
      sh = merged;
      sh.epb_positions = epbPos;
    } else {
      sh.epb_positions = epbPos;
      lastIndepSh = sh;
    }

    if (sh.first_slice_in_pic) finishPicture();

    // POC
    int poc;
    if (isIdr(nalType)) poc = 0;
    else {
      int maxLsb = 1 << sps.log2_max_poc_lsb;
      int prevLsb = prevTid0Poc & (maxLsb - 1);
      int prevMsb = prevTid0Poc - prevLsb;
      if (isBla(nalType) || (isIrap(nalType) && newSequence)) poc = sh.poc_lsb;
      else {
        int msb;
        if (sh.poc_lsb < prevLsb && prevLsb - sh.poc_lsb >= maxLsb / 2) msb = prevMsb + maxLsb;
        else if (sh.poc_lsb > prevLsb && sh.poc_lsb - prevLsb > maxLsb / 2) msb = prevMsb - maxLsb;
        else msb = prevMsb;
        poc = msb + sh.poc_lsb;
      }
    }
    sh.poc = poc;
    if (tid == 0 && !isRasl(nalType) && !isRadl(nalType) && !isSubNonRef(nalType))
      prevTid0Poc = poc;

    if (isIrap(nalType)) {
      noRaslOutput = isIdr(nalType) || isBla(nalType) || newSequence;
      if (sh.first_slice_in_pic) assocIrapNoRasl = noRaslOutput;
    }
    if (isRasl(nalType) && assocIrapNoRasl) return;  // skipped RASL

    if (sh.first_slice_in_pic) {
      applyRpsRetirement(sh, sps);
      cur = std::make_unique<Picture>();
      cur->init(sps);
      cur->poc = poc;
      cur->nal_type = nalType;
      cur->temporal_id = tid;
      cur->output_flag = sh.pic_output_flag;
      cur->sps_id = sps.sps_id;
      cur->pps_id = pps.pps_id;
      parser = std::make_unique<SliceParser>();
      parser->noZeroCoefSlots = reconEnabled;
      parser->sps = &sps;
      parser->pps = &pps;
      parser->pic = cur.get();
      parser->buildGeometry();
      newSequence = false;
      sliceCount = 0;
      curSliceId = 0;
      curSh = sh;
    }
    // non-first slice arriving with no open picture (corrupt stream or
    // mid-stream start before any first-slice): drop it
    if (!parser || !cur) return;
    if (sh.segment_address < 0 ||
        sh.segment_address >= sps.picSizeCtbs()) return;
    shStore.push_back(std::make_unique<SliceHeader>(sh));
    SliceHeader* shp = shStore.back().get();
    parser->poc = poc;
    if (sh.slice_type != 2) {
      buildRefLists(*parser, *shp, sps);
      parser->allRefsBefore = true;
      for (int l = 0; l < 2; l++)
        for (auto& rp : parser->refList[l])
          if (rp.poc > poc) parser->allRefsBefore = false;
      parser->colPic = nullptr;
      if (shp->temporal_mvp) {
        int cl = 1 - shp->collocated_from_l0;
        if (int(parser->refList[cl].size()) > shp->collocated_ref_idx) {
          parser->colPic = parser->refList[cl][shp->collocated_ref_idx].pic;
          parser->colPoc = parser->refList[cl][shp->collocated_ref_idx].poc;
        }
      }
    }
    if (!parsePipelined()) {
      if (!sh.first_slice_in_pic)
        dropProductsFromCtu(cur.get(), parser.get(), sps, pps,
                            sh.segment_address);
      if (!sh.dependent) curSliceId = sliceCount++;
      parser->decodeSlice(rbsp.data(), rbsp.size(), *shp, curSliceId);
    } else {
      // frame-threaded parse: defer slice data to the parse pool with a
      // snapshot of the per-slice motion-derivation context
      if (!sh.dependent) curSliceId = sliceCount++;
      SliceWork w;
      w.rbsp = std::move(rbsp);
      w.sh = shp;
      w.sliceId = curSliceId;
      w.firstInPic = sh.first_slice_in_pic != 0;
      for (int l = 0; l < 2; l++) w.refList[l] = parser->refList[l];
      w.allRefsBefore = parser->allRefsBefore;
      w.colPic = parser->colPic;
      w.colPoc = parser->colPoc;
      pendingSlices.push_back(std::move(w));
    }
  }

  // Drop parse products at CTU raster addresses >= firstCtu before a later
  // slice re-parses them.  HM's SliceMode encoder entropy-codes every slice's
  // substream to the END of the picture (TEncCu.cpp:937 only terminates at
  // the real end address) and HM's decoder re-parses / overwrites the overlap
  // in z-order (TDecCu.cpp:157).  Map-style tensors get overwritten naturally
  // (plus the per-CTU re-init in decodeSlice); the append-only product lists
  // must discard the earlier pass's overlap entries.  IntraMeta.tu_index is
  // remapped (coeff/sample pools keep orphaned data; offsets stay valid).
  void dropProductsFromCtu(Picture* pic, SliceParser* sp, const SPS& sps,
                           const PPS& pps, int firstCtu) {
    if (!pic) return;
    int lg = sps.log2_ctb, wc = sps.picWCtbs();
    int ssx = sps.ssx(), ssy = sps.ssy();
    // compare in DECODE (tile-scan) order: with tiles a later slice's
    // raster addresses can precede an earlier slice's
    std::vector<int> scanPos;
    if (pps.tiles_enabled && sp) {
      scanPos.assign(size_t(wc) * sps.picHCtbs(), 0);
      int nctu = wc * sps.picHCtbs();
      int ntiles = 0;
      for (int a = 0; a < nctu; a++)
        ntiles = std::max(ntiles, sp->tileMap[a] + 1);
      int posCtr = 0;
      for (int t = 0; t < ntiles; t++)
        for (int a = 0; a < nctu; a++)
          if (sp->tileMap[a] == t) scanPos[a] = posCtr++;
    }
    auto pos = [&](int addr) {
      return scanPos.empty() ? addr : scanPos[addr];
    };
    int firstPos = pos(firstCtu);
    auto keep = [&](int x, int y, int comp) {
      int lx = comp ? (x << ssx) : x;
      int ly = comp ? (y << ssy) : y;
      return pos((ly >> lg) * wc + (lx >> lg)) < firstPos;
    };
    std::vector<int32_t> remap(pic->tu_list.size(), -1);
    std::vector<TuMeta> tus;
    for (size_t i = 0; i < pic->tu_list.size(); i++) {
      const TuMeta& t = pic->tu_list[i];
      if (keep(t.x, t.y, t.comp)) {
        remap[i] = int32_t(tus.size());
        tus.push_back(t);
      }
    }
    pic->tu_list.swap(tus);
    std::vector<IntraMeta> ib;
    for (const IntraMeta& b : pic->intra_list)
      if (keep(b.x, b.y, b.comp)) {
        IntraMeta nb = b;
        if (nb.tu_index >= 0) nb.tu_index = remap[nb.tu_index];
        ib.push_back(nb);
      }
    pic->intra_list.swap(ib);
    std::vector<PuMeta> pus;
    for (const PuMeta& p : pic->inter_list)
      if (keep(p.x, p.y, 0)) pus.push_back(p);
    pic->inter_list.swap(pus);
    std::vector<PcmMeta> pcms;
    for (const PcmMeta& p : pic->pcm_list)
      if (keep(p.x, p.y, p.comp)) pcms.push_back(p);
    pic->pcm_list.swap(pcms);
  }
  std::vector<std::unique_ptr<SliceHeader>> shStore;

  void decodeAnnexB(const uint8_t* data, size_t n) {
    size_t i = 0;
    std::vector<std::pair<size_t, size_t>> nals;
    // find start codes
    size_t prev = SIZE_MAX;
    for (size_t p = 0; p + 2 < n; p++) {
      if (data[p] == 0 && data[p + 1] == 0 && data[p + 2] == 1) {
        if (prev != SIZE_MAX) {
          size_t e = p;
          while (e > prev && data[e - 1] == 0) e--;
          nals.push_back({prev, e});
        }
        prev = p + 3;
        p += 2;
      }
    }
    if (prev != SIZE_MAX && prev < n) nals.push_back({prev, n});
    for (auto& pr : nals) {
      if (pr.second > pr.first) {
        double t0 = now();
        decodeNal(data + pr.first, pr.second - pr.first);
        tParse += now() - t0;
      }
    }
    finishPicture();
    drainParse();
    drainRecon();
    if (getenv("HEVCDEC_TIMING"))
      fprintf(stderr,
              "hevcdec timing: main %.3fs parse-workers %.3fs recon %.3fs\n",
              tParse - tRecon, tParseW, tRecon);
    (void)i;
  }
};

}  // namespace hevc

// ===========================================================================
// C API
extern "C" {
void enc_me_stats(long long* out) { out[0]=hevc::enc::g_meCalls; out[1]=hevc::enc::g_sadCalls; out[2]=hevc::enc::g_hadCalls; out[3]=hevc::enc::g_sadPels; }

// Self-contained SIMD calibration: run the decode hot loops (8-tap MC
// filters) over a synthetic block and return elapsed seconds.  The bridge
// times the AVX2 and AVX-512 builds of this same function and loads the
// faster library: some virtualized hosts advertise AVX-512 but execute
// 512-bit code several times slower, so the choice must be measured, not
// detected (Makefile note).
double hevcdec_simd_probe(int iters) {
  static int16_t src[72 * 72];
  static int32_t mid[64 * 72];
  static int16_t dst[64 * 64];
  for (int i = 0; i < 72 * 72; i++) src[i] = int16_t((i * 1103 + 7) & 1023);
  const int f[8] = {-1, 4, -11, 40, 40, -11, 4, -1};
  struct timespec a, b;
  clock_gettime(CLOCK_MONOTONIC, &a);
  for (int it = 0; it < iters; it++) {
    for (int j = 0; j < 72; j++)
      hevc::simd::hfilt<8>(src + j * 72, 64, f, mid + (j % 72) * 64);
    for (int j = 0; j < 64; j++)
      hevc::simd::vfilt<8>(src + j * 72, 72, 64, f, mid + j * 64);
    // fold so the work isn't dead-code-eliminated
    dst[it & 4095] = int16_t(mid[it & 4095]);
  }
  clock_gettime(CLOCK_MONOTONIC, &b);
  volatile int16_t sink = dst[0];
  (void)sink;
  return (b.tv_sec - a.tv_sec) + (b.tv_nsec - a.tv_nsec) * 1e-9;
}

void* hevcdec_create() {
#ifdef __GLIBC__
  // the per-picture pools and maps run to megabytes: above glibc's default
  // mmap threshold every one is mmap'd fresh (kernel-zeroed pages) and
  // munmap'd on free.  Keep them on the heap so freed buffers recycle warm
  // from picture to picture.
  mallopt(M_MMAP_THRESHOLD, 64 << 20);
  mallopt(M_TRIM_THRESHOLD, 32 << 20);
#endif
  return new hevc::Decoder();
}
void hevcdec_enable_recon(void* h, int on) {
  static_cast<hevc::Decoder*>(h)->reconEnabled = on != 0;
  static_cast<hevc::Decoder*>(h)->lowmem = on != 0;
}
void hevcdec_destroy(void* h) { delete static_cast<hevc::Decoder*>(h); }

int hevcdec_decode(void* h, const uint8_t* data, size_t n) {
  auto* d = static_cast<hevc::Decoder*>(h);
  d->decodeAnnexB(data, n);
  return int(d->doneOrder.size());
}

// Incremental NAL-push interface (libHMDec push/bump protocol + API layer):
// feed one EBSP NAL (no start code, with 2-byte header), no implicit flush.
int hevcdec_feed(void* h, const uint8_t* ebsp, size_t n) {
  auto* d = static_cast<hevc::Decoder*>(h);
  d->decodeNal(ebsp, n);
  return int(d->doneOrder.size());
}

// Finish the currently open picture (end of stream / forced bump).
int hevcdec_flush(void* h) {
  auto* d = static_cast<hevc::Decoder*>(h);
  d->finishPicture();
  d->drainParse();
  d->drainRecon();
  return int(d->doneOrder.size());
}

// per-picture accessors (idx = decode order); block until the pipeline
// has reconstructed that picture
static hevc::Picture* P(void* h, int idx) {
  auto* d = static_cast<hevc::Decoder*>(h);
  hevc::Picture* p = d->doneOrder[idx];
  d->waitReconPic(p);
  return p;
}

void hevcdec_pic_info(void* h, int idx, int32_t* out) {
  hevc::Picture* p = P(h, idx);
  out[0] = p->poc; out[1] = p->nal_type; out[2] = p->temporal_id;
  out[3] = p->output_flag; out[4] = p->sps_id; out[5] = p->pps_id;
  out[6] = p->w4; out[7] = p->h4; out[8] = p->nctu;
  out[9] = int32_t(p->cnt_tu >= 0 ? p->cnt_tu : (long long)p->tu_list.size());
  out[10] = int32_t(p->cnt_coef >= 0 ? p->cnt_coef
                                     : (long long)p->coeffs.size());
  out[11] = int32_t(p->cnt_intra >= 0 ? p->cnt_intra
                                      : (long long)p->intra_list.size());
  out[12] = int32_t(p->cnt_inter >= 0 ? p->cnt_inter
                                      : (long long)p->inter_list.size());
  out[13] = int32_t(p->cnt_pcm >= 0 ? p->cnt_pcm
                                    : (long long)p->pcm_list.size());
  out[14] = int32_t(p->cnt_pcm_samp >= 0 ? p->cnt_pcm_samp
                                         : (long long)p->pcm_samples.size());
}

#define COPY8(name) \
  void hevcdec_get_##name(void* h, int idx, int8_t* dst) { \
    hevc::Picture* p = P(h, idx); \
    memcpy(dst, p->name.data(), p->name.size()); \
  }
COPY8(depth) COPY8(pred_mode) COPY8(part_size) COPY8(skip) COPY8(pcm)
COPY8(tq_bypass) COPY8(intra_y) COPY8(intra_c) COPY8(chroma_dm) COPY8(qp)
COPY8(cbf_y) COPY8(inter_dir) COPY8(ref_idx) COPY8(ref_is_lt)
COPY8(deblock_disable) COPY8(beta_offset) COPY8(tc_offset) COPY8(lf_across)
COPY8(sao_type) COPY8(sao_band)
#undef COPY8

void hevcdec_get_edge_flags(void* h, int idx, uint8_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->edge_flags.data(), p->edge_flags.size());
}
void hevcdec_get_mv(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->mv.data(), p->mv.size() * 4);
}
void hevcdec_get_ref_poc(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->ref_poc.data(), p->ref_poc.size() * 4);
}
void hevcdec_get_slice_idx(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->slice_idx.data(), p->slice_idx.size() * 4);
}
void hevcdec_get_sao_offsets(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->sao_offsets.data(), p->sao_offsets.size() * 4);
}
void hevcdec_get_tu_meta(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->tu_list.data(), p->tu_list.size() * sizeof(hevc::TuMeta));
}
void hevcdec_get_coeffs(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->coeffs.data(), p->coeffs.size() * 4);
}
void hevcdec_get_intra_meta(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->intra_list.data(), p->intra_list.size() * sizeof(hevc::IntraMeta));
}
void hevcdec_get_inter_meta(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->inter_list.data(), p->inter_list.size() * sizeof(hevc::PuMeta));
}
void hevcdec_get_pcm_meta(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->pcm_list.data(), p->pcm_list.size() * sizeof(hevc::PcmMeta));
}
void hevcdec_get_pcm_samples(void* h, int idx, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  memcpy(dst, p->pcm_samples.data(), p->pcm_samples.size() * 4);
}

// cropped output at native bit depth (uint8 / uint16 little-endian)
// out_info: [w, h, bytes_per_sample]
void hevcdec_output_info(void* h, int idx, int comp, int32_t* out) {
  auto* d = static_cast<hevc::Decoder*>(h);
  hevc::Picture* p = P(h, idx);
  const hevc::SPS& s = d->spsMap[p->sps_id];
  int sx = comp ? s.ssx() : 0, sy = comp ? s.ssy() : 0;
  int mulx = comp ? 1 : (1 << s.ssx());
  int muly = comp ? 1 : (1 << s.ssy());
  int w = (s.width >> sx) - (s.conf_win[0] + s.conf_win[1]) * mulx;
  int hh = (s.height >> sy) - (s.conf_win[2] + s.conf_win[3]) * muly;
  int bd = comp ? s.bit_depth_chroma : s.bit_depth_luma;
  out[0] = w; out[1] = hh; out[2] = bd <= 8 ? 1 : 2;
}
// zero-copy variant for >8-bit output: the conformance-cropped picture is
// a strided view straight into the Picture's uint16 plane (libHMDecoder.h
// exposes plane pointers the same way).  out: [ptr, stride_in_samples].
// The view stays valid until hevcdec_destroy — planes are never freed
// before that (see Picture::shrinkAtRetirement).
void hevcdec_output_view(void* h, int idx, int comp, int64_t* out) {
  auto* d = static_cast<hevc::Decoder*>(h);
  hevc::Picture* p = P(h, idx);
  const hevc::SPS& s = d->spsMap[p->sps_id];
  int sx = comp ? s.ssx() : 0, sy = comp ? s.ssy() : 0;
  int mulx = comp ? 1 : (1 << s.ssx());
  int muly = comp ? 1 : (1 << s.ssy());
  int x0 = s.conf_win[0] * mulx, y0 = s.conf_win[2] * muly;
  int64_t stride = (int64_t(s.picWCtbs()) << s.log2_ctb) >> sx;
  const hevc::Pel* base = p->plane[comp].data() + int64_t(y0) * stride + x0;
  out[0] = reinterpret_cast<int64_t>(base);
  out[1] = stride;
}

void hevcdec_get_output(void* h, int idx, int comp, uint8_t* dst) {
  auto* d = static_cast<hevc::Decoder*>(h);
  hevc::Picture* p = P(h, idx);
  const hevc::SPS& s = d->spsMap[p->sps_id];
  int sx = comp ? s.ssx() : 0, sy = comp ? s.ssy() : 0;
  int mulx = comp ? 1 : (1 << s.ssx());
  int muly = comp ? 1 : (1 << s.ssy());
  int x0 = s.conf_win[0] * mulx, y0 = s.conf_win[2] * muly;
  int w = (s.width >> sx) - (s.conf_win[0] + s.conf_win[1]) * mulx;
  int hh = (s.height >> sy) - (s.conf_win[2] + s.conf_win[3]) * muly;
  int bd = comp ? s.bit_depth_chroma : s.bit_depth_luma;
  int lg = s.log2_ctb;
  int64_t stride = (int64_t(s.picWCtbs()) << lg) >> sx;
  const hevc::Pel* src = p->plane[comp].data();
  if (bd <= 8) {
    for (int y = 0; y < hh; y++) {
      const hevc::Pel* r = src + (int64_t(y0) + y) * stride + x0;
      uint8_t* o = dst + int64_t(y) * w;
      for (int x = 0; x < w; x++) o[x] = uint8_t(r[x]);
    }
  } else {
    uint16_t* o16 = reinterpret_cast<uint16_t*>(dst);
    for (int y = 0; y < hh; y++) {
      // Pel is uint16, as the output rows are
      memcpy(o16 + int64_t(y) * w, src + (int64_t(y0) + y) * stride + x0,
             size_t(w) * 2);
    }
  }
}

void hevcdec_get_plane(void* h, int idx, int comp, int32_t* dst) {
  hevc::Picture* p = P(h, idx);
  for (size_t i = 0; i < p->plane[comp].size(); i++)
    dst[i] = p->plane[comp][i];
}
int hevcdec_plane_size(void* h, int idx, int comp) {
  return int(P(h, idx)->plane[comp].size());
}

// SPS info for a picture (geometry needed by the recon backend)
void hevcdec_sps_info(void* h, int idx, int32_t* out) {
  auto* d = static_cast<hevc::Decoder*>(h);
  hevc::Picture* p = P(h, idx);
  const hevc::SPS& s = d->spsMap[p->sps_id];
  const hevc::PPS& pp = d->ppsMap[p->pps_id];
  int i = 0;
  out[i++] = s.width; out[i++] = s.height;
  out[i++] = s.chroma_format_idc;
  out[i++] = s.bit_depth_luma; out[i++] = s.bit_depth_chroma;
  out[i++] = s.log2_ctb; out[i++] = s.log2_min_cb;
  out[i++] = s.sao_enabled; out[i++] = s.strong_intra_smoothing;
  out[i++] = s.pcm_loop_filter_disabled;
  out[i++] = s.transform_skip_rotation;
  out[i++] = s.implicit_rdpcm;
  out[i++] = s.extended_precision;
  out[i++] = s.intra_smoothing_disabled;
  out[i++] = s.pcm_enabled;
  out[i++] = s.conf_win[0]; out[i++] = s.conf_win[1];
  out[i++] = s.conf_win[2]; out[i++] = s.conf_win[3];
  out[i++] = s.num_reorder_pics[s.max_sub_layers_minus1];
  out[i++] = s.max_dec_pic_buffering[s.max_sub_layers_minus1];
  out[i++] = pp.cb_qp_offset; out[i++] = pp.cr_qp_offset;
  out[i++] = pp.loop_filter_across_tiles;
  out[i++] = pp.tiles_enabled;
  out[i++] = pp.sao_offset_scale_luma; out[i++] = pp.sao_offset_scale_chroma;
  out[i++] = pp.cross_component_prediction;
}

}  // extern "C"
