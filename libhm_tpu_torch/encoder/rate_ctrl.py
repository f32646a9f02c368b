# Copied from libhm_tpu/encoder/rate_ctrl.py
"""Full R-lambda rate control (reference TEncRateCtrl.cpp/.h).

HM's four-level model, re-implemented (not ported line-by-line) with the
same math so targets are hit the same way:

  sequence  — total bit budget, per-GOP-position bit ratios, per-frame-
              level (alpha, beta) R-lambda parameters
              (TEncRateCtrl::init, TEncRateCtrl.cpp:1192-1390;
               TEncRCSeq, TEncRateCtrl.h:97-183)
  GOP       — target bits from a 40-picture smoothing window; with
              KeepHierarchicalBit=2 the per-position ratios are re-derived
              every GOP from lambda ratios by bisection
              (TEncRCGOP::create/xEstGOPTargetBits/xSolveEqua,
               TEncRateCtrl.cpp:305-470)
  picture   — target = 0.1*buffer-share + 0.9*in-GOP share; lambda =
              alpha*bpp^beta (inter) or the MAD^1.2517 intra model;
              clipped vs the last same-level and last coded picture;
              QP = 4.2005 ln(lambda)+13.7122 with +-3/+-10 clips; model
              LMS-updated from achieved bits
              (TEncRCPic, TEncRateCtrl.cpp:495-1119)
  LCU       — remaining-budget windowed per-LCU bpp target, lambda/QP
              with +-1 neighbour and +-2 picture clips, optional separate
              per-LCU (alpha, beta)
              (getLCUTargetBpp/getLCUEstLambda/getLCUEstQP/updateAfterLCU,
               TEncRateCtrl.cpp:761-945; TEncSlice.cpp:873-975)

The intra complexity measure is HM's DC-less 8x8 Hadamard of the ORIGINAL
samples (TEncCu::xCalcHADs8x8_ISlice / updateLCUDataISlice,
TEncCu.cpp:1134-1247), vectorized here over all 8x8 blocks at once.
"""
import math

import numpy as np

# model seeds and clips (TEncRateCtrl.h:61-80)
ALPHA_I = 6.7542
BETA1 = 1.2517
BETA2 = 1.7860
ALPHA_MIN, ALPHA_MAX = 0.05, 500.0
BETA_MIN, BETA_MAX = -3.0, -0.1
SMOOTH_WINDOW = 40
LCU_SMOOTH_WINDOW = 4
W_BUFFER, W_GOP = 0.1, 0.9
INVALID_QP = -999
MAX_PIC_LIST = 32


def _clip(lo, hi, v):
    return max(lo, min(hi, v))


def _qp_from_lambda(lam):
    return int(4.2005 * math.log(lam) + 13.7122 + 0.5)


def intra_had_costs(orig_luma, width, height, ctb, bit_depth):
    """Per-LCU intra complexity: sum of DC-less 8x8 Hadamard transforms of
    the original luma, (|H|sum - |DC|, +2)>>2, bit-depth normalized
    (TEncCu::updateLCUDataISlice / xCalcHADs8x8_ISlice).

    Returns (per_lcu_costs raster list, total).
    """
    shift = bit_depth - 8
    offset = (1 << (shift - 1)) if shift > 0 else 0
    a = np.asarray(orig_luma[:height, :width], np.int64)
    h8, w8 = height >> 3, width >> 3
    if h8 == 0 or w8 == 0:
        n = -(-width // ctb) * -(-height // ctb)
        return [0] * n, 0
    blk = a[:h8 * 8, :w8 * 8].reshape(h8, 8, w8, 8).transpose(0, 2, 1, 3)
    # 8-point Hadamard along both axes (order-free butterflies == matmul
    # by the +-1 Hadamard matrix; exact in integer arithmetic)
    H = np.array([[1, 1], [1, -1]], np.int64)
    H8 = np.kron(np.kron(H, H), H)
    # match HM's butterfly output ordering is unnecessary: the sum of
    # absolute values is permutation-invariant and the DC term is the
    # all-plus row/column in any ordering
    t = np.einsum("ij,abjk,kl->abil", H8, blk, H8)
    dc = t[:, :, 0, 0].copy()
    sums = np.abs(t).sum(axis=(2, 3)) - np.abs(dc)
    had = (sums + 2) >> 2                             # per 8x8 block
    nx = -(-width // ctb)
    ny = -(-height // ctb)
    per = ctb >> 3
    costs = []
    for cy in range(ny):
        for cx in range(nx):
            b = had[cy * per:(cy + 1) * per, cx * per:(cx + 1) * per]
            costs.append(int((int(b.sum()) + offset) >> shift) if shift > 0
                         else int(b.sum()))
    return costs, sum(costs)


class _RCSeq:
    """TEncRCSeq: sequence budget + per-level model parameters."""

    def __init__(self, total_frames, target_bps, fps, gop_size, width,
                 height, ctb, keep_hier, use_lcu_model, gop_entries):
        self.total_frames = max(1, total_frames)
        self.target_bps = target_bps
        self.fps = max(1e-6, fps)
        self.gop_size = max(1, gop_size)
        self.npix = width * height
        nx = -(-width // ctb)
        ny = -(-height // ctb)
        self.n_lcu = nx * ny
        self.lcu_w, self.lcu_h = ctb, ctb
        self.pic_w, self.pic_h = width, height
        self.nx = nx

        entries = gop_entries or []
        # low-delay detection: display order monotone within the GOP
        # (TEncRateCtrl.cpp:1196-1203)
        pocs = [e.poc for e in entries] or [1]
        is_lowdelay = all(pocs[i] <= pocs[i + 1]
                          for i in range(len(pocs) - 1))
        self.is_lowdelay = is_lowdelay

        n_level = 1
        adaptive = 0
        if keep_hier > 0:
            n_level = int(math.log(self.gop_size) / math.log(2.0) + 0.5) + 1
        if not is_lowdelay and self.gop_size == 8:
            n_level = int(math.log(self.gop_size) / math.log(2.0) + 0.5) + 1
        n_level += 2                                    # intra + non-ref
        self.n_level = n_level

        # refPic flags: an entry is a reference if any entry's ref list
        # lands on its POC in some GOP repetition (the cfg reader derives
        # this the same way, TAppEncCfg.cpp:1771)
        referenced = set()
        for e in entries:
            for d in getattr(e, "ref_pics", []):
                referenced.add((e.poc + d) % self.gop_size)
        ref_flags = [(e.poc % self.gop_size) in referenced or
                     not entries for e in entries]
        while len(ref_flags) < self.gop_size:
            ref_flags.append(True)

        bits_ratio = [10 if ref_flags[i] else 2
                      for i in range(self.gop_size)]
        bpp = target_bps / (self.fps * self.npix)
        if keep_hier > 0:
            if self.gop_size == 4 and is_lowdelay:
                if bpp > 0.2:
                    bits_ratio = [2, 3, 2, 6]
                elif bpp > 0.1:
                    bits_ratio = [2, 3, 2, 10]
                elif bpp > 0.05:
                    bits_ratio = [2, 3, 2, 12]
                else:
                    bits_ratio = [2, 3, 2, 14]
                if keep_hier == 2:
                    adaptive = 1
            elif self.gop_size == 8 and not is_lowdelay:
                if bpp > 0.2:
                    bits_ratio = [15, 5, 4, 1, 1, 4, 1, 1]
                elif bpp > 0.1:
                    bits_ratio = [20, 6, 4, 1, 1, 4, 1, 1]
                elif bpp > 0.05:
                    bits_ratio = [25, 7, 4, 1, 1, 4, 1, 1]
                else:
                    bits_ratio = [30, 8, 4, 1, 1, 4, 1, 1]
                if keep_hier == 2:
                    adaptive = 2
        self.bits_ratio = bits_ratio
        self.adaptive_bits = adaptive

        g2l = [1 if (i < len(ref_flags) and ref_flags[i]) else 2
               for i in range(self.gop_size)]
        if keep_hier > 0 and self.gop_size == 4 and is_lowdelay:
            g2l = [3, 2, 3, 1]
        elif self.gop_size == 8 and not is_lowdelay:
            g2l = [1, 2, 3, 4, 4, 3, 4, 4]
        self.gopid2level = g2l

        # per-level (alpha, beta); level 0 = intra model
        self.pic_para = [[ALPHA_I, BETA2] if i == 0 else [3.2003, -1.367]
                         for i in range(n_level)]
        self.lcu_para = None
        if use_lcu_model:
            self.lcu_para = [[list(self.pic_para[i])
                              for _ in range(self.n_lcu)]
                             for i in range(n_level)]

        self.target_bits = int(target_bps * self.total_frames / self.fps)
        self.bits_left = self.target_bits
        self.frames_left = self.total_frames
        self.avg_bits_per_pic = self.target_bits // self.total_frames
        self.last_lambda = 0.0

    def left_average_bits(self):
        return int(self.bits_left / max(1, self.frames_left))

    def update_after_pic(self, bits):
        self.bits_left -= bits
        self.frames_left -= 1


class _RCGOP:
    """TEncRCGOP: one GOP's bit budget (+ adaptive ratio derivation)."""

    def __init__(self, seq, n_pic):
        self.seq = seq
        target = self._est_target_bits(seq, n_pic)
        if seq.adaptive_bits > 0 and seq.last_lambda > 0.1:
            target_bpp = target / seq.npix
            lr = [1.0] * seq.gop_size
            ll = seq.last_lambda
            if seq.adaptive_bits == 1:          # low delay, GOP 4
                if ll < 120.0:
                    lr[1] = 0.725 * math.log(ll) + 0.5793
                    lr[0] = 1.3 * lr[1]
                    lr[2] = 1.3 * lr[1]
                    lr[3] = 1.0
                else:
                    lr = [5.0, 4.0, 5.0, 1.0]
            elif seq.adaptive_bits == 2:        # random access, GOP 8
                if ll < 90.0:
                    r = 0.725 * math.log(ll) + 0.7963
                    lr = [1.0, r, 1.3 * r, 3.25 * r, 3.25 * r,
                          1.3 * r, 3.25 * r, 3.25 * r]
                else:
                    lr = [1.0, 4.0, 5.0, 12.3, 12.3, 5.0, 12.3, 12.3]
            ca, cb = [], []
            for i in range(seq.gop_size):
                lvl = seq.gopid2level[i]
                a, b = seq.pic_para[lvl]
                # the reference's 0.725*log(lastLambda)+c ratio formula
                # goes NEGATIVE for lastLambda < ~0.45 (very high rates);
                # pow(negative, 1/beta) is NaN/UB in the reference
                # (TEncRateCtrl.cpp:319,393) — clamp to the defined
                # domain so the bisection stays meaningful
                ratio = max(0.01, lr[i])
                ca.append((1.0 / a) ** (1.0 / b) * ratio ** (1.0 / b))
                cb.append(1.0 / b)
            lam = self._solve(target_bpp, ca, cb)
            seq.bits_ratio = [
                int(ca[i] * lam ** cb[i] * seq.npix)
                for i in range(seq.gop_size)]
        self.n_pic = n_pic
        total_ratio = sum(seq.bits_ratio[i] for i in range(n_pic)) or 1
        self.pic_target_in_gop = [
            int(target * seq.bits_ratio[i] / total_ratio)
            for i in range(n_pic)]
        self.target_bits = target
        self.pic_left = n_pic
        self.bits_left = target

    @staticmethod
    def _est_target_bits(seq, gop_size):
        window = min(SMOOTH_WINDOW, seq.frames_left)
        avg = seq.target_bits // seq.total_frames
        cur = int((seq.bits_left - avg * (seq.frames_left - window))
                  / window)
        return max(200, cur * gop_size)

    @staticmethod
    def _solve(target_bpp, ca, cb):
        sol, lo, hi = 100.0, 0.1, 10000.0
        for _ in range(20):
            fx = sum(a * sol ** b for a, b in zip(ca, cb))
            if abs(fx - target_bpp) < 1e-6:
                break
            if fx > target_bpp:
                lo, sol = sol, (sol + hi) / 2.0
            else:
                hi, sol = sol, (sol + lo) / 2.0
        return _clip(0.1, 10000.0, sol)

    def update_after_picture(self, bits):
        self.bits_left -= bits
        self.pic_left -= 1


class _RCPic:
    """TEncRCPic: one picture's target, lambda/QP estimation, LCU budget."""

    def __init__(self, seq, gop, frame_level, prev_pics):
        self.seq = seq
        self.gop = gop
        self.frame_level = frame_level
        target = self._est_target_bits(seq, gop)
        header_bits = self._est_header_bits(prev_pics, frame_level)
        if target < header_bits + 100:
            target = header_bits + 100
        self.target_bits = target
        self.est_header_bits = header_bits
        self.npix = seq.npix
        self.n_lcu = seq.n_lcu
        self.est_pic_lambda = 100.0
        self.est_qp = 0
        self.bits_left = target - header_bits
        self.pixels_left = seq.npix
        self.lcu_left = seq.n_lcu
        self.lcu_coded = 0
        # per-LCU state: [actual_bits, qp, target_bits, lambda, bit_weight,
        #                 n_pixels, cost_intra, target_bits_left]
        nx = seq.nx
        ny = seq.n_lcu // nx
        self.lcus = []
        for idx in range(seq.n_lcu):
            i, j = idx % nx, idx // nx
            w = seq.pic_w - seq.lcu_w * (nx - 1) if i == nx - 1 else seq.lcu_w
            h = seq.pic_h - seq.lcu_h * (ny - 1) if j == ny - 1 else seq.lcu_h
            self.lcus.append({"bits": 0, "qp": 0, "target": 0,
                              "lambda": 0.0, "weight": 1.0, "npix": w * h,
                              "cost_i": 0.0, "target_left": 0})
        self.total_cost_intra = 0.0
        self.remaining_cost_intra = 0.0
        self.pic_qp = 0
        self.pic_lambda = 0.0
        self.pic_actual_bits = 0
        self.pic_actual_header_bits = 0

    @staticmethod
    def _est_target_bits(seq, gop):
        pos = gop.n_pic - gop.pic_left
        cur_ratio = seq.bits_ratio[pos % seq.gop_size]
        total_ratio = sum(seq.bits_ratio[i % seq.gop_size]
                          for i in range(pos, gop.n_pic)) or 1
        target = int(gop.bits_left * cur_ratio / total_ratio)
        target = max(100, target)
        if seq.frames_left > 16:
            target = int(W_BUFFER * target +
                         W_GOP * gop.pic_target_in_gop[pos])
        return target

    @staticmethod
    def _est_header_bits(prev_pics, frame_level):
        hdr = [p.pic_actual_header_bits for p in prev_pics
               if p.frame_level == frame_level]
        return sum(hdr) // len(hdr) if hdr else 0

    # ---- intra complexity (calCostSliceI analogue) ----
    def set_intra_costs(self, costs, total):
        for lcu, c in zip(self.lcus, costs):
            lcu["cost_i"] = float(c)
        self.total_cost_intra = float(total)

    def refine_bits_for_intra(self, org_bits):
        # TEncRCPic::getRefineBitsForIntra (TEncRateCtrl.cpp:1071-1088)
        alpha = 0.25 if org_bits * 40 < self.npix else 0.30
        return int(alpha * (self.total_cost_intra * 4.0 /
                            max(1, org_bits)) ** 0.5582 * org_bits + 0.5)

    def init_lcu_target_bits(self):
        # getLCUInitTargetBits (TEncRateCtrl.cpp:1108-1118)
        self.remaining_cost_intra = self.total_cost_intra
        avg = 0
        for lcu in reversed(self.lcus):
            avg += int(self.target_bits * lcu["cost_i"] /
                       max(1e-9, self.total_cost_intra))
            lcu["target_left"] = avg

    # ---- picture-level lambda / QP ----
    def estimate_pic_lambda(self, prev_pics, is_intra):
        a, b = self.seq.pic_para[self.frame_level]
        bpp = self.target_bits / self.npix
        if is_intra:
            mad = (self.total_cost_intra / self.npix) ** BETA1
            lam = (a / 256.0) * (mad / max(1e-9, bpp)) ** b
        else:
            lam = a * bpp ** b
        last_level = last_pic = last_valid = -1.0
        for p in prev_pics:
            if p.frame_level == self.frame_level:
                last_level = p.pic_lambda
            last_pic = p.pic_lambda
            if last_pic > 0.0:
                last_valid = last_pic
        if last_level > 0.0:
            ll = _clip(0.1, 10000.0, last_level)
            lam = _clip(ll * 2.0 ** (-1.0), ll * 2.0, lam)
        if last_pic > 0.0:
            lp = _clip(0.1, 2000.0, last_pic)
            lam = _clip(lp * 2.0 ** (-10.0 / 3), lp * 2.0 ** (10.0 / 3), lam)
        elif last_valid > 0.0:
            lv = _clip(0.1, 2000.0, last_valid)
            lam = _clip(lv * 2.0 ** (-10.0 / 3), lv * 2.0 ** (10.0 / 3), lam)
        else:
            lam = _clip(0.1, 10000.0, lam)
        lam = max(lam, 0.1)
        self.est_pic_lambda = lam
        # initial per-LCU bit weights (TEncRateCtrl.cpp:691-720)
        total_w = 0.0
        for i, lcu in enumerate(self.lcus):
            if self.seq.lcu_para is not None:
                al, bl = self.seq.lcu_para[self.frame_level][i]
            else:
                al, bl = a, b
            w = lcu["npix"] * (lam / al) ** (1.0 / bl)
            lcu["weight"] = max(w, 0.01)
            total_w += lcu["weight"]
        for lcu in self.lcus:
            lcu["weight"] = self.target_bits * lcu["weight"] / total_w
        return lam

    def estimate_pic_qp(self, lam, prev_pics):
        qp = _qp_from_lambda(lam)
        last_level = last_pic = last_valid = INVALID_QP
        for p in prev_pics:
            if p.frame_level == self.frame_level:
                last_level = p.pic_qp
            last_pic = p.pic_qp
            if last_pic > INVALID_QP:
                last_valid = last_pic
        if last_level > INVALID_QP:
            qp = _clip(last_level - 3, last_level + 3, qp)
        if last_pic > INVALID_QP:
            qp = _clip(last_pic - 10, last_pic + 10, qp)
        elif last_valid > INVALID_QP:
            qp = _clip(last_valid - 10, last_valid + 10, qp)
        return qp

    # ---- LCU level ----
    def lcu_target_bpp(self, is_intra):
        idx = self.lcu_coded
        lcu = self.lcus[idx]
        if is_intra:
            left = self.n_lcu - idx + 1
            window = min(4, left)
            mad = lcu["cost_i"]
            if self.remaining_cost_intra > 0.1:
                w_bits_left = (self.bits_left * window +
                               (self.bits_left - lcu["target_left"]) *
                               left) / window
                avg = int(mad * w_bits_left / self.remaining_cost_intra)
            else:
                avg = int(self.bits_left / max(1, self.lcu_left))
            self.remaining_cost_intra -= mad
        else:
            total_w = sum(l["weight"] for l in self.lcus[idx:])
            window = min(LCU_SMOOTH_WINDOW, self.lcu_left)
            avg = int(lcu["weight"] -
                      (total_w - self.bits_left) / window + 0.5)
        avg = max(1, avg)
        lcu["target"] = avg
        return avg / lcu["npix"]

    def lcu_est_lambda(self, bpp):
        idx = self.lcu_coded
        if self.seq.lcu_para is not None:
            a, b = self.seq.lcu_para[self.frame_level][idx]
        else:
            a, b = self.seq.pic_para[self.frame_level]
        lam = a * bpp ** b
        neigh = -1.0
        for i in range(idx - 1, -1, -1):
            if self.lcus[i]["lambda"] > 0:
                neigh = self.lcus[i]["lambda"]
                break
        if neigh > 0.0:
            lam = _clip(neigh * 2.0 ** (-1.0 / 3), neigh * 2.0 ** (1.0 / 3),
                        lam)
        if self.est_pic_lambda > 0.0:
            lam = _clip(self.est_pic_lambda * 2.0 ** (-2.0 / 3),
                        self.est_pic_lambda * 2.0 ** (2.0 / 3), lam)
        else:
            lam = _clip(10.0, 1000.0, lam)
        return max(lam, 0.1)

    def lcu_est_qp(self, lam, pic_qp):
        idx = self.lcu_coded
        qp = _qp_from_lambda(lam)
        neigh = INVALID_QP
        for i in range(idx - 1, -1, -1):
            if self.lcus[i]["qp"] > INVALID_QP:
                neigh = self.lcus[i]["qp"]
                break
        if neigh > INVALID_QP:
            qp = _clip(neigh - 1, neigh + 1, qp)
        return _clip(pic_qp - 2, pic_qp + 2, qp)

    def lcu_est_lambda_and_qp_intra(self, bpp, pic_qp):
        # getLCUEstLambdaAndQP (TEncRateCtrl.cpp:1120-1165)
        idx = self.lcu_coded
        a, b = self.seq.pic_para[self.frame_level]
        cpp = (self.lcus[idx]["cost_i"] / self.lcus[idx]["npix"]) ** BETA1
        lam = (a / 256.0) * (cpp / max(1e-9, bpp)) ** b
        neigh = INVALID_QP
        for i in range(idx - 1, -1, -1):
            if self.lcus[i]["qp"] > INVALID_QP:
                neigh = self.lcus[i]["qp"]
                break
        min_qp, max_qp = pic_qp - 2, pic_qp + 2
        if neigh > INVALID_QP:
            max_qp = min(neigh + 1, max_qp)
            min_qp = max(neigh - 1, min_qp)
        max_l = math.exp((max_qp + 0.49 - 13.7122) / 4.2005)
        min_l = math.exp((min_qp - 0.49 - 13.7122) / 4.2005)
        lam = _clip(min_l, max_l, lam)
        qp = _clip(min_qp, max_qp, _qp_from_lambda(lam))
        return lam, qp

    def update_after_lcu(self, idx, bits, qp, lam, update_model):
        lcu = self.lcus[idx]
        lcu["bits"] = bits
        lcu["qp"] = qp
        lcu["lambda"] = lam
        self.lcu_left -= 1
        self.bits_left -= bits
        self.pixels_left -= lcu["npix"]
        self.lcu_coded += 1
        if not update_model or self.seq.lcu_para is None:
            return
        a, b = self.seq.lcu_para[self.frame_level][idx]
        bpp = bits / lcu["npix"]
        cal = a * bpp ** b if bpp > 0 else 0.0
        if lam < 0.01 or cal < 0.01 or bpp < 0.0001:
            a *= 1.0 - 0.1 / 2.0
            b *= 1.0 - 0.05 / 2.0
        else:
            cal = _clip(lam / 10.0, lam * 10.0, cal)
            a += 0.1 * (math.log(lam) - math.log(cal)) * a
            lnbpp = _clip(-5.0, -0.1, math.log(bpp))
            b += 0.05 * (math.log(lam) - math.log(cal)) * lnbpp
        self.seq.lcu_para[self.frame_level][idx] = [
            _clip(ALPHA_MIN, ALPHA_MAX, a), _clip(BETA_MIN, BETA_MAX, b)]

    # ---- after-picture model update ----
    def update_after_picture(self, header_bits, total_bits, avg_qp,
                             avg_lambda, is_intra):
        self.pic_actual_header_bits = header_bits
        self.pic_actual_bits = total_bits
        self.pic_qp = int(avg_qp + 0.5) if avg_qp > 0 else INVALID_QP
        self.pic_lambda = avg_lambda
        a, b = self.seq.pic_para[self.frame_level]
        if is_intra:
            lnbpp = math.log((max(1e-9, self.total_cost_intra) /
                              self.npix) ** BETA1)
            diff = b * (math.log(max(1, total_bits)) -
                        math.log(max(1, self.target_bits)))
            diff = _clip(-0.125, 0.125, 0.25 * diff)
            a *= math.exp(diff)
            if abs(lnbpp) > 1e-9:
                b += diff / lnbpp
        else:
            bpp = total_bits / self.npix
            cal = a * bpp ** b if bpp > 0 else 0.0
            lam = self.pic_lambda
            if lam < 0.01 or cal < 0.01 or bpp < 0.0001:
                a *= 1.0 - 0.1 / 2.0
                b *= 1.0 - 0.05 / 2.0
            else:
                cal = _clip(lam / 10.0, lam * 10.0, cal)
                a += 0.1 * (math.log(lam) - math.log(cal)) * a
                lnbpp = _clip(-5.0, -0.1, math.log(bpp))
                b += 0.05 * (math.log(lam) - math.log(cal)) * lnbpp
        self.seq.pic_para[self.frame_level] = [
            _clip(ALPHA_MIN, ALPHA_MAX, a), _clip(BETA_MIN, BETA_MAX, b)]
        if self.frame_level == 1:
            cur = _clip(0.1, 10000.0, self.pic_lambda)
            self.seq.last_lambda = 0.5 * self.seq.last_lambda + 0.5 * cur

    def average_qp_lambda(self):
        qps = [l["qp"] for l in self.lcus if l["qp"] > 0]
        lams = [math.log(l["lambda"]) for l in self.lcus
                if l["lambda"] > 0.01]
        avg_qp = sum(qps) / len(qps) if qps else INVALID_QP
        avg_lam = math.exp(sum(lams) / len(lams)) if lams else -1.0
        return avg_qp, avg_lam


class RateControl:
    """Facade the encoder drives (TEncRateCtrl + the TEncGOP/TEncSlice
    call protocol, TEncGOP.cpp:1066-1117, TEncSlice.cpp:873-975).

    Protocol per picture, in coding order:
        qp, lam = rc.start_picture(gop_id, is_intra, orig_luma)
        ... per CTU (raster):  qp, lam = rc.lcu_start(is_intra)
                               rc.lcu_end(bits, qp, lam, effective)
        rc.end_picture(header_bits, total_bits, is_intra)
    GOP boundaries are by received-picture count (first GOP = the solo
    IDR, then gop_size per GOP), exactly TEncTop::encode's delivery.
    """
    lcu_level = True   # encoder keys per-LCU dQP signalling off this

    def __init__(self, target_bps, fps, width, height, total_frames,
                 gop_entries=None, gop_size=1, ctb=64, bit_depth=8,
                 keep_hier=0, lcu_rc=True, lcu_separate=True,
                 initial_qp=0, force_intra_qp=False, intra_period=-1):
        self.seq = _RCSeq(total_frames, target_bps, fps, gop_size, width,
                          height, ctb, keep_hier, lcu_separate and lcu_rc,
                          gop_entries)
        self.gop = None
        self.pic = None
        self.pic_list = []
        self.ctb = ctb
        self.bit_depth = bit_depth
        self.lcu_rc = lcu_rc
        self.initial_qp = initial_qp
        self.force_intra_qp = force_intra_qp
        self.intra_period = intra_period
        self._received = 0
        self._gop_left = 0

    # -- GOP grouping by delivery count (TEncTop.cpp:343-383) --
    def _maybe_new_gop(self):
        if self._gop_left == 0:
            remaining = self.seq.total_frames - self._received
            n = 1 if self._received == 0 else \
                min(self.seq.gop_size, remaining)
            self.gop = _RCGOP(self.seq, max(1, n))
            self._gop_left = max(1, n)

    def start_picture(self, gop_id, is_intra, orig_luma=None):
        """Returns (slice_qp, slice_lambda)."""
        self._maybe_new_gop()
        level = 0 if is_intra else \
            self.seq.gopid2level[gop_id % self.seq.gop_size]
        self.pic = _RCPic(self.seq, self.gop, level, self.pic_list)
        self._is_intra = is_intra
        if (self._received == 0 and self.initial_qp > 0) or \
                (is_intra and self.force_intra_qp and self.initial_qp > 0):
            qp = self.initial_qp
            nb = self.seq.gop_size - 1
            scale = 1.0 - _clip(0.0, 0.5, 0.05 * nb)
            lam = 0.57 * scale * 2.0 ** ((qp - 12) / 3.0)
        elif is_intra:
            if orig_luma is not None:
                costs, total = intra_had_costs(
                    orig_luma, self.seq.pic_w, self.seq.pic_h, self.ctb,
                    self.bit_depth)
                self.pic.set_intra_costs(costs, total)
            if self.intra_period != 1:
                bits = self.pic.refine_bits_for_intra(
                    self.seq.left_average_bits())
                self.pic.target_bits = max(200, bits)
            self.pic.init_lcu_target_bits()
            lam = self.pic.estimate_pic_lambda(self.pic_list, True)
            qp = self.pic.estimate_pic_qp(lam, self.pic_list)
        else:
            lam = self.pic.estimate_pic_lambda(self.pic_list, False)
            qp = self.pic.estimate_pic_qp(lam, self.pic_list)
        qp = _clip(0, 51, qp)
        self.pic.est_qp = qp
        self._pic_qp = qp
        self._pic_lambda = lam
        return qp, lam

    # -- per-LCU (TEncSlice.cpp:873-975) --
    def lcu_start(self, forced_fixed=False):
        """Returns (est_qp, est_lambda) for the next LCU in raster order;
        lambda is None when LCU-level RC is off / forced fixed QP."""
        if not self.lcu_rc or forced_fixed:
            return self._pic_qp, None
        bpp = self.pic.lcu_target_bpp(self._is_intra)
        if self._is_intra:
            lam, qp = self.pic.lcu_est_lambda_and_qp_intra(bpp,
                                                           self._pic_qp)
        else:
            lam = self.pic.lcu_est_lambda(bpp)
            qp = self.pic.lcu_est_qp(lam, self._pic_qp)
        return _clip(0, 51, qp), lam

    def lcu_end(self, bits, qp, lam, effective=True):
        self.pic.update_after_lcu(
            self.pic.lcu_coded, bits, qp if effective else INVALID_QP,
            lam, update_model=(not self._is_intra) and self.lcu_rc)

    # -- after picture --
    def end_picture(self, header_bits, total_bits):
        avg_qp, avg_lam = self.pic.average_qp_lambda()
        if avg_lam <= 0:
            avg_lam = self._pic_lambda
        if avg_qp <= 0:
            avg_qp = self._pic_qp
        self.pic.update_after_picture(header_bits, total_bits, avg_qp,
                                      avg_lam, self._is_intra)
        self.pic_list.append(self.pic)
        if len(self.pic_list) > MAX_PIC_LIST:
            self.pic_list.pop(0)
        self.seq.update_after_pic(total_bits)
        self.gop.update_after_picture(total_bits)
        self._gop_left -= 1
        self._received += 1
