# Copied from libhm_tpu/encoder/options.py
"""HM-compatible configuration system.

Replaces the reference's df::program_options_lite + TAppEncCfg option
registry (reference: source/Lib/TAppCommon/program_options_lite.h:46-150,
source/App/TAppEncoder/TAppEncCfg.cpp): `Key : value  # comment` config
files, `-c file.cfg` stacking with later-wins override, the `FrameN:`
GOP-table mini-DSL, and CLI `--Key=value` overrides — so the standard
`cfg/encoder_*.cfg` ladder drives this encoder directly.
"""
from dataclasses import dataclass, field


@dataclass
class GOPEntry:
    """One FrameN line (reference TEncCfg.h GOPEntry)."""
    slice_type: str = "B"      # 'I' | 'P' | 'B'
    poc: int = 0
    qp_offset: int = 0
    qp_factor: float = 1.0
    tc_offset_div2: int = 0
    beta_offset_div2: int = 0
    temporal_id: int = 0
    num_ref_pics_active: int = 0
    num_ref_pics: int = 0
    ref_pics: list = field(default_factory=list)   # delta POCs
    inter_rps_pred: int = 0
    delta_rps: int = 0
    # (the #ref_idcs / reference-idcs inter-RPS coding hints are accepted
    # but unused: this encoder always writes explicit slice-header RPSs)


def parse_gop_entry(text: str) -> GOPEntry:
    t = text.split()
    e = GOPEntry()
    e.slice_type = t[0]
    e.poc = int(t[1])
    e.qp_offset = int(t[2])
    e.qp_factor = float(t[3])
    e.tc_offset_div2 = int(t[4])
    e.beta_offset_div2 = int(t[5])
    e.temporal_id = int(t[6])
    e.num_ref_pics_active = int(t[7])
    e.num_ref_pics = int(t[8])
    e.ref_pics = [int(v) for v in t[9:9 + e.num_ref_pics]]
    rest = t[9 + e.num_ref_pics:]
    if rest:
        e.inter_rps_pred = int(rest[0])
        if e.inter_rps_pred and len(rest) > 1:
            e.delta_rps = int(rest[1])
    return e


def parse_cfg_text(text: str, into=None):
    """Parse one cfg file's text into {key: string_value} (later wins)."""
    opts = into if into is not None else {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if ":" not in line:
            continue
        key, val = line.split(":", 1)
        opts[key.strip()] = val.strip()
    return opts


def parse_cfg_files(paths, overrides=()):
    """Stack config files then `Key=value` CLI overrides (later wins)."""
    opts = {}
    for p in paths:
        parse_cfg_text(open(p).read(), opts)
    for ov in overrides:
        if "=" in ov:
            k, v = ov.split("=", 1)
            opts[k.strip().lstrip("-")] = v.strip()
    return opts


# ---------------------------------------------------------------------------
_BOOL_KEYS = {
    "SAO": "sao", "RDOQ": "rdoq", "SignHideFlag": "sign_hiding",
    "AMP": "amp", "TransformSkip": "transform_skip",
    "TransquantBypassEnableFlag": "transquant_bypass",
    "CUTransquantBypassFlagForce": "lossless",
    "HadamardME": "hadamard_me",
    "WeightedPredP": "weighted_pred", "WeightedPredB": "weighted_bipred",
    "TemporalMvp": "tmvp", "TMVPMode": "tmvp",
    "StrongIntraSmoothing": "strong_intra_smoothing",
    "PCMEnabledFlag": "pcm_enabled",
    "PCMFilterDisableFlag": "pcm_filter_disabled",
    "IntraConstraintFlag": "intra_constraint",
    "SAOLcuBoundary": None, "UseAdaptiveQP": "adaptive_qp",
    "WaveFrontSynchro": "wpp", "ECU": None, "CFM": None, "ESD": None,
    "FEN": "fast_enc", "FDM": None, "AdaptiveQP": "adaptive_qp",
    "CabacInitFlag": "cabac_init",
    "LFCrossSliceBoundaryFlag": "lf_cross_slices",
    "LFCrossTileBoundaryFlag": "lf_cross_tiles",
    "LCULevelRateControl": "rc_lcu_level",
    "RCLCUSeparateModel": "rc_lcu_separate",
    "RCForceIntraQP": "rc_force_intra_qp",
    "FieldCoding": "field_coding",
    "VuiParametersPresent": "vui_enabled",
    "SEIActiveParameterSets": "sei_aps",
    "SEIBufferingPeriod": "hrd_enabled",
    "SEIPictureTiming": "hrd_enabled",
    "SEIDecodedPictureHash": "hash_sei",
}

_INT_KEYS = {
    "SourceWidth": "width", "SourceHeight": "height", "QP": "qp",
    "ChromaFormatIDC": "chroma_fmt",
    "ScalingList": "scaling_list",
    "InternalBitDepth": "bit_depth", "InputBitDepth": "input_bit_depth",
    "FrameRate": "fps", "FramesToBeEncoded": "frames",
    "FrameSkip": "frame_skip",
    "IntraPeriod": "intra_period", "DecodingRefreshType": "refresh_type",
    "GOPSize": "gop_size", "MaxCUWidth": "cu_size",
    "MaxPartitionDepth": "max_part_depth",
    "QuadtreeTULog2MaxSize": "log2_max_tb",
    "QuadtreeTULog2MinSize": "log2_min_tb",
    "QuadtreeTUMaxDepthInter": "tu_depth_inter",
    "QuadtreeTUMaxDepthIntra": "tu_depth_intra",
    "SearchRange": "search_range", "FastSearch": "fast_search",
    "BipredSearchRange": "bipred_search_range",
    "MaxNumMergeCand": "max_merge_cand",
    "TargetBitrate": "rate_bps", "RateControl": "rate_control",
    "KeepHierarchicalBit": "rc_keep_hier", "InitialQP": "rc_initial_qp",
    "SliceMode": "slice_mode", "SliceArgument": "slice_argument",
    "NumTileColumnsMinus1": "tile_cols_minus1",
    "NumTileRowsMinus1": "tile_rows_minus1",
    "LoopFilterDisable": "deblock_disable",
    "LoopFilterBetaOffset_div2": "beta_offset_div2",
    "LoopFilterTcOffset_div2": "tc_offset_div2",
    "MaxBytesPerPicDenom": None, "MaxBitsPerMinCuDenom": None,
    "CbQpOffset": "cb_qp_offset", "CrQpOffset": "cr_qp_offset",
    "PCMLog2MinSize": "log2_min_ipcm", "PCMLog2MaxSize": "log2_max_ipcm",
}

_STR_KEYS = {
    "InputFile": "input_file", "BitstreamFile": "bitstream_file",
    "ReconFile": "recon_file", "Profile": "profile",
    "ScalingListFile": "scaling_list_file",
    "Level": "level", "Tier": "tier",
    "TileColumnWidthArray": "tile_col_widths",
    "TileRowHeightArray": "tile_row_heights",
    "ColumnWidthArray": "tile_col_widths",
    "RowHeightArray": "tile_row_heights",
}

# Accepted-but-inert keys (reference TAppEncCfg registers them; they do
# not change the bitstream this encoder produces).  Each carries the
# reason it is inert — IO-path-only, encoder-speed heuristic, or analyzer
# output control.  They are recorded in HmConfig.inert for transparency.
_INERT_KEYS = {
    "ConformanceMode": "source padding mode; sizes are already min-CU "
                       "aligned or handled by boundary splitting",
    "InputColourSpaceConvert": "source-IO colour conversion only",
    "SNRInternalColourSpace": "PSNR reporting colour space only",
    "OutputInternalColourSpace": "recon-output IO only",
    "MSBExtendedBitDepth": "source-IO bit-depth staging only",
    "InputChromaFormat": "source chroma staging; ChromaFormatIDC/profile "
                         "sets the coded format",
    "TransformSkipFast": "encoder speed heuristic (no syntax impact)",
    "DeblockingFilterMetric": "encoder-side deblock auto-metric heuristic",
    "DeblockingFilterControlPresent": "deblock params are signalled "
                                      "in-PPS either way",
    "LoopFilterOffsetInPPS": "offsets carried in PPS by default here",
    "PCMInputBitDepthFlag": "PCM samples coded at internal depth",
    "FrameFieldInfoPresentFlag": "implied by FieldCoding (pic-timing SEI)",
    "TopFieldFirst": "field order fixed top-first in the field path",
    "TileUniformSpacing": "honoured with the width/height arrays",
    "UniformSpacingIdc": "honoured with the width/height arrays",
    "MaxCUHeight": "CTUs are square; MaxCUWidth sets the size (HM's "
                   "standard cfgs always keep them equal)",
    "RDOQTS": "RDOQ applies to transform-skip blocks when both are on",
}

# Encoder-choice tool enables (reference TAppEncCfg): turning a tool ON
# permits the encoder's RD to use it; an encoder whose search does not
# exercise the tool still produces conformant streams (the reference
# behaves the same when its RD never picks a tool).  Accepted and
# recorded in .inert so the classification is visible.
_TOOL_ENABLE_KEYS = {
    "CrossComponentPrediction": "CCP is an RD choice; not exercised",
    "ExtendedPrecision": "RExt extended precision not used at <=10 bit",
    "GolombRiceParameterAdaptation": "Rice adaptation not signalled",
    "AlignCABACBeforeBypass": "HT bypass alignment not signalled",
    "ImplicitResidualDPCM": "implicit RDPCM not exercised",
    "ExplicitResidualDPCM": "explicit RDPCM not exercised",
    "ResidualRotation": "residual rotation not signalled",
    "SingleSignificanceMapContext": "single sig-ctx mode not signalled",
    "HighPrecisionPredictionWeighting": "high-precision WP not signalled",
    "IntraReferenceSmoothing": "ref smoothing kept enabled (spec default)",
    "TransformSkipLog2MaxSize": "TS used at 4x4 only (spec default)",
    "MaxCuDQPDepth": "delta-QP granularity is one QG per CTU here",
    "MaxDeltaQP": "encoder-side QP search width",
    "DeltaQpRD": "encoder-side multi-QP RD sweep",
}

# Requests the produced bitstream could NOT satisfy: explicitly rejected
# (UnsupportedToolError), never silently dropped.  (Currently only the
# non-uniform tile-spacing check in to_encoder_config; kept as a table so
# future rejects stay centralized.)
_GUARDED_KEYS = {}


class UnsupportedToolError(ValueError):
    """A cfg requests a tool this encoder cannot emit syntax for — the
    explicit rejection path (options are never silently dropped)."""


class HmConfig:
    """Decoded view of an HM cfg option dict.

    Every key of the reference cfg corpus (cfg/**, incl. misc/ and
    per-sequence/) is classified: honoured (mapped to an encoder setting),
    inert (accepted with a documented reason, `.inert`), or guarded
    (accepted at the default value, UnsupportedToolError otherwise — the
    explicit-rejection path).  With strict=True a truly unknown key
    raises instead of landing in `.ignored`."""

    def __init__(self, opts, strict=False):
        self.opts = opts
        self.ignored = []
        self.inert = {}
        self.guarded = {}
        self.gop_entries = []
        vals = {}
        for key, sval in opts.items():
            if sval == "" and not (key.startswith("Frame")
                                   and key[5:].isdigit()):
                continue   # blank value = unset (HM treats it as default)
            if key.startswith("Frame") and key[5:].isdigit():
                idx = int(key[5:])
                while len(self.gop_entries) < idx:
                    self.gop_entries.append(None)
                self.gop_entries[idx - 1] = parse_gop_entry(sval)
            elif key in _INT_KEYS:
                if _INT_KEYS[key]:
                    vals[_INT_KEYS[key]] = int(float(sval))
            elif key in _BOOL_KEYS:
                if _BOOL_KEYS[key]:
                    vals[_BOOL_KEYS[key]] = bool(int(sval))
            elif key in _STR_KEYS:
                vals[_STR_KEYS[key]] = sval
            elif key in _GUARDED_KEYS:
                self.guarded[key] = sval
            elif key in _TOOL_ENABLE_KEYS:
                self.inert[key] = _TOOL_ENABLE_KEYS[key]
            elif key in _INERT_KEYS:
                self.inert[key] = _INERT_KEYS[key]
            elif strict:
                raise KeyError(f"unknown cfg option: {key}")
            else:
                self.ignored.append(key)
        self.v = vals

    def _check_guarded(self):
        for key, sval in self.guarded.items():
            default, what = _GUARDED_KEYS[key]
            raise UnsupportedToolError(f"{key}={sval}: {what}")

    def get(self, name, default=None):
        return self.v.get(name, default)

    def to_encoder_config(self):
        """Build an EncoderConfig + GOP table for the encoder.

        Raises UnsupportedToolError when the cfg requests a tool toggle
        this encoder cannot emit syntax for (never silently drops it)."""
        from .encoder import EncoderConfig
        self._check_guarded()
        v = self.v
        bit_depth = v.get("bit_depth", 8)
        profile = v.get("profile", "main")
        chroma = 1
        if "422" in profile:
            chroma = 2
        elif "444" in profile:
            chroma = 3
        # explicit ChromaFormatIDC overrides the profile inference
        # (reference TAppEncCfg tmpChromaFormat: 400/420/422/444)
        if "chroma_fmt" in v:
            chroma = {400: 0, 420: 1, 422: 2, 444: 3}.get(
                v["chroma_fmt"], chroma)
        cu = v.get("cu_size", 64)
        cfg = EncoderConfig(
            v.get("width", 0), v.get("height", 0), qp=v.get("qp", 32),
            bit_depth=bit_depth, cu_size=cu,
            gop="table", search_range=v.get("search_range", 64),
            fps=float(v.get("fps", 30)), chroma_format_idc=chroma,
            weighted_pred=v.get("weighted_pred", False),
            rdoq=v.get("rdoq", True), sign_hiding=v.get("sign_hiding", True),
            adaptive_qp=v.get("adaptive_qp", False), amp=v.get("amp", True))
        cfg.gop_entries = [e for e in self.gop_entries if e is not None]
        cfg.gop_size = v.get("gop_size", 1)
        cfg.intra_period = v.get("intra_period", -1)
        cfg.refresh_type = v.get("refresh_type", 0)
        cfg.sao = 1 if v.get("sao", True) else 0
        cfg.deblock = not v.get("deblock_disable", 0)
        cfg.log2_max_tb = v.get("log2_max_tb", 5)
        cfg.log2_min_tb = v.get("log2_min_tb", 2)
        cfg.fast_search = v.get("fast_search", 1)
        # FEN (fast encoder setting): honoured — it changes HM's
        # bi-pred refinement policy (one pass on the weaker list,
        # TEncSearch.cpp:3352-3370), which the BD ladder follows
        cfg.fast_enc = bool(v.get("fast_enc", False))
        cfg.hadamard_me = v.get("hadamard_me", True)
        cfg.strong_intra_smoothing = 1 if v.get("strong_intra_smoothing",
                                                False) else 0
        cfg.transform_skip = v.get("transform_skip", False)
        cfg.cb_qp_offset = v.get("cb_qp_offset", 0)
        cfg.cr_qp_offset = v.get("cr_qp_offset", 0)
        cfg.wpp = bool(v.get("wpp", False))
        cfg.tile_cols = v.get("tile_cols_minus1", 0) + 1
        cfg.tile_rows = v.get("tile_rows_minus1", 0) + 1
        if (cfg.tile_cols > 1 or cfg.tile_rows > 1) and \
                int(self.opts.get("TileUniformSpacing",
                                  self.opts.get("UniformSpacingIdc", 1))) \
                == 0:
            raise UnsupportedToolError(
                "non-uniform tile spacing: this encoder signals uniform "
                "tile grids only")
        cfg.level = v.get("level", "4")
        cfg.tier = v.get("tier", "main")
        cfg.lf_cross_slices = v.get("lf_cross_slices", True)
        cfg.lf_cross_tiles = v.get("lf_cross_tiles", True)
        if v.get("slice_mode", 0) == 1:
            cfg.slice_ctus = v.get("slice_argument", 0)
        cfg.cabac_init = v.get("cabac_init", False)
        # HM default: no decoded-picture-hash SEI unless the cfg asks
        # (TAppEncCfg "SEIDecodedPictureHash" default 0)
        cfg.hash_sei = bool(v.get("hash_sei", False))
        sl_mode = int(v.get("scaling_list", 0) or 0)
        cfg.scaling_list = bool(sl_mode)
        if sl_mode == 2 and v.get("scaling_list_file"):
            cfg.scaling_list_data = read_scaling_list_file(
                v["scaling_list_file"])
        cfg.pcm_enabled = v.get("pcm_enabled", False)
        cfg.pcm_filter_disabled = v.get("pcm_filter_disabled", False)
        cfg.log2_min_ipcm = v.get("log2_min_ipcm", 3)
        cfg.log2_max_ipcm = v.get("log2_max_ipcm", 5)
        cfg.lossless = v.get("lossless", False)
        cfg.weighted_bipred = v.get("weighted_bipred", False)
        if v.get("vui_enabled") or v.get("hrd_enabled"):
            cfg.vui_enabled = True
        cfg.hrd_enabled = bool(v.get("hrd_enabled", False))
        cfg.field_coding = bool(v.get("field_coding", False))
        if cfg.field_coding:
            cfg.vui_enabled = True   # field_seq_flag + frame_field_info
        if chroma == 1:
            # full RD-searched multi-level RQT (intra and inter)
            cfg.max_tr_hierarchy_intra = max(
                0, v.get("tu_depth_intra", 1) - 1)
            cfg.max_tr_hierarchy_inter = max(
                0, v.get("tu_depth_inter", 1) - 1)
        if v.get("rate_control"):
            cfg.rate_kbps = v.get("rate_bps", 0) // 1000
            cfg.rate_bps = v.get("rate_bps", 0)
            cfg.rc_keep_hier = v.get("rc_keep_hier", 0)
            cfg.rc_lcu_level = v.get("rc_lcu_level", True)
            cfg.rc_lcu_separate = v.get("rc_lcu_separate", True)
            cfg.rc_initial_qp = v.get("rc_initial_qp", 0)
            cfg.rc_force_intra_qp = v.get("rc_force_intra_qp", False)
        if cfg.gop_entries:
            cfg.tmvp = 1
            cfg.max_dec_pic_buffering = 8
            maxpoc = max(e.poc for e in cfg.gop_entries)
            reorder = sum(1 for e in cfg.gop_entries if e.poc != maxpoc)
            cfg.num_reorder_pics = min(reorder, 7)
            cfg.num_ref_l0 = max(e.num_ref_pics_active
                                 for e in cfg.gop_entries)
            cfg.num_ref_l1 = cfg.num_ref_l0
        else:
            cfg.gop = "intra"
        return cfg


def read_scaling_list_file(path):
    """HM ScalingListFile parser (reference TComScalingList::
    xParseScalingList, TComSlice.cpp:2051): named sections with
    comma-separated coefficients in raster order (the <=8x8 signaling
    base), plus *_DC sections for 16x16/32x32.  Returns the decoder's
    scaling_list_data dict {(size_id, matrix_id): (raster_list, dc)}
    covering the signaled matrix ids (size 3 codes only luma lists)."""
    import re
    text = open(path).read()

    def section(name, count):
        m = re.search(re.escape(name) + r"(?![A-Z_0-9])", text)
        if m is None:
            return None
        vals = re.findall(r"-?\d+", text[m.end():])
        if len(vals) < count:
            return None
        return [int(v) for v in vals[:count]]

    sizes = ["4X4", "8X8", "16X16", "32X32"]
    out = {}
    for size_id in range(4):
        n = 16 if size_id == 0 else 64
        step = 3 if size_id == 3 else 1
        for matrix_id in range(0, 6, step):
            kind = "INTRA" if matrix_id < 3 else "INTER"
            comp = ["LUMA", "CHROMAU", "CHROMAV"][matrix_id % 3]
            name = f"{kind}{sizes[size_id]}_{comp}"
            lst = section(name, n)
            if lst is None:
                raise ValueError(f"scaling list file: missing {name}")
            dc = 8
            if size_id > 1:
                d = section(name + "_DC", 1)
                if d is None:
                    raise ValueError(f"scaling list file: missing {name}_DC")
                dc = d[0]
            out[(size_id, matrix_id)] = (lst, dc)
    return out
