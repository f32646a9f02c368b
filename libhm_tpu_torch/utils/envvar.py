# Copied from libhm_tpu/utils/envvar.py
"""Environment-variable debug switches (reference Debug.h:64-110 EnvVar /
DebugOptionList).

The reference registers test/debug controls as environment variables
(ForceLumaMode, ForceChromaMode, DebugSBAC, ...).  This framework's
equivalents:

  HEVC_TRACE=<path>          CABAC symbol trace (DebugSBAC equivalent;
                             see utils/trace.py)
  HEVC_FORCE_LUMA_MODE=<n>   force every intra luma PU to mode n (0-34)
  HEVC_FORCE_CHROMA_MODE=<n> force intra chroma to mode n (0-34) or DM

Each registered variable mirrors EnvVar: name, default, help; is_set /
value accessors; print_env_vars() lists them like EnvVar::printEnvVar.
"""
import os


class EnvVar:
    _registry = []

    def __init__(self, name, default, help_text):
        self.name = name
        self.default = default
        self.help = help_text
        EnvVar._registry.append(self)

    @property
    def raw(self):
        return os.environ.get(self.name)

    def is_set(self):
        return self.raw is not None

    def get_int(self, fallback=None):
        v = self.raw
        if v is None:
            return fallback
        try:
            return int(v)
        except ValueError:
            return fallback

    def get_str(self):
        v = self.raw
        return self.default if v is None else v


FORCE_LUMA_MODE = EnvVar(
    "HEVC_FORCE_LUMA_MODE", "",
    "force every intra luma PU to this mode index (0-34)")
FORCE_CHROMA_MODE = EnvVar(
    "HEVC_FORCE_CHROMA_MODE", "",
    "force intra chroma to this mode index (0-34), or 'DM'")
TRACE = EnvVar(
    "HEVC_TRACE", "",
    "write the CABAC symbol trace to this path (utils/trace.py; the "
    "DebugSBAC equivalent)")
DEBUG_RQT = EnvVar(
    "HEVC_DEBUG_RQT", "",
    "print each picture's transform-tree leaves (comp/x/y/size/skip/cbf) "
    "during numpy reconstruction (DebugRQT equivalent)")
DEBUG_PRED = EnvVar(
    "HEVC_DEBUG_PRED", "",
    "print per-block prediction info (intra modes, MVs) during numpy "
    "reconstruction (DebugPred equivalent)")
DUMP_BLOCKS = EnvVar(
    "HEVC_DUMP_BLOCKS", "",
    "append per-intra-block pred/resi/reco sample dumps to this path "
    "(DEBUG_STRING Structure/Pred/Resi/Reco equivalent) — diff two runs "
    "to localize the first diverging block")


def print_env_vars():
    """EnvVar::printEnvVar equivalent."""
    for v in EnvVar._registry:
        state = v.raw if v.is_set() else "(unset)"
        print(f"{v.name:28s} {state:12s} {v.help}")
