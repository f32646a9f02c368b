# Copied from libhm_tpu/apps/bitrate_targeting.py
"""Bitrate-targeting utilities (reference utils/BitrateTargeting/*).

Two tools driven the same way as the reference's shell scripts:

- ``extract_bitrates``: parse an encoder log and print the average bits per
  temporal layer (reference ExtractBitrates.cpp:extractBitratesForQPs —
  non-I POC lines keyed by nQP index).
- ``guess_lambda_modifiers``: given target bitrates and a "meta-log" of
  previous (LambdaModifier vector ; bitrate vector) runs, print the next
  LambdaModifier guess per temporal layer (reference
  GuessLambdaModifiers.cpp: one-point extrapolation with initial-adjustment
  parameter, two-point interpolation, intra/inter dampening).

CLI:
    python -m libhm_tpu.apps.bitrate_targeting extract < enc.log
    python -m libhm_tpu.apps.bitrate_targeting guess <adj> "<r0 r1 ...>" < metalog
"""
import math
import re
import sys


# ---------------------------------------------------------------------------
def extract_bitrates(log_text, frame_rate=None):
    """Average bits per temporal-layer QP index from encoder POC lines.

    Returns the list of averages ordered by contiguous nQP index; raises
    ValueError on a gap (reference NonContiguousQPSetException).
    """
    tallies = {}
    poc_re = re.compile(
        r"^POC.*?\(\s([A-Za-z])[^ ]*\s\S+\s(\d+)[^)]*\)\s+(\d+)")
    for line in log_text.splitlines():
        m = poc_re.match(line)
        if not m:
            continue
        slice_type, qp_index, bits = m.group(1), int(m.group(2)), int(m.group(3))
        if slice_type == "I":
            continue
        tallies.setdefault(qp_index, []).append(float(bits))
    if not tallies:
        return []
    keys = sorted(tallies)
    if keys != list(range(keys[0], keys[0] + len(keys))):
        raise ValueError("non-contiguous QP set in log")
    result = [sum(tallies[k]) / len(tallies[k]) for k in keys]
    if frame_rate is not None:
        # convert average bits/picture to bitrate like targetBitrates.sh
        result = [r * frame_rate for r in result]
    return result


# ---------------------------------------------------------------------------
def _increment_lambda_modifier(adj, target, prev_lm, prev_rate):
    extrapolated = prev_lm * target / prev_rate
    return prev_lm + adj * (extrapolated - prev_lm)


def _polate_lambda_modifier(target, p1, p2):
    (lm1, r1), (lm2, r2) = p1, p2
    return lm1 + (lm1 - lm2) / (r1 - r2) * (target - r1)


def guess_lambda_modifier(adj, target, points, inter_dampening):
    """One layer's next LambdaModifier from up to two previous points.

    points: list of (lambda_modifier, bitrate), oldest first.
    """
    assert points
    if len(points) == 1:
        prelim = _increment_lambda_modifier(adj, target, *points[-1])
    else:
        p1, p2 = points[-1], points[-2]
        if p1[0] == p2[0] or p1[1] == p2[1]:
            prelim = _increment_lambda_modifier(adj, target, *points[-1])
        else:
            prelim = _polate_lambda_modifier(target, p1, p2)
    prev = points[-1][0]
    # intra dampening
    inter = math.log(1.0 + abs(prelim - prev) / prev)
    prelim = prev * (1.0 - inter) if prelim < prev else prev * (1.0 + inter)
    # inter dampening, halved until positive
    result = prev + inter_dampening * (prelim - prev)
    while result <= 0.0:
        inter_dampening /= 2.0
        result = prev + inter_dampening * (prelim - prev)
    return result


def guess_lambda_modifiers(adj, targets, meta_log):
    """meta_log: list of (lambda_modifier_vector, bitrate_vector)."""
    assert meta_log
    cumulative_delta = 0.0
    out = []
    for i in range(len(targets)):
        points = [(e[0][i], e[1][i]) for e in meta_log[-2:]]
        damp = 1.0 / (50.0 * cumulative_delta + 1.0)
        new_lm = guess_lambda_modifier(adj, targets[i], points, damp)
        out.append(new_lm)
        old_lm = points[-1][0]
        cumulative_delta += abs(new_lm - old_lm) / old_lm
    return out


def parse_meta_log(text):
    """Lines of '-LM<i> <v> -LM<i+1> <v> ...;<r0> <r1> ...'."""
    entries = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        lm_part, _, rate_part = line.partition(";")
        lms = [float(v) for v in re.findall(r"-LM\d+\s+([\d.eE+-]+)", lm_part)]
        rates = [float(v) for v in rate_part.split()]
        if lms and rates:
            entries.append((lms, rates))
    return entries


# ---------------------------------------------------------------------------
def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    if argv[0] == "extract":
        rates = extract_bitrates(sys.stdin.read())
        print(" ".join(f"{r:g}" for r in rates))
        return 0
    if argv[0] == "guess":
        adj = float(argv[1])
        targets = [float(v) for v in argv[2].split()]
        meta = parse_meta_log(sys.stdin.read())
        lms = guess_lambda_modifiers(adj, targets, meta)
        print(" ".join(f"-LM{i} {v:.7f}" for i, v in enumerate(lms)))
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
