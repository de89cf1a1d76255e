"""Comparisons that hold a device's results to a reference: the stereo
search's winner maps, and a sharded sequence sweep against each sequence
run alone. ``chip_smoke.py`` runs them on the GPU; the tests run them on the
CPU."""

from __future__ import annotations

import numpy as np

from odometry_tpu.distributed.sweep import run_sweep
from odometry_tpu.kernels.disparity import PATTERN_OFFSETS
from odometry_tpu.pipeline.runner import run_sequence

F32_EPS = float(np.finfo(np.float32).eps)


def _pattern64(img):
    H, W = img.shape
    p = np.pad(np.asarray(img, np.float64), 2)
    return np.stack([p[2 + dy:2 + dy + H, 2 + dx:2 + dx + W] for dy, dx in PATTERN_OFFSETS])


def compare_winner_maps(ls, rs, got, want, *, boundary, max_disparity, min_disparity):
    """Check GPU winner maps `got` against the CPU reference `want`.

    Tolerances. Winner columns must be equal except at SSD near-ties, where
    the two devices' roundings may pick different candidates: a differing
    winner must be a valid candidate that scores, in an f64 recomputation,
    within 8 f32 ulps of |l|^2 + |r|^2 of the reference's winner (the
    rounding of the expanded SSD |l|^2 + |r|^2 - 2 l.r). The synthetic
    texture has wide low-contrast areas where many candidates tie to within
    that rounding, so up to 1% of the pixels may differ. SSD values are
    compared in the same relative f32 terms against the f64 SSD of each
    side's own winner.
    """
    H, W = ls.shape
    PL, PR = _pattern64(ls), _pattern64(rs)
    ln, rn = np.sum(PL * PL, 0), np.sum(PR * PR, 0)
    d_lo = max(1, min_disparity or 1)
    d_hi = W if max_disparity is None else max_disparity
    ys, xs = np.mgrid[0:H, 0:W]
    has_cand = np.minimum(xs - boundary, d_hi) >= d_lo
    rcol_ok = (xs >= boundary) & (np.minimum(W - 1 - xs, d_hi) >= d_lo)

    def ssd(y, x, xr):
        return np.sum((PL[:, y, x] - PR[:, y, xr]) ** 2, axis=0)

    def valid(x, xr):
        d = x - xr
        return (xr >= boundary) & (d >= d_lo) & (d <= d_hi)

    counts = {}
    best_g, match_g, rmatch_g = got[0], got[1], got[2]
    best_c, match_c, rmatch_c = want[0], want[1], want[2]
    # Forward winners: match[y, x] is the right column for left pixel x.
    for name, best, match in (("gpu", best_g, match_g), ("cpu", best_c, match_c)):
        if not (np.all(match[~has_cand] == 0) and np.all(best[~has_cand] == 1e10)):
            raise AssertionError(f"{name}: pixels without candidates must report (1e10, 0)")
        y, x = ys[has_cand], xs[has_cand]
        m = match[has_cand]
        if not valid(x, m).all():
            raise AssertionError(f"{name}: winner outside the band")
        tol = 8 * F32_EPS * (ln[y, x] + rn[y, m]) + 1e-3
        err = np.abs(best[has_cand] - ssd(y, x, m))
        if not (err <= tol).all():
            raise AssertionError(f"{name}: best SSD off its winner's f64 SSD by {err.max()}")
    diff = has_cand & (match_g != match_c)
    y, x, mg, mc = ys[diff], xs[diff], match_g[diff], match_c[diff]
    gap = np.abs(ssd(y, x, mg) - ssd(y, x, mc))
    tol = 8 * F32_EPS * (2 * ln[y, x] + rn[y, mg] + rn[y, mc]) + 1e-3
    if not (gap <= tol).all():
        raise AssertionError(f"match differs beyond a near-tie: gap {gap.max()}")
    counts["match_diff"] = int(diff.sum())
    if np.any(rmatch_g != 0) or np.any(rmatch_c != 0):
        # Reverse winners: rmatch[y, xr] is the left column for right pixel xr.
        if not (np.all(rmatch_g[~rcol_ok] == 0) and np.all(rmatch_c[~rcol_ok] == 0)):
            raise AssertionError("columns without candidates must report rmatch 0")
        y, xr = ys[rcol_ok], xs[rcol_ok]
        for name, rm in (("gpu", rmatch_g), ("cpu", rmatch_c)):
            if not valid(rm[rcol_ok], xr).all():
                raise AssertionError(f"{name}: reverse winner outside the band")
        diff = rcol_ok & (rmatch_g != rmatch_c)
        y, xr, xg, xc = ys[diff], xs[diff], rmatch_g[diff], rmatch_c[diff]
        gap = np.abs(ssd(y, xg, xr) - ssd(y, xc, xr))
        tol = 8 * F32_EPS * (ln[y, xg] + ln[y, xc] + 2 * rn[y, xr]) + 1e-3
        if not (gap <= tol).all():
            raise AssertionError(f"rmatch differs beyond a near-tie: gap {gap.max()}")
        counts["rmatch_diff"] = int(diff.sum())
    limit = 1e-2 * H * W
    if max(counts.values()) > limit:
        raise AssertionError(f"too many near-tie flips {counts} (limit {limit:.0f})")
    return counts


def sweep_matches_single(frames_per_seq, gt_per_seq, cfg, mesh, track_tol=0.05):
    """run_sweep over `mesh` against each sequence alone through
    run_sequence; returns per stream (frames both track, largest rotation
    and translation difference on those frames).

    Tolerance: the batched solves round differently, and the LM step
    tolerance turns a last-bit difference into one iteration more or less:
    about 1e-3 per frame on the CPU, bounded here by 2e-3 in rotation
    entries and 0.02 m. A frame whose solve sits on the edge of its basin
    can fail (1-2 m off, recovered on the next frame, since frames track a
    keyframe) in one run and not the other, so poses are compared on the
    frames both runs track to within `track_tol` m of ground truth (0.05 m
    at KITTI size; a coarser image needs more), and each run
    must track at least 3/4 of every stream's frames: a stream computed
    from another stream's frames, or garbage, tracks none.
    """
    swept = run_sweep(frames_per_seq, cfg, mesh)
    out = []
    for s, (frames, gt) in enumerate(zip(frames_per_seq, gt_per_seq)):
        single = run_sequence(frames, cfg, stop_on_depth_failure=False).poses
        if single.shape != swept[s].shape:
            raise AssertionError(f"stream {s}: {single.shape} vs {swept[s].shape}")
        tracked = [np.linalg.norm(p[:, :3, 3] - gt[:, :3, 3], axis=1) <= track_tol
                   for p in (single, swept[s])]
        both = tracked[0] & tracked[1]
        d = np.abs(single - swept[s])[both]
        out.append((int(both.sum()), float(d[:, :3, :3].max()), float(d[:, :3, 3].max())))
        n = len(frames)
        if min(int(t.sum()) for t in tracked) < 0.75 * n:
            raise AssertionError(f"stream {s}: tracked {[int(t.sum()) for t in tracked]} of {n}")
        if not (out[-1][1] <= 2e-3 and out[-1][2] <= 0.02):
            raise AssertionError(f"stream {s}: sweep differs from the single run: {out[-1]}")
    return out
