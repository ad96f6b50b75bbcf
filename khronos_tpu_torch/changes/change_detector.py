"""Temporal evidence scan: histograms -> change decisions.

Port of `khronos_tpu/changes/change_detector.py`, the equivalent of the
reference RayChangeDetector (khronos/src/backend/change_detection/
ray_change_detector.cpp:66-133): evidence is discretized into
`temporal_resolution` bins; a sliding window of `window_size` bins scans
forward/backward; the first window whose absent fraction exceeds
`absence_confidence` yields `closest_absent`, windows with presence above
`presence_confidence` extend `furthest_persistent`. Supports absolute counts
or relative confidences.

The scan is a cumulative-sum window over [P, B, 2] histograms for all query
points at once, on `device` (CUDA unless the caller passes device="cpu").
The window sums are integer, scanned along a contiguous axis (the histogram
is transposed to [P, 2, B] first; a cumsum along a strided axis is slow on
the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from khronos_tpu_torch import resolve_device


@dataclasses.dataclass
class RayChangeDetectorConfig:
    window_size: int = 5  # bins
    absence_confidence: float = 0.5  # fraction (or count if use_relative=False)
    presence_confidence: float = 0.2
    min_rays_per_window: int = 1
    use_relative_confidence: bool = True
    # Laplace-style prior added to the window total in the relative branch:
    # frac = count / (total + prior). Damps one-or-two-ray windows (the ray
    # policies sample observers by STAMP range, not actual visibility, so a
    # single fabricated ray through an occluder can otherwise flag a phantom
    # absence) while leaving dense evidence untouched. 0 = off.
    evidence_prior: float = 0.0


def _scan_device(
    evidence,  # [P, B, 2] int (match, absent)
    rel_tmin,  # [P] f32: window lower bound, seconds RELATIVE to bin 0
    rel_tmax,  # [P] f32: window upper bound (relative)
    bin_size: float,  # seconds/bin
    absence_conf: float,
    presence_conf: float,
    min_rays: int,
    prior: float,
    window_size: int,
    use_relative: bool,
):
    """Returns per point (first_absent_bin, last_absent_bin,
    first_persistent_bin, last_persistent_bin,
    first_persistent_after_absent_bin, last_persistent_before_absent_bin),
    int32, -1 where none.

    Bin validity is computed here from per-point relative bounds; the
    thresholds are float32 as the reference's traced scalars are."""
    P, B, _ = evidence.shape
    dev = evidence.device

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    bin_t = (torch.arange(B, dtype=torch.float32, device=dev) + 0.5) * f32(bin_size)  # [B]
    bin_valid = (bin_t[None, :] >= rel_tmin[:, None]) & (bin_t[None, :] <= rel_tmax[:, None])
    # [P, 2, B]: the scanned axis contiguous
    ev = (evidence.to(torch.int32) * bin_valid[:, :, None]).transpose(1, 2).contiguous()
    cs = torch.cat([torch.zeros((P, 2, 1), dtype=torch.int32, device=dev),
                    torch.cumsum(ev, dim=2, dtype=torch.int32)], dim=2)  # [P, 2, B+1]
    starts = torch.arange(B, device=dev)  # window [i, min(i+w, B))
    ends = torch.clamp_max(starts + window_size, B)
    # a window whose START bin is outside the queried range must not fire:
    # its time (the window start) would be reported outside [t_min, t_max]
    win = (cs[:, :, ends] - cs[:, :, starts]) * bin_valid[:, None, :]
    match = win[:, 0].to(torch.float32)
    absent = win[:, 1].to(torch.float32)
    total = match + absent
    enough = total >= f32(min_rays)
    if use_relative:
        denom = torch.clamp_min(total + f32(prior), 1.0)
        zero = f32(0.0)
        frac_abs = torch.where(total > 0, absent / denom, zero)
        frac_match = torch.where(total > 0, match / denom, zero)
        is_absent = enough & (frac_abs > f32(absence_conf))
        is_present = enough & (frac_match > f32(presence_conf))
    else:
        is_absent = enough & (absent > f32(absence_conf))
        is_present = enough & (match > f32(presence_conf))

    bins = torch.arange(B, dtype=torch.int32, device=dev)
    none = torch.tensor(-1, dtype=torch.int32, device=dev)

    def first_true(mask):
        # argmax returns the first maximum; it takes no bool
        return torch.where(mask.any(dim=1), torch.argmax(mask.to(torch.uint8), dim=1).to(torch.int32), none)

    def last_true(mask):
        rev = mask.flip(1).to(torch.uint8)
        return torch.where(mask.any(dim=1), (B - 1 - torch.argmax(rev, dim=1)).to(torch.int32), none)

    fa = first_true(is_absent)
    la = last_true(is_absent)
    # order-constrained persistence (reference ObjectChange ordering,
    # change_state.h:76-103: ... last_seen -> last_persistent -> last_absent):
    # persistence may only EXTEND an interval up to where absence begins
    before_absent = bins[None, :] < torch.where(fa < 0, B, fa)[:, None]
    after_absent = bins[None, :] > la[:, None]  # la = -1 -> all bins
    return (
        fa,
        la,
        first_true(is_present),
        last_true(is_present),
        first_true(is_present & after_absent),
        last_true(is_present & before_absent),
    )


class RayChangeDetector:
    def __init__(self, config: RayChangeDetectorConfig, bin_size_s: float, device=None):
        """device: where the scan runs; CUDA unless the caller passes
        device="cpu" (raises when no GPU is visible)."""
        self.config = config
        self.bin_size_s = bin_size_s
        self.device = resolve_device(device)

    _KEYS = (
        "first_absent_bin", "last_absent_bin", "first_persistent_bin",
        "last_persistent_bin", "first_persistent_after_absent_bin",
        "last_persistent_before_absent_bin",
    )

    def _empty_result(self):
        out = {k: np.zeros(0, np.int64) for k in self._KEYS}
        for k in self._KEYS:
            out[k.replace("_bin", "_s")] = np.zeros(0, np.float64)
        return out

    def scan(
        self,
        evidence,
        t_min_s: float = 0.0,
        t_max_s: float = np.inf,
        origin_s: float = 0.0,
        n_valid: int = None,
    ):
        """evidence -> dict of per-point bin indices and times (s).

        `evidence` is either a host [P, B, 2] array or a LIST of fixed-shape
        [chunk, B, 2] device tensors (the verificator's chunked-query output,
        kept on the device). With a chunk list, `n_valid` gives the real row
        count. The outputs of every chunk come back in one batched pull.

        Semantics per point (reference cpp:66-133):
          first/last_absent: window starts where absence dominates
          first/last_persistent: windows with sufficient presence
        Times are window-start bin centers; -1/NaN where no evidence.

        `origin_s` is the absolute time of bin 0 (the verificator's
        bin_origin_s): t_min/t_max are absolute, returned *_s times too.
        Bounds are converted to library-RELATIVE seconds on host (float64)
        before the float32 device compare, so epoch-scale stamps never meet
        float32.
        """
        cfg = self.config
        if isinstance(evidence, (list, tuple)):
            chunks = list(evidence)
            if not chunks:
                return self._empty_result()
            if n_valid is None:
                raise ValueError(
                    "scan() with a chunk list needs n_valid (the real row "
                    "count; rows past it are query padding)"
                )
            # chunk size comes from the producer (RayVerificator.query)
            chunk = int(chunks[0].shape[0])
            assert all(c.shape[0] == chunk for c in chunks), (
                [c.shape for c in chunks]
            )
            P = int(n_valid)
            Pp = chunk * len(chunks)
        else:
            evidence = np.asarray(evidence)
            P, B, _ = evidence.shape
            if P == 0:
                return self._empty_result()
            # host evidence (object pass: tens of rows) pads to a pow2
            # bucket (min 64), as the reference does
            chunk = max(64, 1 << int(np.ceil(np.log2(P))))
            Pp = chunk
            if Pp != P:
                evidence = np.concatenate(
                    [evidence, np.zeros((Pp - P,) + evidence.shape[1:], evidence.dtype)]
                )
            # the reference's device arrays are int32 (x64 off)
            chunks = [torch.from_numpy(evidence.astype(np.int32)).to(self.device)]
        BIG = np.float32(3e38)
        rel_tmin = (
            np.broadcast_to(np.asarray(t_min_s, np.float64).reshape(-1), (P,))
            - origin_s
        )
        rel_tmax = (
            np.broadcast_to(np.asarray(t_max_s, np.float64).reshape(-1), (P,))
            - origin_s
        )
        # inf - origin stays inf; clip to float32 range
        rel_tmin = np.clip(rel_tmin, -BIG, BIG).astype(np.float32)
        rel_tmax = np.clip(rel_tmax, -BIG, BIG).astype(np.float32)
        # padding rows: empty window -> every output -1
        rel_tmin = np.concatenate([rel_tmin, np.full(Pp - P, BIG, np.float32)])
        rel_tmax = np.concatenate([rel_tmax, np.full(Pp - P, -BIG, np.float32)])
        tmin_dev = torch.from_numpy(rel_tmin).to(self.device)
        tmax_dev = torch.from_numpy(rel_tmax).to(self.device)
        parts = []
        for k, ev_c in enumerate(chunks):
            parts.append(torch.stack(_scan_device(
                ev_c,
                tmin_dev[k * chunk: (k + 1) * chunk],
                tmax_dev[k * chunk: (k + 1) * chunk],
                float(np.float32(self.bin_size_s)),
                cfg.absence_confidence,
                cfg.presence_confidence,
                cfg.min_rays_per_window,
                cfg.evidence_prior,
                cfg.window_size,
                cfg.use_relative_confidence,
            )))
        # ONE device->host transfer for every chunk's outputs
        out = torch.cat(parts, dim=1).cpu().numpy()[:, :P]
        fa, la, fp, lp, fp_after, lp_before = out

        def to_time(idx):
            t = origin_s + (idx + 0.5) * self.bin_size_s
            return np.where(idx >= 0, t, np.nan)

        return {
            "first_absent_bin": fa,
            "last_absent_bin": la,
            "first_persistent_bin": fp,
            "last_persistent_bin": lp,
            # order-constrained variants (reference ObjectChange ordering):
            # persistence after the last absence / before the first absence
            "first_persistent_after_absent_bin": fp_after,
            "last_persistent_before_absent_bin": lp_before,
            "first_absent_s": to_time(fa),
            "last_absent_s": to_time(la),
            "first_persistent_s": to_time(fp),
            "last_persistent_s": to_time(lp),
            "first_persistent_after_absent_s": to_time(fp_after),
            "last_persistent_before_absent_s": to_time(lp_before),
        }
