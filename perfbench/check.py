"""The comparison that decides ``correct``.

The answers are the frames (and, in the live loop, the previews) that the
timed path itself produced in the window, a sample drawn from the seed.
Each is held against the configuration's plain reference
(``configs/<config>/reference.py``, float64), computed from the same
seeded uint8 input after the program's state is freed.  The numbers
compared, each beside its limit in ``limits/<cell>.json``:

* ``frame_err``: the largest absolute difference of any value of any
  held frame from the reference's (a NaN counts as infinite);
* ``preview_err``: over the held previews' bytes, the largest distance
  by which a byte lies outside the rounding interval of the reference's
  unrounded code (the same box downsample and sRGB encode, in float64),
  in codes: 0 where the byte is the reference's code rounded either way.
"""

from __future__ import annotations

import math

import torch

from perfbench import refmath


def frame_err(frame: torch.Tensor, ref: torch.Tensor) -> float:
    err = (frame.to(ref.dtype) - ref).abs().max().item()
    return math.inf if math.isnan(err) else err


def preview_err(preview, ref_codes: torch.Tensor) -> float:
    got = torch.as_tensor(preview)
    if got.shape != ref_codes.shape:
        return math.inf
    err = ((got.to(ref_codes.dtype) - ref_codes.cpu()).abs() - 0.5).clamp(min=0.0).max().item()
    return math.inf if math.isnan(err) else err


def compare(answers: list, ref: torch.Tensor, preview_px, limits: dict) -> tuple[dict, int]:
    """({number: value}, answers failing a limit) for the numbers named in
    ``limits``."""
    ref_codes = refmath.preview(ref, preview_px) if "preview_err" in limits else None
    values = {name: 0.0 for name in limits}
    failed = 0
    for frame, preview in answers:
        got = {}
        if "frame_err" in limits:
            got["frame_err"] = frame_err(frame, ref)
        if ref_codes is not None:
            got["preview_err"] = (preview_err(preview, ref_codes)
                                  if preview is not None else math.inf)
        failed += any(v > limits[k]["limit"] for k, v in got.items())
        for k, v in got.items():
            values[k] = max(values[k], v)
    if not answers:
        values = {name: math.inf for name in limits}
    return values, failed
