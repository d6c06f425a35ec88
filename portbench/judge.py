"""The comparison that decides ``correct``: each number compared beside its
limit.  A number passes when it is finite and at most its limit; a number
that could not be read (None, NaN) fails."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    value: float | None
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and math.isfinite(self.value) and self.value <= self.limit


def scaled_err(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    """The widest gap between ``got`` and ``ref``, each measured against its
    element's ``scale`` (the sum of the absolute values of its terms, so
    that cancellation does not inflate it); where the scale is 0 the answer
    is 0 and the gap counts in full."""
    if got.shape != ref.shape:
        return math.inf
    if ref.numel() == 0:
        return 0.0
    gap = (got.to(ref.device, torch.float64) - ref).abs()
    return float((gap / torch.where(scale > 0, scale, 1.0)).max())


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between ``got`` and ``ref`` relative to ``|ref|``, for
    answers that are never 0."""
    if got.shape != ref.shape:
        return math.inf
    if ref.numel() == 0:
        return 0.0
    return float(((got.to(ref.device, torch.float64) - ref).abs() / ref.abs()).max())


def worst(checks: list[Check]) -> list[Check]:
    """One check per name, the worst reading of each (an unreadable one
    worst of all), in the order the names first appear."""
    badness = lambda c: c.value if c.value is not None and math.isfinite(c.value) else math.inf  # noqa: E731
    out: dict[str, Check] = {}
    for c in checks:
        if c.name not in out or badness(c) > badness(out[c.name]):
            out[c.name] = c
    return list(out.values())


def as_json(checks: list[Check]) -> dict:
    return {c.name: {"value": c.value if c.value is not None and math.isfinite(c.value) else None,
                     "limit": c.limit} for c in checks}
