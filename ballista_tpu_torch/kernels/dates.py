"""Date arithmetic kernels (days-since-epoch int32 representation).

The port of the JAX package's ``kernels/dates.py``: the standard
civil-calendar/days bijection (Howard Hinnant's public domain algorithms)
in torch integer ops. Every division here FLOORS (``//`` on integer
tensors is ``floor_divide``, ``torch.remainder`` is the floored modulo),
exactly as ``jnp.floor_divide``/``jnp.mod`` do in the reference.
"""

from __future__ import annotations

import torch


def civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day) int32 tensors."""
    z = days.to(torch.int32) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9).to(mp.dtype)
    year = y + (m <= 2).to(y.dtype)
    return year.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) int32 tensors -> days since 1970-01-01 (inverse
    of civil_from_days; same public-domain algorithm family)."""
    y = y.to(torch.int32) - (m <= 2).to(torch.int32)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400  # [0, 399]
    mp = m + torch.where(m > 2, -3, 9).to(m.dtype)  # [0, 11]
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def date_trunc(part: str, days: torch.Tensor):
    """Truncate days-since-epoch to the start of year/quarter/month/week/day."""
    if part == "day":
        return days.to(torch.int32)
    if part == "week":  # ISO weeks start Monday; 1970-01-01 was a Thursday
        return (days - torch.remainder(days + 3, 7)).to(torch.int32)
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(m)
    if part == "year":
        return days_from_civil(y, one, one)
    if part == "quarter":
        return days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
    if part == "month":
        return days_from_civil(y, m, one)
    raise ValueError(f"date_trunc part {part!r}")


def extract_year(days):
    return civil_from_days(days)[0]


def extract_month(days):
    return civil_from_days(days)[1]


def extract_day(days):
    return civil_from_days(days)[2]
