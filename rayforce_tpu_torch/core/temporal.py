"""Temporal conversions.

Encodings match the reference (core/temporal.c, date.c, time.c, timestamp.c):
date = i32 days since 1970.01.01, time = i32 milliseconds since midnight
(signed), timestamp = i64 nanoseconds since the epoch.
"""
from __future__ import annotations

# Civil-date <-> day-count (Howard Hinnant's algorithm, public domain idiom).


EPOCH_2000_DAYS = 10957  # days from 1970.01.01 to 2000.01.01


def days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 2000.01.01."""
    return _days_from_civil_1970(y, m, d) - EPOCH_2000_DAYS


def _days_from_civil_1970(y: int, m: int, d: int) -> int:
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def civil_from_days(z: int):
    """(y, m, d) from days since 2000.01.01."""
    z += EPOCH_2000_DAYS
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


def time_parts(ms: int):
    """(sign, h, m, s, ms) from signed milliseconds."""
    sign = -1 if ms < 0 else 1
    ms = abs(ms)
    return sign, ms // 3600000, (ms // 60000) % 60, (ms // 1000) % 60, ms % 1000


def ts_parts(ns: int):
    """(y, mo, d, h, mi, s, nanos) from ns since 2000.01.01."""
    days, rem = divmod(ns, 86400_000_000_000)
    y, mo, d = civil_from_days(days)
    secs, nanos = divmod(rem, 1_000_000_000)
    return y, mo, d, secs // 3600, (secs // 60) % 60, secs % 60, nanos


def make_time_ms(sign: int, h: int, m: int, s: int, ms: int) -> int:
    return sign * (h * 3600000 + m * 60000 + s * 1000 + ms)


def make_ts_ns(y, mo, d, h, mi, s, nanos) -> int:
    return (days_from_civil(y, mo, d) * 86400 + h * 3600 + mi * 60 + s) \
        * 1_000_000_000 + nanos
