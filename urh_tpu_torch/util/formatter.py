"""Value formatting helpers (host copy of urh_tpu.util.formatter, the
urh/util/Formatter.py counterpart)."""

from __future__ import annotations

import locale

from urh_tpu_torch.util.logging import logger

# (threshold, scale divisor, SI suffix) tables, largest first
_TIME_SCALES = ((1e-6, 1e9, "n"), (1e-3, 1e6, "µ"), (1.0, 1e3, "m"))
_VALUE_SCALES = ((1e9, "G"), (1e6, "M"), (1e3, "K"))


class Formatter:
    @staticmethod
    def local_decimal_seperator():
        return locale.localeconv()["decimal_point"]

    @staticmethod
    def science_time(time_in_seconds: float, decimals=2, append_seconds=True,
                     remove_spaces=False) -> str:
        value, suffix = time_in_seconds, ""
        for threshold, factor, si in _TIME_SCALES:
            if time_in_seconds < threshold:
                value, suffix = time_in_seconds * factor, si
                break

        result = locale.format_string("%.{0}f ".format(decimals) + suffix, value)
        result += "s" if append_seconds else ""
        return result.replace(" ", "") if remove_spaces else result

    @staticmethod
    def big_value_with_suffix(value: float, decimals=3, strip_zeros=True) -> str:
        fmt = "%.{0:d}f".format(decimals)
        for threshold, si in _VALUE_SCALES:
            if abs(value) >= threshold:
                result, suffix = locale.format_string(fmt, value / threshold), si
                break
        else:
            result, suffix = locale.format_string(fmt, value), ""

        if strip_zeros:
            result = result.rstrip("0").rstrip(Formatter.local_decimal_seperator())
        return result + suffix

    @staticmethod
    def str2val(str_val, dtype, default=0):
        try:
            return dtype(str_val)
        except (ValueError, TypeError):
            logger.warning("The {0} is not a valid {1}, assuming {2}".format(
                str_val, str(dtype), str(default)))
            return default
