"""Headless widget controllers: the logic half of the reference's dialog
widgets (controller/widgets/ChecksumWidget.py, dialogs/
FilterBandwidthDialog.py, dialogs/CostaOptionsDialog.py), minus Qt
(PyTorch port of urh_tpu.ui.widgets).  The filter dialog's choices are
written to the settings store, urh_tpu's file, which both packages read."""

from __future__ import annotations

import array
from collections import OrderedDict

from urh_tpu_torch.coding.crc import GenericCRC
from urh_tpu_torch.coding.wsp import WSPChecksum
from urh_tpu_torch.dsp.filters import Filter
from urh_tpu_torch.protocol.labels import ChecksumLabel
from urh_tpu_torch.util.misc import convert_bits_to_string


def bit2hex(bits) -> str:
    return convert_bits_to_string(bits, 1, pad_zeros=True)


class ChecksumWidgetController:
    """Configure a ChecksumLabel: data ranges, CRC function/polynomial/
    start value/final XOR, category (generic CRC vs EnOcean WSP)
    (ChecksumWidget.py:25-380)."""

    SPECIAL_CRCS = OrderedDict([
        ("CC1101", GenericCRC(polynomial="16_standard", start_value=True)),
    ])

    def __init__(self, checksum_label: ChecksumLabel, message, proto_view: int = 0):
        self.checksum_label = checksum_label
        self.message = message
        self.proto_view = proto_view

    # -- data range table ----------------------------------------------------
    @property
    def data_ranges(self):
        return self.checksum_label.data_ranges

    @property
    def row_count(self) -> int:
        return len(self.data_ranges)

    def range_at(self, row: int):
        """(start, end) in the current view, 1-based start for display
        (RangeTableModel.data, ChecksumWidget.py:72-92)."""
        start, end = self.data_ranges[row]
        if self.message is not None:
            start = self.message.convert_index(start, 0, self.proto_view, True)[0]
            end = self.message.convert_index(end, 0, self.proto_view, True)[0]
        return int(start) + 1, int(end)

    def set_range(self, row: int, start: int = None, end: int = None) -> bool:
        """Edit a range (1-based start, like the table view)."""
        if start is not None:
            bit_start = self.message.convert_index(
                int(start) - 1, self.proto_view, 0, True)[0] if self.message else int(start) - 1
            self.data_ranges[row][0] = int(bit_start)
        if end is not None:
            bit_end = self.message.convert_index(
                int(end), self.proto_view, 0, True)[0] if self.message else int(end)
            self.data_ranges[row][1] = int(bit_end)
        return True

    def add_range(self):
        """(ChecksumWidget.py:349-351)"""
        self.checksum_label.data_ranges.append([0, self.checksum_label.start])

    def remove_range(self):
        """Last range is never removed (ChecksumWidget.py:354-357)."""
        if len(self.checksum_label.data_ranges) > 1:
            self.checksum_label.data_ranges.pop(-1)

    # -- CRC configuration ------------------------------------------------------
    @property
    def crc_function_names(self):
        return list(GenericCRC.DEFAULT_POLYNOMIALS) + list(self.SPECIAL_CRCS)

    def set_crc_function(self, index_or_name):
        """(ChecksumWidget.py:360-380)"""
        name = (self.crc_function_names[index_or_name]
                if isinstance(index_or_name, int) else index_or_name)
        checksum = self.checksum_label.checksum
        if name in GenericCRC.DEFAULT_POLYNOMIALS:
            checksum.polynomial = checksum.choose_polynomial(name)
            n = len(checksum.polynomial) - 1
            checksum.start_value = array.array("B", [0] * n)
            checksum.final_xor = array.array("B", [0] * n)
        elif name in self.SPECIAL_CRCS:
            import copy
            self.checksum_label.checksum = copy.deepcopy(self.SPECIAL_CRCS[name])

    @property
    def polynomial_hex(self) -> str:
        return self.checksum_label.checksum.polynomial_as_hex_str

    def set_polynomial_from_hex(self, hex_str: str):
        self.checksum_label.checksum.set_polynomial_from_hex(hex_str)

    @property
    def start_value_hex(self) -> str:
        return bit2hex(self.checksum_label.checksum.start_value)

    @property
    def final_xor_hex(self) -> str:
        return bit2hex(self.checksum_label.checksum.final_xor)

    # -- category / WSP -----------------------------------------------------------
    @property
    def categories(self):
        return [member.value for member in ChecksumLabel.Category]

    @property
    def category(self) -> str:
        return self.checksum_label.category.value

    def set_category(self, value: str):
        self.checksum_label.category = ChecksumLabel.Category(value)

    def set_wsp_mode(self, mode: str):
        """mode in ('auto', 'checksum4', 'checksum8', 'crc8')"""
        self.checksum_label.category = ChecksumLabel.Category.wsp
        self.checksum_label.checksum = WSPChecksum(
            mode=WSPChecksum.ChecksumMode[mode])


class FilterBandwidthController:
    """Bandwidth <-> kernel length coupling of the bandpass filter dialog
    (FilterBandwidthDialog.py)."""

    def __init__(self):
        from urh_tpu_torch.util import settings
        self.custom_bandwidth = settings.read("bandpass_filter_custom_bw", 0.1, float)
        self.bandwidth_type = settings.read("bandpass_filter_bw_type", "Medium", str)

    @property
    def custom_kernel_length(self) -> int:
        return Filter.get_filter_length_from_bandwidth(self.custom_bandwidth)

    @custom_kernel_length.setter
    def custom_kernel_length(self, n: int):
        self.custom_bandwidth = Filter.get_bandwidth_from_filter_length(int(n))

    @property
    def kernel_length_by_name(self) -> dict:
        return {name: Filter.get_filter_length_from_bandwidth(bw)
                for name, bw in Filter.BANDWIDTHS.items()}

    def save(self):
        from urh_tpu_torch.util import settings
        settings.write("bandpass_filter_custom_bw", self.custom_bandwidth)
        settings.write("bandpass_filter_bw_type", self.bandwidth_type)


class CostaOptionsController:
    """PSK Costas loop bandwidth option (CostaOptionsDialog.py)."""

    def __init__(self, loop_bandwidth: float):
        self.costas_loop_bandwidth = loop_bandwidth

    def set_bandwidth(self, value: float):
        self.costas_loop_bandwidth = float(value)
