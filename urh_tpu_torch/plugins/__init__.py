"""Plugin system (PyTorch port of urh_tpu.plugins).

The Network SDR plugin lives in urh_tpu_torch.dev.network_sdr (it doubles
as a device backend); the remaining plugins are here: InsertSine,
MessageBreak, ZeroHide, FlipperZeroSub and RfCat.
"""

from urh_tpu_torch.plugins.insert_sine import InsertSinePlugin
from urh_tpu_torch.plugins.manager import (Plugin, PluginManager, ProtocolPlugin,
                                           SDRPlugin, SignalEditorPlugin)
from urh_tpu_torch.plugins.message_break import MessageBreakAction, MessageBreakPlugin
from urh_tpu_torch.plugins.zero_hide import ZeroHideAction, ZeroHidePlugin
from urh_tpu_torch.plugins.flipper_zero_sub import FlipperZeroSubPlugin
from urh_tpu_torch.plugins.rfcat import RfCatPlugin


def get_installed_plugins():
    return [InsertSinePlugin(), MessageBreakPlugin(), ZeroHidePlugin(),
            FlipperZeroSubPlugin(), RfCatPlugin()]
