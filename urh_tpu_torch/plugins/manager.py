"""Plugin framework: base classes and discovery/enable management
(PyTorch port of urh_tpu.plugins.manager).

A ``Plugin`` carries a name, a description, an enabled flag and
per-plugin settings read from and written to the settings store
(reference: plugins/Plugin.py:11-87); a ``ProtocolPlugin`` contributes
undoable actions to the analysis table, an ``SDRPlugin`` a device
backend, a ``SignalEditorPlugin`` signal-editing operations.
``PluginManager`` discovers the installed plugin classes, restores their
enabled state from the store (PluginManager.py:31-38) and answers
``is_plugin_enabled`` / ``get_plugin_by_name`` (PluginManager.py:54-60).
"""

from __future__ import annotations

from urh_tpu_torch.util import settings
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.logging import logger


class Plugin:
    """Base plugin: name, description, enabled state."""

    def __init__(self, name: str):
        self.name = name
        self.description = ""
        self.enabled_changed = Event()
        self.__enabled = False

    @property
    def enabled(self) -> bool:
        return self.__enabled

    @enabled.setter
    def enabled(self, value: bool):
        value = bool(value)
        if value != self.__enabled:
            self.__enabled = value
            self.enabled_changed.emit()

    def _settings_key(self, key: str) -> str:
        return "plugin.{}.{}".format(self.name, key)

    def read_setting(self, key: str, default=None, type=str):
        return settings.read(self._settings_key(key), default, type=type)

    def write_setting(self, key: str, value):
        settings.write(self._settings_key(key), value)

    def load_description(self):
        """Reference plugins ship a descr.txt next to the module
        (Plugin.py:50-56); here descriptions are class docstrings."""
        if not self.description:
            import sys
            doc = self.__class__.__doc__
            if not doc:
                module = sys.modules.get(self.__class__.__module__)
                doc = getattr(module, "__doc__", "") if module else ""
            self.description = (doc or "").strip()

    def create_connects(self):
        pass


class ProtocolPlugin(Plugin):
    """Plugin contributing an undoable action on the protocol table
    (Plugin.py:64-76)."""

    def get_action(self, protocol, *args, **kwargs):
        raise NotImplementedError("Abstract Method.")


class SDRPlugin(Plugin):
    pass


class SignalEditorPlugin(Plugin):
    pass


class PluginManager:
    """Discover installed plugins and manage their enabled state."""

    def __init__(self):
        self.installed_plugins = self.load_installed_plugins()

    @property
    def protocol_plugins(self):
        return [p for p in self.installed_plugins if isinstance(p, ProtocolPlugin)]

    @property
    def signal_editor_plugins(self):
        return [p for p in self.installed_plugins if isinstance(p, SignalEditorPlugin)]

    def load_installed_plugins(self):
        from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin
        from urh_tpu_torch.plugins.flipper_zero_sub import FlipperZeroSubPlugin
        from urh_tpu_torch.plugins.insert_sine import InsertSinePlugin
        from urh_tpu_torch.plugins.message_break import MessageBreakPlugin
        from urh_tpu_torch.plugins.rfcat import RfCatPlugin
        from urh_tpu_torch.plugins.zero_hide import ZeroHidePlugin

        result = []
        for cls in (FlipperZeroSubPlugin, InsertSinePlugin, MessageBreakPlugin,
                    NetworkSDRInterfacePlugin, RfCatPlugin, ZeroHidePlugin):
            try:
                plugin = cls()
            except Exception as e:
                logger.warning("could not instantiate plugin {}: {}".format(
                    cls.__name__, e))
                continue
            if not isinstance(plugin, Plugin):
                plugin = _wrap_legacy(plugin)
            plugin.load_description()
            key = "plugin.{}.enabled".format(plugin.name)
            if key in settings.all_keys():
                plugin.enabled = settings.read(key, False, type=bool)
            else:
                plugin.enabled = False
            result.append(plugin)
        return result

    def save_enabled_states(self):
        for plugin in self.installed_plugins:
            settings.write("plugin.{}.enabled".format(plugin.name), plugin.enabled)

    def is_plugin_enabled(self, plugin_name: str) -> bool:
        return any(plugin_name == p.name
                   for p in self.installed_plugins if p.enabled)

    def get_plugin_by_name(self, plugin_name: str):
        for plugin in self.installed_plugins:
            if plugin.name == plugin_name:
                return plugin
        return None


def _wrap_legacy(obj):
    """Adapt a plain plugin object (no Plugin base) into the framework."""
    plugin = Plugin(getattr(obj, "name", obj.__class__.__name__))
    plugin.wrapped = obj
    plugin.description = (obj.__class__.__doc__ or "").strip()
    return plugin
