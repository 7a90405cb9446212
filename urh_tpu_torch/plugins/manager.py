"""Plugin base classes (the first part of urh_tpu.plugins.manager).

A ``Plugin`` carries a name, a description, an enabled flag and
per-plugin settings read from and written to the settings store
(reference: plugins/Plugin.py:11-87); an ``SDRPlugin`` contributes a
device backend.
"""

from __future__ import annotations

from urh_tpu_torch.util import settings
from urh_tpu_torch.util.events import Event


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


class SDRPlugin(Plugin):
    pass
