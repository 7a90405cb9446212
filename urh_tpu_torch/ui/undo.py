"""Headless undo/redo framework (PyTorch port of urh_tpu.ui.undo).

Replaces the reference's QUndoStack/QUndoCommand machinery
(PyQt6.QtGui.QUndoStack used throughout controller/ and models/, e.g.
models/TableModel.py:52) with a framework-agnostic command stack so every
editing workflow is scriptable and testable without a GUI toolkit.
"""

from __future__ import annotations

from urh_tpu_torch.util.events import Event


class UndoCommand:
    """Base class: subclasses implement redo() and undo(); ``text`` is the
    human-readable action description shown in menus/logs."""

    def __init__(self, text: str = ""):
        self.text = text

    def set_text(self, text: str):
        self.text = text

    # pragma-style no-ops so bare commands are harmless
    def redo(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def undo(self):  # pragma: no cover - abstract
        raise NotImplementedError


class UndoStack:
    """Linear undo stack with Qt-compatible semantics: push() executes the
    command (calls redo()), undo()/redo() walk the index, pushing while not
    at the top discards the redoable tail."""

    def __init__(self):
        self._commands = []
        self._index = 0  # number of commands currently applied
        self._clean_index = 0
        self.index_changed = Event(int)
        self.clean_changed = Event(bool)

    # -- state -------------------------------------------------------------
    @property
    def count(self) -> int:
        return len(self._commands)

    @property
    def index(self) -> int:
        return self._index

    def can_undo(self) -> bool:
        return self._index > 0

    def can_redo(self) -> bool:
        return self._index < len(self._commands)

    @property
    def undo_text(self) -> str:
        return self._commands[self._index - 1].text if self.can_undo() else ""

    @property
    def redo_text(self) -> str:
        return self._commands[self._index].text if self.can_redo() else ""

    def is_clean(self) -> bool:
        return self._index == self._clean_index

    def set_clean(self):
        self._clean_index = self._index
        self.clean_changed.emit(True)

    def command(self, i: int) -> UndoCommand:
        return self._commands[i]

    # -- operations ----------------------------------------------------------
    def push(self, command: UndoCommand):
        """Execute the command and place it on the stack."""
        del self._commands[self._index:]
        if self._clean_index > self._index:
            self._clean_index = -1  # clean state no longer reachable
        command.redo()
        self._commands.append(command)
        self._index += 1
        self.index_changed.emit(self._index)
        self.clean_changed.emit(self.is_clean())

    def undo(self):
        if not self.can_undo():
            return
        self._index -= 1
        self._commands[self._index].undo()
        self.index_changed.emit(self._index)
        self.clean_changed.emit(self.is_clean())

    def redo(self):
        if not self.can_redo():
            return
        self._commands[self._index].redo()
        self._index += 1
        self.index_changed.emit(self._index)
        self.clean_changed.emit(self.is_clean())

    def clear(self):
        self._commands.clear()
        self._index = 0
        self._clean_index = 0
        self.index_changed.emit(0)
        self.clean_changed.emit(True)
