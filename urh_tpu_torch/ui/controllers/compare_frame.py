"""Analysis-tab controller (headless CompareFrameController).

Re-design of controller/CompareFrameController.py (1,883 LoC): aggregates
the protocols of all signal frames into one merged analyzer, manages
decodings, participants, message types, label creation from table
selections, diff view, search, alignment, and awre auto-labeling —
without any Qt widgets.

PyTorch port of urh_tpu.ui.controllers.compare_frame: awre runs on the
controller's device (default: the CUDA card).
"""

from __future__ import annotations

import os

from urh_tpu_torch.coding.encodings import Encoding
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.protocol.labels import FieldType, MessageType
from urh_tpu_torch.ui.models import (LabelValueTableModel, MessageTypeTableModel,
                                     ParticipantListModel, ProtocolTableModel,
                                     ProtocolTreeModel)
from urh_tpu_torch.util import placement
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.project import ProjectManager


class CompareFrameController:
    def __init__(self, project_manager: ProjectManager = None, device=None):
        self.device = placement.requested(device)
        self.project_manager = project_manager or ProjectManager()
        if len(self.project_manager.decodings) <= 1:
            self.project_manager.load_decodings()

        self.proto_tree_model = ProtocolTreeModel()
        self.proto_analyzer = ProtocolAnalyzer(None)  # merged view
        self.proto_analyzer.message_types = [MessageType("Default")]

        self.protocol_model = ProtocolTableModel(
            self.proto_analyzer, self.project_manager.participants, controller=self)
        self.label_value_model = LabelValueTableModel(self.proto_analyzer,
                                                      controller=self)
        self.participant_list_model = ParticipantListModel(
            self.project_manager.participants)
        self.message_type_table_model = MessageTypeTableModel(
            self.proto_analyzer.message_types)

        self.field_types = FieldType.default_field_types()
        self._active_message_type = self.proto_analyzer.default_message_type
        self.protocols_updated = Event()

        self.proto_tree_model.proto_to_group_added.connect(
            lambda _gid: self.set_shown_protocols())
        self.proto_tree_model.group_deleted.connect(
            lambda *_: self.set_shown_protocols())

    # -- basic accessors ---------------------------------------------------
    @property
    def decodings(self):
        return self.project_manager.decodings

    @property
    def participants(self):
        return self.project_manager.participants

    @property
    def protocol_list(self):
        return self.proto_tree_model.protocol_list

    @property
    def active_message_type(self) -> MessageType:
        return self._active_message_type

    @active_message_type.setter
    def active_message_type(self, value: MessageType):
        if value in self.proto_analyzer.message_types:
            self._active_message_type = value

    @property
    def field_types_by_caption(self):
        return {ft.caption: ft for ft in self.field_types}

    @property
    def protocol_undo_stack(self):
        return self.protocol_model.undo_stack

    # -- protocol management -------------------------------------------------
    def add_protocol(self, protocol: ProtocolAnalyzer, group_id: int = 0):
        """(CompareFrameController.py:552-566)"""
        self.proto_tree_model.add_protocol(protocol, group_id)
        protocol.message_types = self.proto_analyzer.message_types
        self.set_shown_protocols()
        return protocol

    def add_protocol_from_file(self, filename: str) -> ProtocolAnalyzer:
        """Load a .proto.xml into a new analyzer (CFC:568-604)."""
        pa = ProtocolAnalyzer(None)
        pa.name = os.path.splitext(os.path.basename(filename))[0]
        pa.from_xml_file(filename=filename, read_bits=True)
        for messsage_type in pa.message_types:
            if messsage_type not in self.proto_analyzer.message_types:
                self.proto_analyzer.message_types.append(messsage_type)
        self.add_protocol(pa)
        return pa

    def add_sniffed_protocol_messages(self, messages: list):
        """(CFC:606-616)"""
        if len(messages) == 0:
            return
        pa = ProtocolAnalyzer(None)
        pa.name = "Sniffed"
        pa.messages.extend(messages)
        self.add_protocol(pa, group_id=self.proto_tree_model.ngroups - 1)

    def remove_protocol(self, protocol: ProtocolAnalyzer):
        self.proto_tree_model.remove_protocol(protocol)
        self.set_shown_protocols()

    def set_shown_protocols(self):
        """Rebuild the merged analyzer from visible tree protocols and apply
        participant/message-type row visibility (CFC:683-780)."""
        self.proto_analyzer.messages = [
            msg for grp in self.proto_tree_model.groups
            for child in grp.children
            if getattr(child, "show", True)
            for msg in child.protocol.messages]
        for msg in self.proto_analyzer.messages:
            if msg.message_type not in self.proto_analyzer.message_types:
                msg.message_type = self.proto_analyzer.default_message_type

        hidden = set()
        for i, msg in enumerate(self.proto_analyzer.messages):
            if msg.participant is not None and not msg.participant.show:
                hidden.add(i)
            elif msg.message_type is not None and not msg.message_type.show:
                hidden.add(i)
        self.protocol_model.hidden_rows = hidden
        self.protocol_model.update()
        self.protocols_updated.emit()

    def rows_for_protocol(self, protocol: ProtocolAnalyzer) -> list:
        """Row span of one source protocol inside the merged table."""
        rows, offset = [], 0
        for grp in self.proto_tree_model.groups:
            for child in grp.children:
                if not getattr(child, "show", True):
                    continue
                n = len(child.protocol.messages)
                if child.protocol is protocol:
                    return list(range(offset, offset + n))
                offset += n
        return rows

    # -- decodings --------------------------------------------------------------
    def set_decoding(self, decoding: Encoding, messages=None):
        """Apply a decoder to messages (default: all) (CFC:444-505)."""
        messages = messages if messages is not None else self.proto_analyzer.messages
        for msg in messages:
            msg.decoder = decoding
        self.proto_analyzer.update_auto_message_types()
        self.protocol_model.update()
        self.label_value_model_update()

    def refresh_existing_encodings(self):
        """Re-point message decoders at refreshed project decodings by name
        (CFC:510-533)."""
        decodings_by_name = {d.name: d for d in self.decodings}
        for msg in self.proto_analyzer.messages:
            if msg.decoder.name in decodings_by_name:
                msg.decoder = decodings_by_name[msg.decoder.name]
        self.protocol_model.update()

    # -- labels -----------------------------------------------------------------
    def add_protocol_label(self, start: int, end: int, messagenr: int,
                           proto_view: int, edit_label_name: bool = False):
        """Create a label on the active message type from a table selection;
        returns the new label or False on overlap (CFC:618-658)."""
        try:
            start, end = self.proto_analyzer.messages[messagenr].convert_range(
                start, end, proto_view, 0, decoded=True)
        except IndexError:
            return False
        proto_label = self.active_message_type.add_protocol_label(
            start=start, end=end)
        self.label_value_model_update()
        self.protocol_model.update()
        return proto_label

    def add_message_type(self, selected_messages: list = None):
        """(CFC:660-671)"""
        self.proto_analyzer.add_new_message_type(
            labels=self.proto_analyzer.default_message_type)
        new_type = self.proto_analyzer.message_types[-1]
        self.active_message_type = new_type
        for msg in selected_messages or []:
            msg.message_type = new_type
        self.protocol_model.update()
        return new_type

    def get_labels_from_selection(self, row_start: int, row_end: int,
                                  col_start: int, col_end: int) -> list:
        """Labels intersecting a rectangular table selection (CFC:1255-1289)."""
        labels = []
        for i in range(row_start, row_end + 1):
            try:
                msg = self.proto_analyzer.messages[i]
            except IndexError:
                continue
            for lbl in msg.message_type:
                lbl_start, lbl_end = msg.get_label_range(
                    lbl, self.protocol_model.proto_view, True)
                if any(lbl_start <= j < lbl_end for j in range(col_start, col_end + 1)):
                    if lbl not in labels:
                        labels.append(lbl)
        return labels

    def label_value_model_update(self):
        # keep the label-value model pointed at the merged analyzer
        self.label_value_model.proto_analyzer = self.proto_analyzer

    # -- views ----------------------------------------------------------------------
    def show_differences(self, refindex: int):
        self.protocol_model.refindex = refindex

    def hide_differences(self):
        self.protocol_model.refindex = -1

    # -- column visibility (show-only modes, CFC:1141-1253) ---------------------
    def visible_columns_for_labels(self) -> set:
        """Columns covered by shown labels across all messages
        (show_only_labels, CFC:1174-1184)."""
        visible_columns = set()
        for msg in self.proto_analyzer.messages:
            for lbl in filter(lambda lbl: lbl.show, msg.message_type):
                start, end = msg.get_label_range(
                    lbl=lbl, view=self.protocol_model.proto_view, decode=True)
                visible_columns |= set(range(start, end))
        return visible_columns

    def visible_columns_for_diffs(self) -> set:
        """Columns differing from the reference row over visible rows
        (show_only_diffs, CFC:1186-1204)."""
        model = self.protocol_model
        return {col
                for i in range(model.row_count)
                if i not in model.hidden_rows and i != model.refindex
                for col in model.diffs[i]}

    def get_visible_columns(self, show_only_labels: bool = False,
                            show_only_diffs: bool = False) -> set:
        """Visible-column set for the four show-only checkbox combinations
        (set_show_only_status, CFC:1141-1172).  Enabling show-only-diffs
        implicitly enables the diff view against the current refindex."""
        model = self.protocol_model
        if show_only_diffs and model.refindex < 0:
            self.show_differences(0)
        all_columns = set(range(model.col_count))
        if show_only_labels and show_only_diffs:
            return self.visible_columns_for_labels() & self.visible_columns_for_diffs()
        if show_only_labels:
            return self.visible_columns_for_labels()
        if show_only_diffs:
            return self.visible_columns_for_diffs()
        return all_columns

    def search(self, value: str) -> list:
        self.protocol_model.find_protocol_value(value)
        return self.protocol_model.search_results

    def align_messages(self, pattern: str, view_type: int = None):
        view = self.protocol_model.proto_view if view_type is None else view_type
        self.proto_analyzer.align_messages(pattern, view_type=view)
        self.protocol_model.update()

    # -- automation --------------------------------------------------------------------
    def run_format_finder(self):
        """awre auto field inference over the merged messages (CFC's
        "Analyze" button, CFC:1338-1385)."""
        self.proto_analyzer.auto_assign_labels(device=self.device)
        self.message_type_table_model.message_types = self.proto_analyzer.message_types
        if self.proto_analyzer.message_types:
            self._active_message_type = self.proto_analyzer.message_types[0]
        self.protocol_model.update()
        self.label_value_model_update()

    def update_automatic_assigned_message_types(self):
        self.proto_analyzer.update_auto_message_types()
        self.protocol_model.update()
