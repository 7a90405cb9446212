"""Simulator flow configuration: the item tree plus bookkeeping.

Behavioral contract: urh/simulator/SimulatorConfiguration.py (Qt
signals).  Restructured: events replace signals, XML item loading goes
through a tag -> class registry instead of an if-chain, and the
``item<index>`` identifier dict for the expression language is built by
one declarative naming pass over the tree.
"""

from __future__ import annotations

import random
import xml.etree.ElementTree as ET
from collections import OrderedDict

from urh_tpu_torch.coding.encodings import Encoding
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.protocol.labels import (FieldType, NUM_LABEL_COLORS, Participant,
                                     ProtocolLabel)
from urh_tpu_torch.sim.items import (ConditionType, SimulatorCounterAction,
                               SimulatorGotoAction, SimulatorItem,
                               SimulatorMessage, SimulatorProtocolLabel,
                               SimulatorRule, SimulatorRuleCondition,
                               SimulatorSleepAction,
                               SimulatorTriggerCommandAction)
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.project import ProjectManager

# XML tag -> item class, for the simple (context-free) items
_TAG_REGISTRY = {
    cls._XML_TAG: cls
    for cls in (SimulatorTriggerCommandAction, SimulatorSleepAction,
                SimulatorCounterAction, SimulatorRule, SimulatorRuleCondition,
                SimulatorGotoAction)
}
# tags consumed by their parent's deserializer, not loaded standalone
_NESTED_TAGS = frozenset(("message", "label", "checksum_label"))


def _identifier_for(item) -> str:
    """Expression-language name of a tree item: ``item<pos>`` with dots
    flattened to underscores; labels append their own name."""
    if isinstance(item, SimulatorProtocolLabel):
        index = item.parent().index()
        suffix = "." + item.name.replace(" ", "_")
    else:
        index = item.index()
        suffix = ""
    return "item" + index.replace(".", "_") + suffix


class SimulatorConfiguration:
    def __init__(self, project_manager: ProjectManager):
        self.rootItem = SimulatorItem()
        self.project_manager = project_manager
        self.broadcast_part = Participant("Broadcast", "Broadcast",
                                          self.project_manager.broadcast_address_hex,
                                          id="broadcast_participant")
        self._active_participants = None
        self.item_dict = OrderedDict()

        self.participants_changed = Event()
        self.item_dict_updated = Event()
        self.active_participants_updated = Event()
        self.items_deleted = Event(list)
        self.items_updated = Event(list)
        self.items_moved = Event(list)
        self.items_added = Event(list)

        for event in (self.items_added, self.items_moved, self.items_updated,
                      self.items_deleted):
            event.connect(lambda *args: self.update_item_dict())
        for event in (self.items_added, self.items_updated, self.items_deleted):
            event.connect(lambda *args: self.update_active_participants())

        # wire the item classes to this config (done by the tab controller
        # in the reference, SimulatorTabController.py:70)
        SimulatorItem.simulator_config = self

    def attach_expression_parser(self, parser):
        SimulatorItem.expression_parser = parser

    # -- participants ----------------------------------------------------------

    @property
    def participants(self):
        return self.project_manager.participants + [self.broadcast_part]

    @property
    def active_participants(self):
        if self._active_participants is None:
            self.update_active_participants()
        return self._active_participants

    def update_active_participants(self):
        messages = self.get_all_messages()
        self._active_participants = [
            part for part in self.project_manager.participants
            if any(msg.participant == part or msg.destination == part
                   for msg in messages)]
        self.active_participants_updated.emit()

    def on_project_updated(self):
        self.broadcast_part.address_hex = self.project_manager.broadcast_address_hex
        known = self.participants
        for msg in self.get_all_messages():
            if msg.participant not in known:
                msg.participant = None
            if msg.destination not in known:
                msg.destination = None
        self.participants_changed.emit()

    # -- device needs -----------------------------------------------------------

    @property
    def rx_needed(self) -> bool:
        return any(getattr(msg.destination, "simulate", False)
                   for msg in self.get_all_messages())

    @property
    def tx_needed(self) -> bool:
        return any(getattr(msg.source, "simulate", False)
                   for msg in self.get_all_messages())

    # -- identifier dict ---------------------------------------------------------

    def update_item_dict(self):
        self.item_dict.clear()
        for item in self.get_all_items():
            name = _identifier_for(item)
            if isinstance(item, SimulatorCounterAction):
                self.item_dict[name + ".counter_value"] = item
            else:
                self.item_dict[name] = item
                if isinstance(item, SimulatorTriggerCommandAction):
                    self.item_dict[name + ".rc"] = item
        self.item_dict_updated.emit()

    # -- validity ---------------------------------------------------------------

    def update_valid_states(self):
        # post-order walk: children validate before their parent
        stack, order = list(self.rootItem.children), []
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children)
        for node in reversed(order):
            node.is_valid = node.validate()

    def protocol_valid(self):
        self.update_valid_states()
        return all(item.is_valid for item in self.get_all_items())

    # -- tree edits ---------------------------------------------------------------

    def add_items(self, items, pos: int, parent_item):
        if parent_item is None:
            parent_item = self.rootItem
        assert isinstance(parent_item, SimulatorItem)
        for item in items:
            parent_item.insert_child(pos, item)
            pos += 1
        self.items_added.emit(items)

    def delete_items(self, items):
        for i, item in enumerate(items):
            if isinstance(item, SimulatorRuleCondition) and item.type == ConditionType.IF:
                items[i] = item.parent()  # deleting IF removes the whole rule
            items[i].delete()
        self.items_deleted.emit(items)

    def move_items(self, items, new_pos: int, new_parent: SimulatorItem):
        if new_parent is None:
            new_parent = self.rootItem
        for item in items:
            if item.parent() is new_parent and item.get_pos() < new_pos:
                new_pos -= 1
            new_parent.insert_child(new_pos, item)
            new_pos += 1
        self.items_moved.emit(items)

    def add_label(self, start: int, end: int, name: str = None,
                  color_index: int = None, type: FieldType = None,
                  parent_item: SimulatorMessage = None):
        assert isinstance(parent_item, SimulatorMessage)
        if color_index is None:
            taken = {p.color_index for p in parent_item.message_type}
            free = [i for i in range(NUM_LABEL_COLORS) if i not in taken]
            color_index = (free[0] if free
                           else random.randint(0, NUM_LABEL_COLORS - 1))

        label = ProtocolLabel(name or "", start, end, color_index, field_type=type)
        sim_label = SimulatorProtocolLabel(label)
        self.add_items([sim_label], -1, parent_item)
        return sim_label

    def n_top_level_items(self):
        return self.rootItem.child_count()

    def consolidate_messages(self):
        """Collapse runs of identical adjacent messages into repeats."""
        redundant, updated = [], []

        item = self.rootItem
        while item is not None:
            if not isinstance(item, SimulatorMessage):
                item = item.next()
                continue

            # swallow following siblings carrying the same bits
            run_end = item
            duplicates = 0
            while (isinstance(run_end.next_sibling(), SimulatorMessage)
                   and item.plain_bits == run_end.next_sibling().plain_bits):
                run_end = run_end.next_sibling()
                redundant.append(run_end)
                duplicates += 1
            if duplicates:
                item.repeat += duplicates
                updated.append(item)
            item = run_end.next()

        self.delete_items(redundant)
        self.items_updated.emit(updated)

    # -- traversal ------------------------------------------------------------------

    def get_all_messages(self):
        return [item for item in self.get_all_items()
                if isinstance(item, SimulatorMessage)]

    def get_all_items(self):
        """Pre-order traversal of the whole tree (root excluded)."""
        items = []
        stack = list(reversed(self.rootItem.children))
        while stack:
            node = stack.pop()
            items.append(node)
            stack.extend(reversed(node.children))
        return items

    # -- persistence -------------------------------------------------------------------

    def load_from_xml(self, xml_tag: ET.Element, message_types):
        assert xml_tag.tag == "simulator_config"

        section_loaders = (
            ("modulators", self._load_modulators),
            ("participants", self._load_participants),
            ("decodings", self._load_decodings),
            ("simulator_rx_conf",
             lambda tag: ProjectManager.read_device_conf_dict(
                 tag, self.project_manager.simulator_rx_conf)),
            ("simulator_tx_conf",
             lambda tag: ProjectManager.read_device_conf_dict(
                 tag, self.project_manager.simulator_tx_conf)),
        )
        for section, loader in section_loaders:
            tag = xml_tag.find(section)
            if tag is not None:
                loader(tag)

        items = [self.load_item_from_xml(child_tag, message_types)
                 for child_tag in xml_tag.find("items")]
        self.add_items(items, pos=0, parent_item=None)

    def _load_modulators(self, tag):
        self.project_manager.modulators = Modulator.modulators_from_xml_tag(tag)

    def _load_participants(self, tag):
        for participant in Participant.read_participants_from_xml_tag(tag):
            if participant not in self.project_manager.participants:
                self.project_manager.participants.append(participant)
        self.participants_changed.emit()

    def _load_decodings(self, tag):
        self.project_manager.decodings = Encoding.read_decoders_from_xml_tag(tag)

    def load_item_from_xml(self, xml_tag: ET.Element, message_types):
        if xml_tag.tag in _NESTED_TAGS:
            return None
        if xml_tag.tag == SimulatorMessage._XML_TAG:
            item = SimulatorMessage.new_from_xml(
                xml_tag, self.participants, self.project_manager.decodings,
                message_types)
        elif xml_tag.tag == SimulatorProtocolLabel._XML_TAG:
            field_types = {ft.caption: ft for ft in FieldType.default_field_types()}
            item = SimulatorProtocolLabel.from_xml(xml_tag, field_types)
        elif xml_tag.tag in _TAG_REGISTRY:
            item = _TAG_REGISTRY[xml_tag.tag].from_xml(xml_tag)
        else:
            raise ValueError("unknown simulator item tag: {}".format(xml_tag.tag))

        for child_tag in xml_tag:
            child = self.load_item_from_xml(child_tag, message_types)
            if child is not None:
                item.add_child(child)
        return item

    def save_to_xml(self, standalone=False) -> ET.Element:
        result = ET.Element("simulator_config")
        if standalone:
            pm = self.project_manager
            result.append(Modulator.modulators_to_xml_tag(pm.modulators))
            result.append(Encoding.decodings_to_xml_tag(pm.decodings))
            result.append(Participant.participants_to_xml_tag(pm.participants))
            result.append(ProjectManager._device_conf_dict_to_xml(
                "simulator_rx_conf", pm.simulator_rx_conf))
            result.append(ProjectManager._device_conf_dict_to_xml(
                "simulator_tx_conf", pm.simulator_tx_conf))

        items_tag = ET.SubElement(result, "items")
        for item in self.rootItem.children:
            self._save_item_to_xml(items_tag, item)
        return result

    def _save_item_to_xml(self, tag: ET.Element, item):
        if isinstance(item, SimulatorMessage):
            child_tag = item.to_xml(decoders=self.project_manager.decodings,
                                    include_message_type=True, write_bits=True)
        else:
            child_tag = item.to_xml()
        tag.append(child_tag)
        for child in item.children:
            self._save_item_to_xml(child_tag, child)
