"""Simulator-tab controller (headless SimulatorTabController).

Re-design of controller/SimulatorTabController.py: owns the simulator
configuration (item tree), builds simulator messages from analysis/generator
protocols, validates label formulas, and starts/stops simulations against
live or network devices.

PyTorch port of urh_tpu.ui.controllers.simulator_tab: the simulator
synthesizes its messages on the controller's device (default: the CUDA
card); the SDRs it talks to are its sniffer's and sender's.
"""

from __future__ import annotations

from urh_tpu_torch.sim.configuration import SimulatorConfiguration
from urh_tpu_torch.sim.expression_parser import SimulatorExpressionParser
from urh_tpu_torch.sim.items import (ConditionType, SimulatorGotoAction,
                                     SimulatorMessage, SimulatorProtocolLabel,
                                     SimulatorRule, SimulatorRuleCondition)
from urh_tpu_torch.ui.models import (SimulatorMessageFieldModel,
                                     SimulatorMessageTableModel)
from urh_tpu_torch.util import placement


class SimulatorTabController:
    def __init__(self, compare_frame_controller=None, generator_tab_controller=None,
                 project_manager=None, device=None):
        from urh_tpu_torch.util.project import ProjectManager
        self.device = placement.requested(device)
        self.compare_frame_controller = compare_frame_controller
        self.generator_tab_controller = generator_tab_controller
        self.project_manager = (project_manager if project_manager is not None
                                else ProjectManager())

        self.simulator_config = SimulatorConfiguration(self.project_manager)
        self.sim_expression_parser = SimulatorExpressionParser(self.simulator_config)
        self.simulator_config.attach_expression_parser(self.sim_expression_parser)

        self.simulator_message_table_model = SimulatorMessageTableModel(
            self.simulator_config)
        self.simulator_message_field_model = SimulatorMessageFieldModel(self)
        self.simulator = None

    # -- building the flow graph ----------------------------------------------
    @property
    def messages(self):
        return self.simulator_config.get_all_messages()

    def detect_source_destination(self, message):
        """Source = message participant; destination = the *other*
        participant, or broadcast (SimulatorScene.py:596-625)."""
        participants = self.simulator_config.participants
        source = None if len(participants) < 2 else participants[0]
        destination = self.simulator_config.broadcast_part
        if message.participant:
            source = message.participant
            other = next((p for p in participants
                          if p is not source and p is not self.simulator_config.broadcast_part),
                         None)
            if other is not None:
                destination = other
        return source, destination

    def create_simulator_message(self, msg, source=None, destination=None):
        """Analyzer message -> simulator message with per-label
        SimulatorProtocolLabels (SimulatorScene.create_message:536-555)."""
        import copy
        from urh_tpu_torch.protocol.labels import MessageType
        if destination is None:
            destination = self.simulator_config.broadcast_part
        sim_msg = SimulatorMessage(
            destination=destination, plain_bits=copy.copy(msg.decoded_bits),
            pause=0, message_type=MessageType(msg.message_type.name),
            decoder=msg.decoder, source=source)
        for lbl in msg.message_type:
            sim_msg.insert_child(-1, SimulatorProtocolLabel(copy.deepcopy(lbl)))
        return sim_msg

    def add_protocol_messages(self, messages, pos: int = -1, parent_item=None):
        """Convert analyzer messages to simulator messages and append them
        to the item tree (SimulatorScene.add_protocols:562-594)."""
        parent = parent_item if parent_item is not None else self.simulator_config.rootItem
        if pos == -1:
            pos = parent.child_count()
        sim_messages = []
        for msg in messages:
            source, destination = self.detect_source_destination(msg)
            sim_messages.append(self.create_simulator_message(msg, source, destination))
        self.simulator_config.add_items(sim_messages, pos, parent)
        self.simulator_message_table_model.update()
        return sim_messages

    def add_rule(self, parent_item=None):
        rule = SimulatorRule()
        parent = parent_item if parent_item is not None else self.simulator_config.rootItem
        self.simulator_config.add_items([rule], len(parent.children), parent)
        condition = SimulatorRuleCondition(ConditionType.IF)
        self.simulator_config.add_items([condition], 0, rule)
        return rule

    def add_goto_action(self, goto_target=None, parent_item=None):
        action = SimulatorGotoAction()
        if goto_target is not None:
            action.goto_target = goto_target
        parent = parent_item if parent_item is not None else self.simulator_config.rootItem
        self.simulator_config.add_items([action], len(parent.children), parent)
        return action

    # -- validation --------------------------------------------------------------
    def validate_formula(self, formula: str):
        valid, message, _ = self.sim_expression_parser.validate_expression(
            formula, is_formula=True)
        return valid, message

    # -- running ------------------------------------------------------------------
    def get_simulator(self, sniffer=None, sender=None, modulators=None):
        from urh_tpu_torch.sim.simulator import Simulator
        modulators = modulators if modulators is not None else (
            self.generator_tab_controller.modulators
            if self.generator_tab_controller else [])
        self.simulator = Simulator(self.simulator_config, modulators,
                                   self.sim_expression_parser,
                                   self.project_manager, sniffer, sender,
                                   device=self.device)
        return self.simulator

    def start_simulation(self, **kwargs):
        sim = self.get_simulator(**kwargs)
        sim.start()
        return sim

    def stop_simulation(self):
        if self.simulator is not None:
            self.simulator.stop()

    # -- persistence ------------------------------------------------------------------
    def save_simulator_file(self, filename: str):
        import xml.etree.ElementTree as ET
        tag = self.simulator_config.save_to_xml(standalone=True)
        ET.ElementTree(tag).write(filename)

    def load_simulator_file(self, filename: str):
        import xml.etree.ElementTree as ET
        tree = ET.parse(filename)
        message_types = (self.compare_frame_controller.proto_analyzer.message_types
                         if self.compare_frame_controller else [])
        self.simulator_config.load_from_xml(tree.getroot(), message_types)
        self.simulator_message_table_model.update()
