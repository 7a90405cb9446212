"""Stateful protocol simulation against live devices.

Behavioral contract: urh/simulator/Simulator.py (a 100-line
isinstance-chain walking the item tree).  Re-architected as an explicit
state machine: item type -> step handler via a dispatch table, each
handler returning the successor item; RX failures route through an
error-policy table (resend / stop / restart); expressions are compiled
once by the parser's cache, so repeated rounds never re-parse.
TX label values, checksum patching and RX matching are split into
focused helpers shared by the handlers.

In the port every answer is synthesized by ``Modulator.modulate`` on
``device`` (default: the CUDA card), and every awaited message comes out
of the sniffer's stream on the sniffer's ``compute_device``.
"""

from __future__ import annotations

import array
import datetime
import re
import threading
import time

import numpy

from urh_tpu_torch.core.iq import resolve_device
from urh_tpu_torch.dev.backend_handler import Backends
from urh_tpu_torch.protocol.labels import ChecksumLabel
from urh_tpu_torch.protocol.message import Message
from urh_tpu_torch.sim.items import (ConditionType, SimulatorCounterAction,
                               SimulatorGotoAction, SimulatorItem,
                               SimulatorMessage, SimulatorProtocolLabel,
                               SimulatorRule, SimulatorRuleCondition,
                               SimulatorSleepAction,
                               SimulatorTriggerCommandAction, Transcript)
from urh_tpu_torch.util import misc as util
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.logging import logger

_COUNTER_REF = re.compile(r"(item[0-9]+\.counter_value)")

# value_type_index semantics of SimulatorProtocolLabel
_VALUE_CONSTANT, _VALUE_LIVE, _VALUE_FORMULA, _VALUE_EXTERNAL, _VALUE_RANDOM = range(5)


class Simulator:
    def __init__(self, simulator_config, modulators, expression_parser,
                 project_manager, sniffer, sender, device=None):
        self.simulator_config = simulator_config
        self.device = resolve_device(device)
        self.project_manager = project_manager
        self.expression_parser = expression_parser
        self.modulators = modulators

        self.simulation_started = Event()
        self.simulation_stopped = Event()

        self.transcript = Transcript()

        # machine position / bookkeeping
        self.current_item, self.last_sent_message = None, None
        self.is_simulating = self.do_restart = False
        self.current_repeat, self.log_messages = 0, []

        # device readiness
        self.sniffer_ready = self.sender_ready = False
        self.fatal_device_error_occurred = False
        self.verbose = True

        self.sniffer = sniffer
        self.sender = sender

        self._message_sniffed_event = threading.Event()
        if self.sniffer is not None:
            self.sniffer.message_sniffed.connect(self._on_message_sniffed)

    # ------------------------------------------------------------------ setup

    def _on_message_sniffed(self, index):
        self._message_sniffed_event.set()

    def start(self):
        self.reset()
        self.transcript.clear()
        for item in self.simulator_config.get_all_items():
            if isinstance(item, SimulatorCounterAction):
                item.reset_value()

        for device, ready_handler in ((self.sniffer and self.sniffer.rcv_device,
                                       self.on_sniffer_ready),
                                      (self.sender and self.sender.device,
                                       self.on_sender_ready)):
            if device:
                device.fatal_error_occurred.connect(self.stop_on_error)
                device.ready_for_action.connect(ready_handler)

        if self.sniffer:
            self.sniffer.sniff()
        if self.sender:
            self.sender.start()

        self.simulation_thread = threading.Thread(target=self.simulate, daemon=True)
        self.simulation_thread.start()
        time.sleep(0.1)

    def stop_on_error(self, msg: str):
        self.fatal_device_error_occurred = True
        if self.is_simulating:
            self.stop(msg=msg)

    def on_sniffer_ready(self):
        if not self.sniffer_ready:
            self.log_message("RX is ready to operate")
            self.sniffer_ready = True

    def on_sender_ready(self):
        if not self.sender_ready:
            self.log_message("TX is ready to operate")
            self.sender_ready = True

    def stop(self, msg=""):
        self.simulation_stopped.emit()
        if self.is_simulating:
            suffix = " ({})".format(msg.strip()) if msg else ""
            self.log_message("Stop simulation" + suffix)
            self.is_simulating = self.do_restart = False
            thread = getattr(self, "simulation_thread", None)
            if thread is not None and thread is not threading.current_thread():
                thread.join(2.5)

        for endpoint in (self.sniffer, self.sender):
            if endpoint:
                endpoint.stop()

    def restart(self):
        self.transcript.start_new_round()
        self.reset()
        self.log_message("<b>Restarting simulation</b>")

    def reset(self):
        """Rewind the machine to the root item (Simulator.py:156-186)."""
        self.sniffer_ready = self.sender_ready = False
        self.fatal_device_error_occurred = False

        if self.sniffer:
            self.sniffer.clear()

        for msg in self.simulator_config.get_all_messages():
            del msg.send_recv_messages[:]
        self.current_item = self.simulator_config.rootItem

        self.is_simulating = True
        self.do_restart = False
        self.last_sent_message = None
        self.current_repeat = 0
        del self.log_messages[:]

    @property
    def devices(self):
        endpoints = ((self.sniffer, "rcv_device"), (self.sender, "device"))
        return [getattr(ep, attr) for ep, attr in endpoints if ep is not None]

    def device_messages(self) -> list:
        return [device.read_messages() for device in self.devices]

    def read_log_messages(self):
        result, self.log_messages[:] = self.log_messages[:], []
        return result

    def cleanup(self):
        for device in self.devices:
            if device.backend not in (Backends.none, Backends.network):
                device.cleanup()
            if device is not None:
                device.free_data()

    def simulation_is_finished(self):
        target = self.project_manager.simulator_num_repeat
        return target != 0 and self.current_repeat >= target

    def _wait_for_devices(self):
        for _ in range(10):
            if ((self.sniffer is None or self.sniffer_ready)
                    and (self.sender is None or self.sender_ready)):
                return True
            if self.fatal_device_error_occurred:
                return False
            self.log_message("<i>Waiting for devices</i>")
            time.sleep(1)
        return True

    # ----------------------------------------------------------- machine loop

    def simulate(self):
        self.simulation_started.emit()
        self.is_simulating = self._wait_for_devices()

        if not self.is_simulating:
            self.stop("Devices not ready")
            return

        self.log_message("<b>Simulation is running</b>")

        while self.is_simulating and not self.simulation_is_finished():
            self.current_item = self._step(self.current_item)
            if self.do_restart:
                self.restart()

        self.stop(msg="Finished")

    def _step(self, item):
        """Execute one item; return its successor."""
        if item is None:
            return self._step_round_complete()
        if item is self.simulator_config.rootItem:
            return item.next()
        handler = next((fn for klass, fn in self._STEP_TABLE
                        if isinstance(item, klass)), None)
        if handler is None:
            raise ValueError("unknown action {}".format(type(item)))
        return handler(self, item)

    def _step_round_complete(self):
        self.current_repeat += 1
        self.transcript.start_new_round()
        return self.simulator_config.rootItem

    def _step_label(self, item):
        return item.next()

    def _step_message(self, item):
        if item.source is not None:
            if item.source.simulate:
                self._transmit_message(item)
            else:
                self._await_message(item)
        return item.next()

    def _step_goto(self, item):
        target = item.target
        self.log_message("GOTO item " + target.index())
        return target

    def _step_trigger_command(self, item):
        command = self._fill_counter_values(item.command)
        self.log_message("Calling {}".format(command))
        if item.pass_transcript:
            transcript = "\n".join(
                self.transcript.get_for_all_participants(all_rounds=False))
            result, rc = util.run_command(command, transcript, use_stdin=True,
                                          return_rc=True)
        else:
            result, rc = util.run_command(command, param=None,
                                          detailed_output=True, return_rc=True)
        item.return_code = rc
        self.log_message(result)
        return item.next()

    def _step_rule(self, item):
        condition = item.get_first_applying_condition()
        if (condition is not None and condition.logging_active
                and condition.type != ConditionType.ELSE):
            self.log_message("Rule condition " + condition.index()
                             + " (" + condition.condition + ") applied")
        if condition is not None and condition.child_count() > 0:
            return condition.children[0]
        return item.next_sibling()

    def _step_rule_condition(self, item):
        if item.type == ConditionType.IF:
            return item.parent()
        return item.parent().next_sibling()

    def _step_sleep(self, item):
        self.log_message(item.caption)
        time.sleep(item.sleep_time)
        return item.next()

    def _step_counter(self, item):
        item.progress_value()
        self.log_message("Increase counter by {} to {}".format(item.step,
                                                               item.value))
        return item.next()

    # isinstance-ordered dispatch: SimulatorMessage subclasses Message,
    # SimulatorProtocolLabel wraps labels — order guards the subtypes
    _STEP_TABLE = (
        (SimulatorProtocolLabel, _step_label),
        (SimulatorMessage, _step_message),
        (SimulatorGotoAction, _step_goto),
        (SimulatorTriggerCommandAction, _step_trigger_command),
        (SimulatorRule, _step_rule),
        (SimulatorRuleCondition, _step_rule_condition),
        (SimulatorSleepAction, _step_sleep),
        (SimulatorCounterAction, _step_counter),
    )

    # -------------------------------------------------------------------- TX

    def _transmit_message(self, template: SimulatorMessage):
        if self.sender is None:
            self.log_message("Fatal: No sender configured")
            return
        outgoing = self.generate_message_from_template(template)
        self._patch_checksums(outgoing)

        self.transcript.append(template.source, template.destination, outgoing,
                               template.index())
        self.send_message(outgoing, template.repeat, self.sender,
                          template.modulator_index)
        self.log_message("Sending message " + template.index())
        self.log_message_labels(outgoing)
        template.send_recv_messages.append(outgoing)
        self.last_sent_message = template

    @staticmethod
    def _patch_checksums(message: Message):
        for lbl in message.message_type:
            if not isinstance(lbl.label, ChecksumLabel):
                continue
            checksum = lbl.label.calculate_checksum_for_message(
                message, use_decoded_bits=False)
            start, end = message.get_label_range(lbl=lbl.label, view=0,
                                                 decode=False)
            padding = array.array("B", [0] * ((end - start) - len(checksum)))
            message.plain_bits[start:end] = checksum + padding

    # -------------------------------------------------------------------- RX

    def _await_message(self, template: SimulatorMessage):
        if self.sniffer is None:
            self.log_message("Fatal: No sniffer configured")
            return
        self.log_message("Waiting for message {}...".format(template.index()))
        expected = self.generate_message_from_template(template)
        self._patch_checksums(expected)

        max_retries = self.project_manager.simulator_retries
        retry = 0
        while (self.is_simulating and not self.simulation_is_finished()
               and retry < max_retries):
            received = self.receive_message(self.sniffer)
            if not self.is_simulating:
                return
            if received is None:
                if not self._handle_rx_failure():
                    return
                retry += 1
                continue

            self.log_message("  Received {} data bits".format(len(received)))
            received.decoder = expected.decoder
            received.message_type = expected.message_type

            self.log_message("  Check whether received data matches")
            matches, mismatch_log = self.check_message(received, expected,
                                                       retry=retry,
                                                       msg_index=template.index())
            if matches:
                self._accept_received(template, received)
                return
            if self.verbose:
                self.log_message(mismatch_log)
            retry += 1

        if retry == max_retries:
            self.log_message("Message " + template.index() + " not received")
            self.stop()

    def _handle_rx_failure(self) -> bool:
        """Apply the configured timeout policy; True = keep retrying."""
        policy = self._RX_FAILURE_POLICIES.get(
            self.project_manager.simulator_error_handling_index,
            Simulator._policy_resend)
        return policy(self)

    def _policy_resend(self) -> bool:
        self.resend_last_message()
        return True

    def _policy_stop(self) -> bool:
        self.stop()
        return False

    def _policy_restart(self) -> bool:
        self.do_restart = True
        return False

    _RX_FAILURE_POLICIES = {0: _policy_resend, 1: _policy_stop, 2: _policy_restart}

    def _accept_received(self, template_msg, received_msg):
        """Record a successfully matched RX (Simulator.py:418-431)."""
        decoded_msg = Message(received_msg.decoded_bits, 0,
                              received_msg.message_type,
                              decoder=received_msg.decoder)
        template_msg.send_recv_messages.append(decoded_msg)
        self.transcript.append(template_msg.source, template_msg.destination,
                               decoded_msg, template_msg.index())
        self.log_message("Received message " + template_msg.index() + ": ")
        self.log_message_labels(decoded_msg)

    def check_message(self, received_msg, expected_msg, retry: int, msg_index) -> tuple:
        if len(received_msg.decoded_bits) == 0:
            return False, "Failed to decode message {}".format(msg_index)

        for lbl in received_msg.message_type:
            if getattr(lbl, "value_type_index", 0) in (_VALUE_LIVE, _VALUE_RANDOM):
                continue

            if isinstance(lbl.label, ChecksumLabel):
                expected = lbl.label.calculate_checksum_for_message(
                    received_msg, use_decoded_bits=True)
                start, end = received_msg.get_label_range(lbl.label, 0, True)
                actual = received_msg.decoded_bits[start:end]
            else:
                start_recv, end_recv = received_msg.get_label_range(lbl.label, 0, True)
                start_exp, end_exp = expected_msg.get_label_range(lbl.label, 0, False)
                actual = received_msg.decoded_bits[start_recv:end_recv]
                expected = expected_msg[start_exp:end_exp]

            if actual != expected:
                return False, self._mismatch_log(lbl, expected, actual, retry,
                                                 msg_index)
        return True, ""

    def _mismatch_log(self, lbl, expected, actual, retry, msg_index) -> list:
        lines = ["Attempt for message {} [{}/{}]".format(
            msg_index, retry + 1, self.project_manager.simulator_retries)]
        lines.append(util.indent_string("Mismatch for label: <b>{}</b>".format(lbl.name)))
        expected_str = util.convert_bits_to_string(expected, lbl.label.display_format_index)
        got_str = util.convert_bits_to_string(actual, lbl.label.display_format_index)
        lines.append(util.align_expected_and_got_value(expected_str, got_str,
                                                       align_depth=2))
        return lines

    def resend_last_message(self):
        self.log_message("Resending last message")
        lsm = self.last_sent_message
        if lsm is None:
            return
        self.send_message(lsm.send_recv_messages[-1], lsm.repeat, self.sender,
                          lsm.modulator_index)

    def send_message(self, message, repeat, sender, modulator_index):
        modulator = self.modulators[modulator_index]
        modulated = modulator.modulate(message.encoded_bits, pause=message.pause,
                                       dtype=self.sender.device.data_type,
                                       device=self.device)
        for _ in range(repeat):
            sender.push_data(modulated.data)

    def receive_message(self, sniffer):
        if len(sniffer.messages) > 0:
            return sniffer.messages.pop(0)

        self._message_sniffed_event.clear()
        timeout_s = self.project_manager.simulator_timeout_ms / 1000
        if not self._message_sniffed_event.wait(timeout_s):
            self.log_message("Receive timeout")
            return None
        if not sniffer.messages:
            self.log_message("Could not receive message")
            return None
        return sniffer.messages.pop(0)

    # ------------------------------------------------------ template filling

    def generate_message_from_template(self, template_msg: SimulatorMessage):
        new_message = Message(template_msg.plain_bits, pause=template_msg.pause,
                              rssi=0, message_type=template_msg.message_type,
                              decoder=template_msg.decoder)
        for lbl in template_msg.children:
            filler = self._LABEL_FILLERS.get(lbl.value_type_index)
            if filler is not None:
                filler(self, new_message, lbl, template_msg)
        return new_message

    def _fill_formula_label(self, message, lbl, template_msg):
        # expression compiled once and cached by the parser
        self.set_label_value(message, lbl,
                             self.expression_parser.evaluate_formula(lbl.formula))

    def _fill_external_label(self, message, lbl, template_msg):
        endpoint = (template_msg.source if template_msg.source.simulate
                    else template_msg.destination)
        transcript = self.transcript.get_for_participant(endpoint)
        if template_msg.destination.simulate:
            direction = "->" if template_msg.source.simulate else "<-"
            transcript += "\n" + direction + message.plain_bits_str + "\n"

        cmd = self._fill_counter_values(lbl.external_program)
        result = util.run_command(cmd, transcript, use_stdin=True)
        if len(result) != lbl.end - lbl.start:
            logger.error("result value of external program {}: {} ({}) does not "
                         "match label length {}".format(cmd, result, len(result),
                                                        lbl.end - lbl.start))
            return
        try:
            message[lbl.start : lbl.end] = array.array("B",
                                                       map(bool, map(int, result)))
        except Exception as e:
            logger.error("could not assign {} to range: {}".format(result, e))

    def _fill_random_label(self, message, lbl, template_msg):
        value = int(numpy.random.randint(lbl.random_min, lbl.random_max + 1))
        self.set_label_value(message, lbl, value)

    _LABEL_FILLERS = {
        _VALUE_FORMULA: _fill_formula_label,
        _VALUE_EXTERNAL: _fill_external_label,
        _VALUE_RANDOM: _fill_random_label,
    }

    def _fill_counter_values(self, command: str):
        """Substitute itemN.counter_value references with live values."""
        def counter_value(token):
            try:
                return str(self.simulator_config.item_dict[token].value)
            except (KeyError, ValueError, AttributeError):
                logger.error("could not get counter value for " + token)
                return ""

        return "".join(counter_value(tok) if _COUNTER_REF.fullmatch(tok) else tok
                       for tok in _COUNTER_REF.split(command))

    @staticmethod
    def set_label_value(message, label, decimal_value: int):
        """Write an integer MSB-first into the label's bit range
        (Simulator.py:631-644)."""
        width = label.end - label.start
        bits = format(decimal_value, "0{}b".format(width))
        if len(bits) > width:
            logger.warning("value {0} too big for label {1}, bits truncated".format(
                decimal_value, label.name))
        for i, bit in enumerate(bits[:width]):
            message[label.start + i] = bit == "1"

    # --------------------------------------------------------------- logging

    def log_message(self, message):
        stamp = "{0:%b} {0.day} {0:%H}:{0:%M}:{0:%S}.{0:%f}".format(
            datetime.datetime.now())
        if isinstance(message, list) and len(message) > 0:
            self.log_messages.append(stamp + ": " + message[0])
            self.log_messages.extend(message[1:])
            logger.debug("\n".join(message))
        else:
            self.log_messages.append(stamp + ": " + str(message))
            logger.debug(str(message))

    def log_message_labels(self, message: Message):
        message.split(decode=False)
        for lbl in message.message_type:
            if not getattr(lbl, "logging_active", True):
                continue
            try:
                data = message.plain_bits[lbl.start : lbl.end]
            except IndexError:
                return None

            lsb = lbl.display_bit_order_index == 1
            lsd = lbl.display_bit_order_index == 2
            data = util.convert_bits_to_string(data, lbl.display_format_index,
                                               pad_zeros=True, lsb=lsb, lsd=lsd)
            if data is None:
                continue
            self.log_messages.append(util.indent_string(
                lbl.name + ": " + util.monospace(data)))
