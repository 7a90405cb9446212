"""Interactive browser application over the headless controller layer
(PyTorch port of urh_tpu.ui.web).

The reference ships a 4-tab Qt desktop GUI (urh/controller/
MainController.py).  The interactive application is a local web app
instead, where the compute runs server-side on the card and the operator
attaches a browser: a stdlib HTTP server (no extra dependencies) exposing
the Interpretation / Analysis / Generator / Simulator workflows as a JSON
API, plus one embedded single-page UI that renders signal envelopes on a
canvas and drives every action through that API.

Every route computes on the WebUI's device (``WebUI(device=...)``; default
the CUDA card, RuntimeError without one; ``"cpu"``, ``"cuda:N"``,
``"auto"``), handed down to the controllers, every Signal, the
spectrogram, the plot path, the band-pass, the modulator preview, the
continuous modulator and the sniffers.  A request body's ``"device"`` key
names an SDR, never the compute device.  Each request runs on a thread of
its own, so the device is always passed explicitly, never set as the
thread's current CUDA device.

Start it with ``urh_tpu_torch-web [--device cpu] [--port N]`` (without
``--device``, ``URH_TPU_TORCH_DEVICE`` as the CLI reads it) or
``serve()``.  Everything the page does is available to scripts through
the same endpoints.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from urh_tpu_torch.ui.controllers.main import MainController

PARAM_NAMES = ("modulation_type", "samples_per_symbol", "center",
               "center_spacing", "noise_threshold", "tolerance",
               "bits_per_symbol", "pause_threshold", "sample_rate")


class WebUI:
    """Application state + route handlers (the server part is below)."""

    def __init__(self, project_path: str = "", device=None):
        self.main = MainController(project_path, device=device)
        self.device = self.main.device
        self.analysis = self.main.compare_frame_controller
        self.generator = self.main.generator_tab_controller
        self._lock = threading.RLock()
        self._devices = {}     # "record" | "send" | "spectrum" -> VirtualDevice
        self._sniffer = None   # live ProtocolSniffer session
        self._recorded = None  # (samples, sample_rate) kept after record stop

    @property
    def simulator_config(self):
        return self.main.simulator_tab_controller.simulator_config

    # -- helpers ----------------------------------------------------------
    def _frame(self, signal_id: int):
        frames = self.main.signal_frames
        if not 0 <= signal_id < len(frames):
            raise KeyError(f"no signal {signal_id}")
        return frames[signal_id]

    @staticmethod
    def _signal_params(signal) -> dict:
        out = {}
        for name in PARAM_NAMES:
            value = getattr(signal, name, None)
            out[name] = value if isinstance(value, str) else (
                None if value is None else float(value))
        return out

    def _signal_summary(self, i, frame) -> dict:
        return {"id": i, "name": frame.name,
                "num_samples": int(frame.signal.num_samples),
                "params": self._signal_params(frame.signal)}

    # -- interpretation ----------------------------------------------------
    def state(self, _q, _body):
        with self._lock:
            return {
                "signals": [self._signal_summary(i, f)
                            for i, f in enumerate(self.main.signal_frames)],
                "analysis_protocols": len(self.analysis.protocol_list),
                "analysis_rows": len(self._analysis_messages()),
                "generator_rows": len(self.generator.protocol.messages),
                "simulator_items": len(self.simulator_config.get_all_items()),
            }

    def project_open(self, _q, body):
        """Load a URHProject.xml directory: signals listed in the project
        re-open with their stored demod parameters (MainController
        project_open)."""
        with self._lock:
            self.main.open_project(body["path"])
            return self.state(None, None)

    def project_save(self, _q, body):
        with self._lock:
            if body and body.get("path"):
                self.main.project_manager.project_path = body["path"]
            self.main.save_project()
            return {"saved": self.main.project_manager.project_file}

    def open_signal(self, _q, body):
        with self._lock:
            frame = self.main.add_signalfile(body["path"])
            if frame is None:
                raise ValueError(f"could not load {body['path']}")
            return self._signal_summary(len(self.main.signal_frames) - 1, frame)

    def import_csv(self, _q, body):
        """Import a CSV capture as a signal (the reference's
        CSVImportDialog: separator + I/Q/timestamp column mapping)."""
        from urh_tpu_torch.util.csv_import import csv_to_signal

        with self._lock:
            signal = csv_to_signal(
                body["path"], separator=body.get("separator", ","),
                i_data_col=int(body.get("i_column", 1)),
                q_data_col=int(body.get("q_column", -1)),
                t_data_col=int(body.get("t_column", -1)), device=self.device)
            frame = self.main.add_signal(signal)
            return self._signal_summary(
                self.main.signal_frames.index(frame), frame)

    def signal_plot(self, signal_id: int, q, _body):
        from urh_tpu_torch.dsp.decimation import create_path

        with self._lock:
            frame = self._frame(signal_id)
            data = frame.signal.real_plot_data
            start = int(q.get("start", [0])[0])
            end = int(q.get("end", [len(data)])[0])
            (x, y), = create_path(data, max(0, start), min(len(data), end),
                                  device=frame.signal.device)
            return {"x": np.asarray(x).tolist(),
                    "y": np.round(np.asarray(y, np.float64), 5).tolist(),
                    "num_samples": int(len(data))}

    def signal_set_params(self, signal_id: int, _q, body):
        with self._lock:
            frame = self._frame(signal_id)
            for name, value in body.items():
                if name not in PARAM_NAMES:
                    raise ValueError(f"unknown parameter {name}")
                if name not in ("modulation_type",):
                    value = type(getattr(frame.signal, name))(value)
                frame.change_parameter(name, value)
            return self._signal_params(frame.signal)

    def signal_autodetect(self, signal_id: int, _q, _body):
        with self._lock:
            frame = self._frame(signal_id)
            ok = frame.auto_detect(detect_modulation=True, detect_noise=True)
            return {"success": bool(ok),
                    "params": self._signal_params(frame.signal)}

    def signal_messages(self, signal_id: int, q, _body):
        with self._lock:
            frame = self._frame(signal_id)
            proto = frame.show_protocol()
            view = int(q.get("view", [0])[0])
            decoded = q.get("decoded", ["0"])[0] == "1"
            return {"messages": [
                msg.view_to_string(view, decoded=decoded, show_pauses=False)
                for msg in proto.messages]}

    def undo(self, signal_id: int, _q, _body):
        with self._lock:
            frame = self._frame(signal_id)
            frame.undo_stack.undo()
            return {"params": self._signal_params(frame.signal)}

    def signal_edit(self, signal_id: int, _q, body):
        """Undoable signal editing over a sample range: delete / mute /
        crop / filter / copy+paste (SignalFrame edit menu depth)."""
        with self._lock:
            frame = self._frame(signal_id)
            action = body["action"]
            start = int(body.get("start", 0))
            end = int(body.get("end", frame.signal.num_samples))
            if action == "delete":
                frame.delete_range(start, end)
            elif action == "mute":
                frame.mute_range(start, end)
            elif action == "crop":
                frame.crop(start, end)
            elif action == "filter":
                from urh_tpu_torch.dsp.filters import Filter, FilterType

                fc = float(body.get("cutoff", 0.1))
                bw = float(body.get("bw", 0.05))
                dsp_filter = Filter(Filter.design_windowed_sinc_lpf(fc, bw=bw),
                                    FilterType.custom)
                frame.filter_range(start, end, dsp_filter)
            elif action == "copy":
                frame.copy_range(start, end)
            elif action == "paste":
                frame.paste(int(body["position"]))
            else:
                raise ValueError(f"unknown edit action {action}")
            return {"num_samples": int(frame.signal.num_samples),
                    "params": self._signal_params(frame.signal)}

    def signal_insert_sine(self, signal_id: int, _q, body):
        """Insert a synthesized sine into a signal at a sample position
        (the InsertSine plugin's dialog, undoable via the signal's edit
        stack)."""
        from urh_tpu_torch.plugins.insert_sine import InsertSinePlugin

        with self._lock:
            frame = self._frame(signal_id)
            plugin = InsertSinePlugin()
            for field, cast in (("amplitude", float), ("frequency", float),
                                ("phase", float), ("sample_rate", float),
                                ("num_samples", int)):
                if field in body:
                    setattr(plugin, field, cast(body[field]))
            if plugin.num_samples <= 0:
                raise ValueError("num_samples must be positive")
            position = int(body.get("position", 0))
            if not 0 <= position <= frame.signal.num_samples:
                raise ValueError(f"position {position} out of range")
            wave = plugin.generate_sine_wave(
                dtype=frame.signal.iq_array.dtype)
            frame.insert_data(position, wave)
            return self._signal_summary(signal_id, frame)

    def analysis_message_break(self, _q, body):
        """Break a message at a bit/hex/ascii column into two messages
        (the MessageBreak plugin), undoable on the analysis stack."""
        from urh_tpu_torch.plugins.message_break import MessageBreakPlugin

        with self._lock:
            pa = self.analysis.proto_analyzer
            msg_nr = int(body["message"])
            if not 0 <= msg_nr < len(pa.messages):
                raise ValueError(f"no analysis message {msg_nr}")
            action = MessageBreakPlugin().get_action(
                pa, msg_nr, int(body["position"]),
                view=int(body.get("view", 0)))
            self.analysis.protocol_undo_stack.push(action)
            self.analysis.protocol_model.update()
            return {"rows": len(pa.messages),
                    **self._undo_reply(self.analysis.protocol_undo_stack)}

    def analysis_zero_hide(self, _q, body):
        """Hide (or restore) long zero runs in the decoded analysis view
        (the ZeroHide plugin), undoable on the analysis stack."""
        from urh_tpu_torch.plugins.zero_hide import ZeroHidePlugin

        with self._lock:
            pa = self.analysis.proto_analyzer
            if body.get("action") == "restore":
                self.analysis.protocol_undo_stack.undo()
            else:
                plugin = ZeroHidePlugin()
                if "following_zeros" in body:
                    plugin.following_zeros = int(body["following_zeros"])
                    if plugin.following_zeros < 1:
                        raise ValueError("following_zeros must be >= 1")
                action = plugin.get_action(pa, int(body.get("view", 0)))
                self.analysis.protocol_undo_stack.push(action)
            self.analysis.protocol_model.update()
            return {"rows": len(pa.messages),
                    **self._undo_reply(self.analysis.protocol_undo_stack)}

    def signal_save(self, signal_id: int, _q, body):
        """Save a signal's samples to disk (SignalFrame 'save signal
        as'; extension picks the format — .complex/.wav/.sub/...)."""
        with self._lock:
            frame = self._frame(signal_id)
            frame.signal.save_as(str(body["path"]))
            return {"saved": body["path"],
                    "num_samples": int(frame.signal.num_samples)}

    def analysis_export(self, _q, body):
        """Export the analysis protocol: proto XML or PCAPNG (the
        reference analysis tab's export menu)."""
        with self._lock:
            pa = self.analysis.proto_analyzer
            if not pa.messages:
                raise ValueError("no analysis messages to export")
            path = str(body["path"])
            fmt = body.get("format", "xml")
            if fmt == "xml":
                pa.to_xml_file(path, self.analysis.decodings,
                               self.main.project_manager.participants,
                               include_message_types=True, write_bits=True)
            elif fmt == "pcapng":
                pa.to_pcapng(path, hardware_desc_name="urh_tpu_torch")
            else:
                raise ValueError(f"unknown export format {fmt}")
            return {"saved": path, "format": fmt,
                    "messages": len(pa.messages)}

    def signal_bandpass(self, signal_id: int, _q, body):
        """Bandpass-filter a signal into a NEW signal (the reference's
        spectrogram context-menu 'apply bandpass filter', SignalFrame;
        f_low/f_high are normalized frequencies in [-0.5, 0.5])."""
        from urh_tpu_torch.core.signal import Signal
        from urh_tpu_torch.dsp.filters import Filter

        with self._lock:
            frame = self._frame(signal_id)
            f_low = float(body["f_low"])
            f_high = float(body["f_high"])
            bw = float(body.get("bw", Filter.read_configured_filter_bw()))
            data = frame.signal.iq_array.as_complex64()
            filtered = Filter.apply_bandpass_filter(data, f_low, f_high,
                                                    filter_bw=bw,
                                                    device=frame.signal.device)
            # create_new keeps the demod parameter set (the reference's
            # SignalFrame.py:1579 filtered-signal semantics)
            signal = frame.signal.create_new(
                new_data=filtered.astype(np.complex64))
            signal.name = f"{frame.name} filtered"
            new_frame = self.main.add_signal(signal)
            return self._signal_summary(
                self.main.signal_frames.index(new_frame), new_frame)

    def signal_selection(self, signal_id: int, q, _body):
        """Noise/power summary of a sample range (the reference's
        selection info in the signal view)."""
        with self._lock:
            frame = self._frame(signal_id)
            start = int(q.get("start", [0])[0])
            end = int(q.get("end", [frame.signal.num_samples])[0])
            return {k: (float(v) if isinstance(v, (int, float)) else v)
                    for k, v in frame.selection_info(start, end).items()}

    def _spectrogram_png(self, samples, window: int, colormap: str,
                         start: int = 0, end=None):
        """Shared colormapped spectrogram render (signal spectrogram
        view + the spectrum analyzer waterfall)."""
        from urh_tpu_torch.dsp.spectrogram import Spectrogram
        from urh_tpu_torch.ui.png import encode_bgra
        from urh_tpu_torch.util import colormaps

        if colormap not in colormaps.available_colormaps:
            raise ValueError(f"unknown colormap {colormap}")
        spec = Spectrogram(samples, window_size=window, device=self.device)
        data = spec._calculate_spectrogram(spec.samples[start:end])
        image = Spectrogram.create_image(
            data, colormaps.calculate_numpy_brga_for(colormap),
            spec.data_min, spec.data_max)
        return encode_bgra(image), "image/png"

    def signal_spectrogram(self, signal_id: int, q, _body):
        """Spectrogram render of a sample range as PNG (reference:
        SignalFrame spectrogram view over Spectrogram.create_image)."""
        from urh_tpu_torch.dsp.spectrogram import Spectrogram
        from urh_tpu_torch.util import colormaps

        with self._lock:
            frame = self._frame(signal_id)
            name = q.get("colormap", [colormaps.chosen_colormap_name])[0]
            window = int(q.get("window", [Spectrogram.DEFAULT_FFT_WINDOW_SIZE])[0])
            start = int(q.get("start", [0])[0])
            end_vals = q.get("end", [None])
            end = int(end_vals[0]) if end_vals[0] is not None else None
            return self._spectrogram_png(frame.signal.iq_array, window,
                                         name, start, end)

    def colormaps_list(self, _q, _body):
        from urh_tpu_torch.util import colormaps

        return {"colormaps": list(colormaps.available_colormaps),
                "chosen": colormaps.chosen_colormap_name}

    # -- analysis ----------------------------------------------------------
    def _analysis_messages(self):
        """The merged analyzer's rows — the authoritative shown table
        (what label/cell edits and the undo stack operate on)."""
        return self.analysis.proto_analyzer.messages

    def analysis_add(self, _q, body):
        """Idempotent: opening a signal already registers its protocol
        with the compare frame (MainController.add_signal); this only
        refreshes the demodulation and the shown rows."""
        with self._lock:
            frame = self._frame(int(body["signal_id"]))
            proto = frame.show_protocol(refresh=True)
            if proto not in self.analysis.protocol_list:
                self.analysis.add_protocol(proto)
            self.analysis.set_shown_protocols()
            return {"rows": len(self._analysis_messages())}

    def analysis_rows(self, q, _body):
        view = int(q.get("view", [0])[0])
        decoded = q.get("decoded", ["1"])[0] == "1"
        with self._lock:
            rows = []
            for msg in self._analysis_messages():
                # awre's labels hold NumPy integers: the reply takes ints
                labels = [{"name": lbl.name, "start": int(lbl.start), "end": int(lbl.end)}
                          for lbl in msg.message_type]
                rows.append({"data": msg.view_to_string(view, decoded=decoded,
                                                        show_pauses=False),
                             "type": msg.message_type.name, "labels": labels})
            return {"rows": rows}

    def analysis_awre(self, _q, _body):
        with self._lock:
            self.analysis.run_format_finder()
            types = []
            for mt in self.analysis.proto_analyzer.message_types:
                types.append({"name": mt.name, "labels": [
                    {"name": lbl.name, "start": int(lbl.start), "end": int(lbl.end)}
                    for lbl in mt]})
            return {"message_types": types}

    def analysis_set_decoding(self, _q, body):
        with self._lock:
            decodings = self.analysis.decodings
            index = int(body["decoding_index"])
            if not 0 <= index < len(decodings):
                raise ValueError(f"no decoding {index}")
            self.analysis.set_decoding(decodings[index])
            return {"decoding": decodings[index].name}

    def analysis_decodings(self, _q, _body):
        with self._lock:
            return {"decodings": [d.name for d in self.analysis.decodings]}

    def analysis_checksum_label(self, _q, body):
        """Configure a checksum label (the reference's ChecksumWidget):
        field type promotion happens via /api/analysis/label with a
        checksum field type; this route edits the CRC parameters, data
        ranges, category and WSP mode, then re-checks the message."""
        from urh_tpu_torch.protocol.labels import ChecksumLabel
        from urh_tpu_torch.ui.widgets import ChecksumWidgetController

        with self._lock:
            messages = self._analysis_messages()
            msg_index = int(body["message"])
            if not 0 <= msg_index < len(messages):
                raise ValueError(f"no analysis message {msg_index}")
            msg = messages[msg_index]
            label_index = int(body["label"])
            if not 0 <= label_index < len(msg.message_type):
                raise ValueError(f"no label {label_index}")
            lbl = msg.message_type[label_index]
            if not isinstance(lbl, ChecksumLabel):
                raise ValueError("label is not a checksum label "
                                 "(set its field type to checksum first)")
            # data_ranges in this API are always BIT indices
            widget = ChecksumWidgetController(lbl, msg, proto_view=0)
            if "crc_function" in body:
                fn = body["crc_function"]
                names = widget.crc_function_names
                if isinstance(fn, int):
                    if not 0 <= fn < len(names):
                        raise ValueError(f"CRC function index {fn} out "
                                         f"of range (0..{len(names)-1})")
                elif fn not in names:
                    raise ValueError(f"unknown CRC function {fn!r} "
                                     f"(one of {names})")
                widget.set_crc_function(fn)
            if "polynomial_hex" in body:
                widget.set_polynomial_from_hex(str(body["polynomial_hex"]))
            if "category" in body:
                widget.set_category(str(body["category"]))
            if "wsp_mode" in body:
                widget.set_wsp_mode(str(body["wsp_mode"]))
            if "data_ranges" in body:
                lbl.data_ranges = [[int(a), int(b)]
                                   for a, b in body["data_ranges"]]
            self.analysis.label_value_model_update()
            import array as array_mod

            expected = lbl.calculate_checksum_for_message(
                msg, use_decoded_bits=True)
            start, end = msg.get_label_range(lbl, 0, True)
            received = msg.decoded_bits[start:end]
            checksum_ok = bool(
                array_mod.array("B", list(expected))
                == array_mod.array("B", list(received)))
            return {"label": lbl.name,
                    "category": widget.category,
                    "polynomial_hex": widget.polynomial_hex,
                    "start_value_hex": widget.start_value_hex,
                    "final_xor_hex": widget.final_xor_hex,
                    "data_ranges": [[int(a), int(b)]
                                    for a, b in lbl.data_ranges],
                    "crc_functions": widget.crc_function_names,
                    "checksum_ok": checksum_ok}

    # -- message types + assignment rulesets ----------------------------------
    # Reference: controller/dialogs/MessageTypeDialog.py + Ruleset.py —
    # create/rename/delete message types, assign rows, and author the
    # automatic-assignment ruleset with live re-application.

    def _message_type_dict(self, index, mt) -> dict:
        from urh_tpu_torch.protocol.labels import OPERATION_DESCRIPTION

        return {"index": index, "name": mt.name,
                "assigned_by_ruleset": bool(mt.assigned_by_ruleset),
                "ruleset_mode": mt.ruleset.mode.name,
                "rules": [{"start": int(r._start), "end": int(r._end) - 1,
                           "operator": r.operator,
                           "operator_description":
                               OPERATION_DESCRIPTION[r.operator],
                           "target_value": r.target_value,
                           "value_type": int(r.value_type)}
                          for r in mt.ruleset],
                "labels": [lbl.name for lbl in mt],
                "messages": [i for i, m in enumerate(
                    self._analysis_messages()) if m.message_type is mt]}

    def analysis_message_types(self, _q, _body):
        with self._lock:
            return {"message_types": [
                self._message_type_dict(i, mt) for i, mt in
                enumerate(self.analysis.proto_analyzer.message_types)]}

    def analysis_message_type(self, _q, body):
        """Create / edit / delete message types; edit covers rename,
        row assignment, and the automatic-assignment ruleset."""
        from urh_tpu_torch.protocol.labels import Mode, Rule, Ruleset

        action = body.get("action", "create")
        with self._lock:
            pa = self.analysis.proto_analyzer
            messages = self._analysis_messages()
            if action == "create":
                for r in body.get("rows", []):
                    if not 0 <= int(r) < len(messages):
                        raise ValueError(f"no analysis message {r}")
                rows = [messages[int(r)] for r in body.get("rows", [])]
                mt = self.analysis.add_message_type(rows)
                if body.get("name"):
                    mt.name = str(body["name"])
                return self._message_type_dict(
                    pa.message_types.index(mt), mt)

            index = int(body["index"])
            if not 0 <= index < len(pa.message_types):
                raise ValueError(f"no message type {index}")
            mt = pa.message_types[index]
            if action == "delete":
                if mt is pa.default_message_type:
                    raise ValueError("cannot delete the default type")
                for msg in messages:
                    if msg.message_type is mt:
                        msg.message_type = pa.default_message_type
                pa.message_types.remove(mt)
                self.analysis.protocol_model.update()
                return {"message_types": [t.name for t in pa.message_types]}
            if action != "edit":
                raise ValueError(f"unknown action {action}")

            if body.get("name"):
                mt.name = str(body["name"])
            if "rows" in body:
                for r in body["rows"]:
                    if not 0 <= int(r) < len(messages):
                        raise ValueError(f"no analysis message {r}")
                for r in body["rows"]:
                    messages[int(r)].message_type = mt
            if "ruleset" in body:
                spec = body["ruleset"]
                from urh_tpu_torch.protocol.labels import OPERATIONS

                for r in spec.get("rules", []):
                    if str(r.get("operator")) not in OPERATIONS:
                        raise ValueError(
                            f"unknown rule operator {r.get('operator')!r} "
                            f"(one of {sorted(OPERATIONS)})")
                rules = [Rule(start=int(r["start"]), end=int(r["end"]),
                              operator=str(r["operator"]),
                              target_value=str(r["target_value"]),
                              value_type=int(r.get("value_type", 0)))
                         for r in spec.get("rules", [])]
                mt.ruleset = Ruleset(Mode[spec.get("mode", "all_apply")],
                                     rules)
            if "assigned_by_ruleset" in body:
                mt.assigned_by_ruleset = bool(body["assigned_by_ruleset"])
            self.analysis.update_automatic_assigned_message_types()
            self.analysis.label_value_model_update()
            return self._message_type_dict(index, mt)

    @staticmethod
    def _undo_reply(stack) -> dict:
        return {"can_undo": stack.can_undo(),
                "can_redo": stack.can_redo(),
                "undo_text": stack.undo_text,
                "redo_text": stack.redo_text,
                "depth": int(stack.count)}

    def _table_undo(self, stack, body) -> dict:
        action = (body or {}).get("action", "undo")
        if action == "undo":
            stack.undo()
        elif action == "redo":
            stack.redo()
        elif action != "status":
            raise ValueError(f"unknown undo action {action}")
        return self._undo_reply(stack)

    def analysis_delete_range(self, _q, body):
        """Undoable deletion of a bit/hex/ascii range across analysis
        rows (reference DeleteBitsAndPauses on the QUndoStack)."""
        with self._lock:
            model = self.analysis.protocol_model
            model.proto_view = int(body.get("view", 0))
            messages = self.analysis.proto_analyzer.messages
            msg_start, msg_end = int(body["msg_start"]), int(body["msg_end"])
            if not (0 <= msg_start < len(messages)
                    and 0 <= msg_end < len(messages)):
                raise ValueError("message range out of bounds")
            model.delete_range(msg_start, msg_end,
                               int(body["index_start"]),
                               int(body["index_end"]))
            return self._undo_reply(self.analysis.protocol_undo_stack)

    def generator_insert_column(self, _q, body):
        """Undoable zero-column insertion into generator rows
        (reference InsertColumn action)."""
        from urh_tpu_torch.ui.actions import InsertColumn

        with self._lock:
            messages = self.generator.protocol.messages
            rows = body.get("rows")
            rows = list(range(len(messages))) if rows is None else [
                int(r) for r in rows]
            for row in rows:
                if not 0 <= row < len(messages):
                    raise ValueError(f"no generator message {row}")
            self.generator.generator_undo_stack.push(InsertColumn(
                self.generator.protocol, int(body["index"]), rows,
                int(body.get("view", 0))))
            self.generator.table_model.update()
            return self._undo_reply(self.generator.generator_undo_stack)

    def generator_clear(self, _q, _body):
        """Undoable clear of the generator table (reference Clear)."""
        from urh_tpu_torch.ui.actions import Clear

        with self._lock:
            self.generator.generator_undo_stack.push(
                Clear(self.generator.protocol))
            self.generator.table_model.update()
            return self._undo_reply(self.generator.generator_undo_stack)

    def analysis_undo(self, _q, body):
        """Undo/redo analysis-table edits (the reference puts cell and
        label edits on the QUndoStack, ui/actions/)."""
        with self._lock:
            reply = self._table_undo(self.analysis.protocol_undo_stack, body)
            self.analysis.protocol_model.update()
            self.analysis.label_value_model_update()
            return reply

    def generator_undo(self, _q, body):
        """Undo/redo generator-table edits incl. fuzzing expansion."""
        with self._lock:
            reply = self._table_undo(self.generator.generator_undo_stack,
                                     body)
            self.generator.table_model.update()
            return reply

    # -- decoding-chain editor -----------------------------------------------
    # Author custom Encoding chains from the primitive list with live
    # preview (the reference's DecoderDialog, controller/dialogs/
    # DecoderDialog.py; chain format: Encoding.py:120-187).

    @staticmethod
    def _chain_strings(body) -> list:
        chain = body.get("chain", [])
        if not isinstance(chain, list):
            raise ValueError("chain must be a list of strings")
        return [str(c) for c in chain]

    def decoding_primitives(self, _q, _body):
        """The buildable primitive list: verbose name (what goes into a
        chain), whether it takes a parameter, and the parameter's
        default/example."""
        from urh_tpu_torch.coding import encodings as enc

        prims = []
        for key, verbose in enc.DECODING_NAMES.items():
            param = enc.Encoding._PARAM_OPS.get(key)
            prims.append({"key": key, "name": verbose,
                          "takes_param": param is not None,
                          "param_default": (None if param is None
                                            else str(param))})
        return {"primitives": prims}

    def decoding_preview(self, _q, body):
        """Live preview: run a (possibly unsaved) chain over input bits
        in both directions (DecoderDialog's inpt/output views)."""
        from urh_tpu_torch.coding.encodings import Encoding, bit2str, str2bit

        chain = self._chain_strings(body)
        bits_str = str(body.get("input", ""))
        if not set(bits_str) <= {"0", "1"}:
            raise ValueError("input must be a bit string")
        encoding = Encoding([str(body.get("name", "preview"))] + chain)
        bits = str2bit(bits_str)
        decoded, errors, state = encoding.code(True, bits)
        out = {"decoded": bit2str(decoded), "errors": int(errors),
               "state": str(state)}
        encoded, _, _ = encoding.code(False, decoded)
        out["reencoded"] = bit2str(encoded)
        nibbles = out["decoded"]
        out["decoded_hex"] = "".join(
            "%x" % int(nibbles[i:i + 4], 2)
            for i in range(0, len(nibbles) - len(nibbles) % 4, 4))
        return out

    def decoding_save(self, _q, body):
        """Create or replace a named decoding in the project list; it
        persists through project save/open (decodings XML) or, with no
        project, the user decodings file."""
        from urh_tpu_torch.coding.encodings import Encoding

        name = str(body.get("name", "")).strip()
        if not name:
            raise ValueError("decoding needs a name")
        encoding = Encoding([name] + self._chain_strings(body))
        with self._lock:
            pm = self.main.project_manager
            index = next((i for i, d in enumerate(pm.decodings)
                          if d.name == name), None)
            if index is None:
                pm.decodings.append(encoding)
            else:
                pm.decodings[index] = encoding
            self.analysis.refresh_existing_encodings()
            if not pm.project_loaded:
                pm.save_decodings_file()
            return {"decodings": [d.name for d in pm.decodings],
                    "chain": [str(c) for c in encoding.get_chain()[1:]]}

    def decoding_delete(self, _q, body):
        with self._lock:
            pm = self.main.project_manager
            index = int(body["decoding_index"])
            if not 0 <= index < len(pm.decodings):
                raise ValueError(f"no decoding {index}")
            removed = pm.decodings.pop(index)
            if not pm.project_loaded:
                pm.save_decodings_file()
            return {"removed": removed.name,
                    "decodings": [d.name for d in pm.decodings]}

    def decoding_get(self, q, _body):
        """Read back a stored decoding's chain for editing."""
        index = int(q.get("decoding_index", [0])[0])
        with self._lock:
            decodings = self.analysis.decodings
            if not 0 <= index < len(decodings):
                raise ValueError(f"no decoding {index}")
            chain = decodings[index].get_chain()
            return {"name": chain[0], "chain": [str(c) for c in chain[1:]]}

    def _apply_label_field_type(self, mt, lbl, caption: str):
        """Set a label's field type by caption; a checksum caption
        promotes the label to a ChecksumLabel in place (MessageType.
        change_field_type_of_label semantics)."""
        field_type = self.analysis.field_types_by_caption.get(str(caption))
        if field_type is None:
            raise ValueError(f"unknown field type {caption!r}")
        mt.change_field_type_of_label(lbl, field_type)

    def _label_reply(self, mt) -> dict:
        from urh_tpu_torch.protocol.labels import ChecksumLabel

        return {"type": mt.name, "labels": [
            {"name": lbl.name, "start": int(lbl.start), "end": int(lbl.end),
             "field_type": (lbl.field_type.caption
                            if lbl.field_type else None),
             "is_checksum": isinstance(lbl, ChecksumLabel)}
            for lbl in mt]}

    def analysis_label(self, _q, body):
        """Create / edit / delete a protocol label on a message's type —
        the table-editing depth of the reference's analysis view
        (CompareFrameController label actions)."""
        action = body.get("action", "create")
        with self._lock:
            messages = self.analysis.proto_analyzer.messages
            msg_index = int(body["message"])
            if not 0 <= msg_index < len(messages):
                raise ValueError(f"no analysis message {msg_index}")
            mt = messages[msg_index].message_type

            if action == "create":
                self.analysis.active_message_type = mt
                view = int(body.get("view", 0))
                lbl = self.analysis.add_protocol_label(
                    int(body["start"]), int(body["end"]), msg_index, view)
                if lbl is False:
                    raise ValueError("label creation failed (bad range)")
                if body.get("name"):
                    lbl.name = str(body["name"])
                if body.get("field_type"):
                    self._apply_label_field_type(mt, lbl,
                                                 body["field_type"])
                return self._label_reply(mt)

            label_index = int(body["label"])
            if not 0 <= label_index < len(mt):
                raise ValueError(f"no label {label_index} on type {mt.name}")
            lbl = mt[label_index]
            if action == "delete":
                mt.remove(lbl)
            elif action == "edit":
                if body.get("name"):
                    lbl.name = str(body["name"])
                if body.get("field_type"):
                    self._apply_label_field_type(mt, lbl,
                                                 body["field_type"])
                    lbl = mt[label_index]  # checksum promotion rebuilds
                if "start" in body or "end" in body:
                    # same view-coordinate conversion as create; defaults
                    # for an untouched bound are the stored BIT range
                    # converted into the request's view space first
                    view = int(body.get("view", 0))
                    msg = messages[msg_index]
                    def_start = msg.convert_index(
                        lbl.start, 0, view, decoded=True)[0]
                    def_end = msg.convert_index(
                        lbl.end - 1, 0, view, decoded=True)[0]
                    start = int(body.get("start", def_start))
                    end = int(body.get("end", def_end))
                    bit_start, bit_end = msg.convert_range(
                        start, end, view, 0, decoded=True)
                    lbl.start = bit_start
                    lbl.end = bit_end + 1
                mt.sort()
            else:
                raise ValueError(f"unknown action {action}")
            self.analysis.label_value_model_update()
            self.analysis.protocol_model.update()
            return self._label_reply(mt)

    # -- generator -----------------------------------------------------------
    def analysis_cell(self, _q, body):
        """Type a bit / hex nibble / ascii char into an analysis table
        cell (the reference's writeable protocol table)."""
        with self._lock:
            model = self.analysis.protocol_model
            model.proto_view = int(body.get("view", 0))
            was_writeable = model.is_writeable
            model.is_writeable = True  # the API call IS the write toggle
            try:
                ok = model.set_data(int(body["row"]), int(body["col"]),
                                    str(body["value"]))
            finally:
                model.is_writeable = was_writeable
            if not ok:
                raise ValueError("cell edit rejected (bad value or index)")
            msg = self.analysis.proto_analyzer.messages[int(body["row"])]
            return {"row": int(body["row"]),
                    "data": msg.view_to_string(model.proto_view, decoded=True,
                                               show_pauses=False)}

    def generator_cell(self, _q, body):
        """Edit a generator table cell (always writeable, like the
        reference's generator tab)."""
        with self._lock:
            model = self.generator.table_model
            model.proto_view = int(body.get("view", 0))
            ok = model.set_data(int(body["row"]), int(body["col"]),
                                str(body["value"]))
            if not ok:
                raise ValueError("cell edit rejected (bad value or index)")
            msg = self.generator.protocol.messages[int(body["row"])]
            return {"row": int(body["row"]),
                    "data": msg.view_to_string(model.proto_view, decoded=False,
                                               show_pauses=False)}

    def generator_add(self, _q, body):
        with self._lock:
            frame = self._frame(int(body["signal_id"]))
            proto = frame.show_protocol()
            self.generator.add_protocol(proto)
            return {"rows": len(self.generator.protocol.messages)}

    def generator_table(self, q, _body):
        view = int(q.get("view", [0])[0])
        with self._lock:
            msgs = self.generator.protocol.messages
            return {"rows": [{"data": m.view_to_string(view, decoded=False,
                                                       show_pauses=False),
                              "pause": int(m.pause)} for m in msgs],
                    "total_samples": int(self.generator.total_modulated_samples),
                    "estimated_time_s": float(self.generator.estimated_time_s())}

    def generator_fuzz(self, _q, body):
        with self._lock:
            self.generator.fuzz(body.get("mode", "successive"))
            return {"rows": len(self.generator.protocol.messages)}

    def _fuzz_label(self, msg_index: int, label_index: int):
        msg = self.generator.protocol.messages[msg_index]
        labels = msg.message_type
        if not 0 <= label_index < len(labels):
            raise ValueError(f"no label {label_index}")
        return labels[label_index]

    def generator_fuzz_label(self, _q, body):
        """Create a fuzzing label over a bit range of a generator message
        (reference: FuzzingDialog creation from a table selection)."""
        with self._lock:
            msg_index = int(body["message"])
            if not 0 <= msg_index < len(self.generator.protocol.messages):
                raise ValueError(f"no generator message {msg_index}")
            lbl = self.generator.create_fuzzing_label(
                msg_index, int(body["start"]), int(body["end"]))
            msg = self.generator.protocol.messages[msg_index]
            if not lbl.fuzz_values:
                # seed with the current value, like the FuzzingDialog
                lbl.fuzz_values.append("".join(
                    map(str, msg.plain_bits[lbl.start:lbl.end])))
            return {"label": msg.message_type.index(lbl), "name": lbl.name,
                    "values": list(lbl.fuzz_values)}

    def generator_fuzz_values(self, _q, body):
        """Populate a fuzzing label's value list: explicit range,
        boundaries, or random values (FuzzingDialog edit modes)."""
        from urh_tpu_torch.ui.models import FuzzingTableModel

        with self._lock:
            lbl = self._fuzz_label(int(body["message"]), int(body["label"]))
            model = FuzzingTableModel(lbl)
            mode = body.get("mode", "range")
            if mode == "range":
                model.add_range(int(body["start"]), int(body["end"]),
                                int(body.get("step", 1)))
            elif mode == "boundaries":
                model.add_boundaries(int(body["lower"]), int(body["upper"]),
                                     int(body.get("num_values", 1)))
            elif mode == "random":
                model.add_random(int(body["number"]), int(body["minimum"]),
                                 int(body["maximum"]),
                                 seed=body.get("seed"))
            else:
                raise ValueError(f"unknown fuzz value mode {mode}")
            return {"values": list(lbl.fuzz_values)}

    # -- modulator editor ----------------------------------------------------
    # Reference: controller/dialogs/ModulatorDialog.py (carrier f/phi/amp,
    # sps, bits-per-symbol, per-symbol parameter grid, live waveform
    # preview) + per-message modulator assignment in the generator table.

    _MODULATOR_FIELDS = ("name", "modulation_type", "carrier_freq_hz",
                         "carrier_amplitude", "carrier_phase_deg",
                         "samples_per_symbol", "bits_per_symbol",
                         "sample_rate", "parameters", "gauss_bt",
                         "gauss_filter_width", "display_bits")

    @staticmethod
    def _modulator_dict(index, m) -> dict:
        return {"index": index, "name": m.name,
                "modulation_type": m.modulation_type,
                "carrier_freq_hz": float(m.carrier_freq_hz),
                "carrier_amplitude": float(m.carrier_amplitude),
                "carrier_phase_deg": float(m.carrier_phase_deg),
                "samples_per_symbol": int(m.samples_per_symbol),
                "bits_per_symbol": int(m.bits_per_symbol),
                "sample_rate": float(m.sample_rate),
                "parameters": [float(p) for p in m.parameters],
                "parameter_type": m.parameter_type_str,
                "gauss_bt": float(m.gauss_bt),
                "gauss_filter_width": float(m.gauss_filter_width),
                "display_bits": m.display_bits}

    def _apply_modulator_fields(self, m, body: dict):
        import array as array_mod

        for field in self._MODULATOR_FIELDS:
            if field not in body:
                continue
            value = body[field]
            if field == "parameters":
                continue  # after bits_per_symbol (its setter resets them)
            elif field in ("samples_per_symbol", "bits_per_symbol"):
                value = int(value)
            elif field in ("name", "modulation_type", "display_bits"):
                value = str(value)
                if field == "modulation_type" and (
                        value not in m.MODULATION_TYPES):
                    raise ValueError(f"unknown modulation type {value}")
            else:
                value = float(value)
            setattr(m, field, value)
        if "parameters" in body:
            params = [float(p) for p in body["parameters"]]
            if len(params) != m.modulation_order:
                raise ValueError(
                    f"need {m.modulation_order} parameters for "
                    f"{m.bits_per_symbol} bit(s) per symbol, got "
                    f"{len(params)}")
            m.parameters = array_mod.array("f", params)

    def generator_modulators(self, _q, _body):
        with self._lock:
            return {"modulators": [self._modulator_dict(i, m) for i, m
                                   in enumerate(self.generator.modulators)]}

    def generator_modulator_edit(self, _q, body):
        """Create / edit / delete a modulator (ModulatorDialog lifecycle;
        edits mark modulation_was_edited so bootstrap won't clobber
        them)."""
        from urh_tpu_torch.dsp.modulator import Modulator

        action = body.get("action", "edit")
        with self._lock:
            modulators = self.generator.modulators
            if action == "create":
                m = Modulator(str(body.get("name",
                                           f"Modulation {len(modulators)}")))
                self._apply_modulator_fields(m, body)
                modulators.append(m)
                self.generator.modulation_was_edited = True
                return self._modulator_dict(len(modulators) - 1, m)

            index = int(body.get("index", 0))
            if not 0 <= index < len(modulators):
                raise ValueError(f"no modulator {index}")
            if action == "delete":
                if len(modulators) == 1:
                    raise ValueError("cannot delete the last modulator")
                modulators.pop(index)
                for msg in self.generator.protocol.messages:
                    if msg.modulator_index >= len(modulators):
                        msg.modulator_index = 0
                return {"modulators": [m.name for m in modulators]}
            if action == "edit":
                self._apply_modulator_fields(modulators[index], body)
                self.generator.modulation_was_edited = True
                return self._modulator_dict(index, modulators[index])
            raise ValueError(f"unknown action {action}")

    def generator_modulator_preview(self, q, _body):
        """Waveform preview PNG of a modulator over its display bits (or
        ?bits=): the ModulatorDialog's live original-signal view."""
        from urh_tpu_torch.ui.plots import render_waveform_rgba
        from urh_tpu_torch.ui.png import encode_rgba

        with self._lock:
            modulators = self.generator.modulators
            index = int(q.get("index", [0])[0])
            if not 0 <= index < len(modulators):
                raise ValueError(f"no modulator {index}")
            m = modulators[index]
            bits_str = q.get("bits", [m.display_bits])[0]
            if not set(bits_str) <= {"0", "1"} or not bits_str:
                raise ValueError("bits must be a non-empty bit string")
            width = int(q.get("width", [600])[0])
            height = int(q.get("height", [120])[0])
            iq = m.modulate([b == "1" for b in bits_str], pause=0,
                            dtype=np.float32, device=self.device)
            image = render_waveform_rgba(iq.data[:, 0], width, height)
            return encode_rgba(image), "image/png"

    def generator_message_modulator(self, _q, body):
        """Assign a modulator to generator table rows (the per-message
        modulation combo in the reference's generator table)."""
        with self._lock:
            modulators = self.generator.modulators
            index = int(body["modulator_index"])
            if not 0 <= index < len(modulators):
                raise ValueError(f"no modulator {index}")
            messages = self.generator.protocol.messages
            rows = body.get("rows")
            rows = range(len(messages)) if rows is None else [
                int(r) for r in rows]
            for row in rows:
                if not 0 <= row < len(messages):
                    raise ValueError(f"no generator message {row}")
                messages[row].modulator_index = index
            return {"modulator": modulators[index].name,
                    "rows": [int(r) for r in rows]}

    def generator_profile(self, _q, body):
        """Save/load a fuzzing profile (.fuzz.xml) — the reference
        generator tab's profile menu (MainController.py:392-394)."""
        import os
        import xml.etree.ElementTree as ET

        from urh_tpu_torch.dsp.modulator import Modulator

        action = body.get("action", "load")
        path = str(body["path"])
        with self._lock:
            if action == "load":
                if not os.path.isfile(path):
                    raise ValueError(f"no such profile {path}")
                try:
                    root = ET.parse(path).getroot()
                except ET.ParseError as e:
                    raise ValueError(f"unparseable profile: {e}")
                self.main.add_fuzz_profile(path)
                # restore saved modulators (message modulator indices
                # refer to them; reference MainController does the same)
                mod_tag = root.find("modulators")
                if mod_tag is not None and len(mod_tag):
                    self.generator.modulators[:] = \
                        Modulator.modulators_from_xml_tag(mod_tag)
                    self.generator.modulation_was_edited = True
            elif action == "save":
                self.generator.protocol.to_xml_file(
                    path, self.analysis.decodings,
                    self.main.project_manager.participants,
                    modulators=self.generator.modulators)
            else:
                raise ValueError(f"unknown profile action {action}")
            return {"action": action, "path": path,
                    "rows": len(self.generator.protocol.messages),
                    "modulators": len(self.generator.modulators)}

    def generator_set_pause(self, _q, body):
        with self._lock:
            if "index" in body:
                self.generator.edit_pause_item(int(body["index"]),
                                               int(body["pause"]))
            else:
                self.generator.edit_all_pause_items(int(body["pause"]))
            return {"ok": True}

    def generator_generate(self, _q, body):
        with self._lock:
            if body.get("filename"):
                self.generator.generate_file(body["filename"])
                return {"saved": body["filename"],
                        "samples": int(self.generator.total_modulated_samples)}
            iq = self.generator.generate_iq()
            return {"samples": int(len(iq))}

    # -- simulator -----------------------------------------------------------
    def simulator_load(self, _q, body):
        with self._lock:
            self.main.add_simulator_profile(body["path"])
            return self.simulator_items(_q, None)

    def _sim_item_fields(self, item) -> dict:
        from urh_tpu_torch.sim import items as si

        if isinstance(item, si.SimulatorMessage):
            parts = self.main.project_manager.participants
            def pref(p):
                return (parts.index(p) if p in parts else
                        "broadcast" if p is self.simulator_config.broadcast_part
                        else None)
            return {"bits": item.plain_bits_str, "pause": int(item.pause),
                    "repeat": int(item.repeat),
                    "message_type": item.message_type.name,
                    "source": pref(item.source),
                    "destination": pref(item.destination)}
        if isinstance(item, si.SimulatorProtocolLabel):
            return {"name": item.name, "start": int(item.start),
                    "end": int(item.end),
                    "value_type_index": int(item.value_type_index),
                    "value_type": item.VALUE_TYPES[item.value_type_index],
                    "formula": item.formula,
                    "external_program": item.external_program,
                    "random_min": int(item.random_min),
                    "random_max": int(item.random_max)}
        if isinstance(item, si.SimulatorRuleCondition):
            return {"condition_type": item.type.value,
                    "condition": item.condition}
        if isinstance(item, si.SimulatorGotoAction):
            return {"goto_target": item.goto_target,
                    "valid_targets": item.get_valid_goto_targets()}
        if isinstance(item, si.SimulatorCounterAction):
            return {"start": int(item.start), "step": int(item.step)}
        if isinstance(item, si.SimulatorSleepAction):
            return {"sleep_time": float(item.sleep_time)}
        if isinstance(item, si.SimulatorTriggerCommandAction):
            return {"command": item.command,
                    "pass_transcript": bool(item.pass_transcript)}
        return {}

    def _sim_item_dict(self, item) -> dict:
        return {"index": item.index(), "type": type(item).__name__,
                "label": str(item), "valid": bool(item.validate()),
                "fields": self._sim_item_fields(item)}

    def simulator_items(self, _q, _body):
        with self._lock:
            self.simulator_config.update_item_dict()
            items = [self._sim_item_dict(item)
                     for item in self.simulator_config.get_all_items()]
            return {"items": items,
                    "valid": bool(self.simulator_config.protocol_valid())}

    # -- simulator flow authoring --------------------------------------------
    # CRUD over the item tree so a flow can be constructed entirely in
    # the app (reference: controller/SimulatorTabController.py +
    # ui/SimulatorScene.py item creation; expression validation via
    # SimulatorExpressionParser.py:19-80 semantics).

    def _sim_item_by_index(self, index_str: str):
        index_str = str(index_str)
        for item in self.simulator_config.get_all_items():
            if item.index() == index_str:
                return item
        raise ValueError(f"no simulator item {index_str}")

    def _sim_participant(self, ref):
        if ref is None or ref == "broadcast":
            return self.simulator_config.broadcast_part
        parts = self.main.project_manager.participants
        index = int(ref)
        if not 0 <= index < len(parts):
            raise ValueError(f"no participant {ref}")
        return parts[index]

    def _apply_sim_fields(self, item, body: dict):
        from urh_tpu_torch.coding.encodings import str2bit
        from urh_tpu_torch.sim import items as si

        if isinstance(item, si.SimulatorMessage):
            if "bits" in body:
                bits = str(body["bits"])
                if not bits or not set(bits) <= {"0", "1"}:
                    raise ValueError("bits must be a non-empty bit string")
                item.plain_bits = str2bit(bits)
            if "pause" in body:
                item.pause = int(body["pause"])
            if "repeat" in body:
                item.repeat = int(body["repeat"])
            if "source" in body:
                item.source = self._sim_participant(body["source"])
            if "destination" in body:
                item.destination = self._sim_participant(body["destination"])
        elif isinstance(item, si.SimulatorProtocolLabel):
            if "value_type_index" in body and not (
                    0 <= int(body["value_type_index"])
                    < len(item.VALUE_TYPES)):
                raise ValueError("value_type_index out of range")
            for field, cast in (("value_type_index", int), ("formula", str),
                                ("external_program", str),
                                ("random_min", int), ("random_max", int),
                                ("name", str)):
                if field in body:
                    setattr(item, field, cast(body[field]))
            if "start" in body or "length" in body:
                start = int(body.get("start", item.start))
                length = int(body.get("length", item.end - item.start))
                item.start = start
                item.end = start + length
        elif isinstance(item, si.SimulatorRuleCondition):
            if "condition_type" in body:
                item.type = si.ConditionType(str(body["condition_type"]))
            if "condition" in body:
                item.condition = str(body["condition"])
        elif isinstance(item, si.SimulatorGotoAction):
            if "goto_target" in body:
                item.goto_target = str(body["goto_target"])
        elif isinstance(item, si.SimulatorCounterAction):
            if "start" in body:
                item.start = int(body["start"])
                item.reset_value()
            if "step" in body:
                item.step = int(body["step"])
        elif isinstance(item, si.SimulatorSleepAction):
            if "sleep_time" in body:
                item.sleep_time = float(body["sleep_time"])
        elif isinstance(item, si.SimulatorTriggerCommandAction):
            if "command" in body:
                item.command = str(body["command"])
            if "pass_transcript" in body:
                item.pass_transcript = bool(body["pass_transcript"])
        else:
            raise ValueError(f"{type(item).__name__} has no editable fields")

    def _create_sim_item(self, body: dict):
        from urh_tpu_torch.coding.encodings import str2bit
        from urh_tpu_torch.protocol.labels import MessageType
        from urh_tpu_torch.sim import items as si

        kind = str(body.get("type", ""))
        if kind == "message":
            bits = str(body.get("bits", ""))
            if not bits or not set(bits) <= {"0", "1"}:
                raise ValueError("message needs bits (a bit string)")
            item = si.SimulatorMessage(
                destination=self._sim_participant(body.get("destination")),
                plain_bits=str2bit(bits), pause=int(body.get("pause", 0)),
                message_type=MessageType(
                    str(body.get("message_type", "default"))),
                source=self._sim_participant(body.get("source")))
            return item
        if kind == "rule":
            return si.SimulatorRule()
        if kind == "condition":
            return si.SimulatorRuleCondition(
                si.ConditionType(str(body.get("condition_type", "IF"))))
        if kind == "goto":
            return si.SimulatorGotoAction()
        if kind == "counter":
            return si.SimulatorCounterAction()
        if kind == "sleep":
            return si.SimulatorSleepAction()
        if kind == "trigger":
            return si.SimulatorTriggerCommandAction()
        raise ValueError(f"unknown item type {kind!r}")

    def simulator_item(self, _q, body):
        """Create / edit / delete / move simulator flow items.  Create
        returns the new item (with its tree index); a ``label`` type
        attaches to its parent message."""
        from urh_tpu_torch.sim import items as si

        action = body.get("action", "create")
        config = self.simulator_config
        with self._lock:
            if action == "create":
                parent = (self._sim_item_by_index(body["parent"])
                          if body.get("parent") is not None else None)
                if body.get("type") == "label":
                    if not isinstance(parent, si.SimulatorMessage):
                        raise ValueError("label needs a message parent")
                    mt = parent.message_type
                    start = int(body.get("start", 0))
                    length = int(body.get("length", 1))
                    lbl = mt.add_protocol_label_start_length(
                        start, length, name=body.get("name"))
                    if lbl is None:
                        raise ValueError("label range overlaps or invalid")
                    sim_label = si.SimulatorProtocolLabel(lbl)
                    mt.remove(lbl)
                    parent.insert_child(-1, sim_label)
                    self._apply_sim_fields(sim_label, body)
                    config.update_item_dict()
                    return self._sim_item_dict(sim_label)
                item = self._create_sim_item(body)
                target = parent if parent is not None else config.rootItem
                pos = int(body.get("pos", -1))
                if pos < 0:
                    pos = target.child_count()
                config.add_items([item], pos, parent)
                if isinstance(item, si.SimulatorRule) and body.get(
                        "with_condition", True):
                    config.add_items(
                        [si.SimulatorRuleCondition(si.ConditionType.IF)],
                        0, item)
                if not isinstance(item, si.SimulatorRule):
                    self._apply_sim_fields(item, body)
                config.update_item_dict()
                return self._sim_item_dict(item)

            item = self._sim_item_by_index(body["item"])
            if action == "edit":
                self._apply_sim_fields(item, body)
                config.update_item_dict()
                return self._sim_item_dict(item)
            if action == "delete":
                config.delete_items([item])
                config.update_item_dict()
                return {"items": len(config.get_all_items())}
            if action == "move":
                parent = (self._sim_item_by_index(body["parent"])
                          if body.get("parent") is not None else None)
                config.move_items([item], int(body.get("pos", 0)), parent)
                config.update_item_dict()
                return self._sim_item_dict(item)
            raise ValueError(f"unknown action {action}")

    def simulator_validate(self, _q, body):
        """Expression validation for formulas / rule conditions (the
        reference's live SimulatorExpressionParser feedback)."""
        tab = self.main.simulator_tab_controller
        expr = str(body.get("expression", ""))
        is_formula = bool(body.get("is_formula", True))
        with self._lock:
            self.simulator_config.update_item_dict()
            valid, message, _ = tab.sim_expression_parser.validate_expression(
                expr, is_formula=is_formula)
            return {"valid": bool(valid), "message": message,
                    "identifiers": tab.sim_expression_parser.get_identifiers()}

    def simulator_save(self, _q, body):
        with self._lock:
            self.main.simulator_tab_controller.save_simulator_file(
                body["path"])
            return {"saved": body["path"]}

    def simulator_transcript(self, _q, _body):
        with self._lock:
            sim = self.main.simulator_tab_controller.simulator
            if sim is None:
                return {"transcript": []}
            return {"transcript": sim.transcript.get_for_all_participants(
                all_rounds=True)}

    # -- project settings (ProjectDialog / OptionsDialog surface) -------------
    _PROJECT_SETTING_FIELDS = {
        "simulator_num_repeat": int, "simulator_retries": int,
        "simulator_timeout_ms": int, "simulator_error_handling_index": int,
        "broadcast_address_hex": str,
    }
    _DEVICE_CONF_FIELDS = ("frequency", "sample_rate", "bandwidth", "gain",
                           "if_gain", "baseband_gain", "name")

    def project_settings(self, _q, _body):
        with self._lock:
            pm = self.main.project_manager
            out = {name: cast(getattr(pm, name))
                   for name, cast in self._PROJECT_SETTING_FIELDS.items()}
            out["device_conf"] = {k: v for k, v in pm.device_conf.items()}
            out["project_path"] = pm.project_path
            from urh_tpu_torch.util import settings as settings_mod

            out["modulation_dtype"] = settings_mod.read(
                "modulation_dtype", "float32", str)
            return out

    def project_settings_edit(self, _q, body):
        """Project + app options: simulator retry/timeout policy,
        broadcast address, default device conf, modulation dtype
        (reference: ProjectDialog.py + OptionsDialog.py fields)."""
        from urh_tpu_torch.util import settings as settings_mod

        with self._lock:
            pm = self.main.project_manager
            for name, cast in self._PROJECT_SETTING_FIELDS.items():
                if name in body:
                    setattr(pm, name, cast(body[name]))
            for key, value in (body.get("device_conf") or {}).items():
                if key not in self._DEVICE_CONF_FIELDS:
                    raise ValueError(f"unknown device_conf key {key}")
                pm.device_conf[key] = (str(value) if key == "name"
                                       else float(value))
            if "modulation_dtype" in body:
                if body["modulation_dtype"] not in ("float32", "int8",
                                                    "int16"):
                    raise ValueError("modulation_dtype must be "
                                     "float32/int8/int16")
                settings_mod.write("modulation_dtype",
                                   body["modulation_dtype"])
            self.simulator_config.on_project_updated()
            return self.project_settings(None, None)

    # -- participants (ProjectDialog's participant table) ---------------------
    def project_participants(self, _q, _body):
        with self._lock:
            return {"participants": [
                {"index": i, "name": p.name, "shortname": p.shortname,
                 "address_hex": p.address_hex, "simulate": bool(p.simulate),
                 "relative_rssi": int(p.relative_rssi)}
                for i, p in enumerate(self.main.project_manager.participants)]}

    def project_participants_edit(self, _q, body):
        from urh_tpu_torch.protocol.labels import Participant

        action = body.get("action", "create")
        with self._lock:
            parts = self.main.project_manager.participants
            if action == "create":
                parts.append(Participant(
                    str(body.get("name", "Participant")),
                    shortname=body.get("shortname"),
                    address_hex=body.get("address_hex"),
                    relative_rssi=int(body.get("relative_rssi", 0)),
                    simulate=bool(body.get("simulate", False))))
            else:
                index = int(body["index"])
                if not 0 <= index < len(parts):
                    raise ValueError(f"no participant {index}")
                if action == "delete":
                    parts.pop(index)
                elif action == "edit":
                    p = parts[index]
                    for field in ("name", "shortname", "address_hex"):
                        if field in body:
                            setattr(p, field, str(body[field]))
                    if "simulate" in body:
                        p.simulate = bool(body["simulate"])
                    if "relative_rssi" in body:
                        p.relative_rssi = int(body["relative_rssi"])
                else:
                    raise ValueError(f"unknown action {action}")
            self.simulator_config.on_project_updated()
            return self.project_participants(None, None)

    def simulator_start(self, _q, body):
        """Run the loaded/authored profile against live devices.  RX/TX
        default to the hardware-free Network SDR loopback; demod
        parameters and loopback ports come from the request (reference:
        SimulatorDialog device settings)."""
        import time as time_mod

        from urh_tpu_torch.dev.backend_handler import BackendHandler
        from urh_tpu_torch.dev.endless_sender import EndlessSender
        from urh_tpu_torch.protocol.sniffer import ProtocolSniffer

        body = body or {}
        with self._lock:
            tab = self.main.simulator_tab_controller
            handler = BackendHandler()
            sniffer = ProtocolSniffer(
                samples_per_symbol=int(body.get("samples_per_symbol", 100)),
                center=float(body.get("center", 0.0)),
                center_spacing=float(body.get("center_spacing", 0.1)),
                noise=float(body.get("noise", 0.01)),
                tolerance=int(body.get("tolerance", 5)),
                modulation_type=body.get("modulation_type", "FSK"),
                bits_per_symbol=int(body.get("bits_per_symbol", 1)),
                device=body.get("rx_device", "Network SDR"),
                backend_handler=handler, network_raw_mode=True,
                compute_device=self.device)
            if "rx_server_port" in body:
                sniffer.rcv_device.set_server_port(
                    int(body["rx_server_port"]))
            sender = EndlessSender(handler,
                                   body.get("tx_device", "Network SDR"))
            if "tx_client_port" in body:
                sender.device.set_client_port(int(body["tx_client_port"]))
            sim = tab.start_simulation(sniffer=sniffer, sender=sender)
        # report the bound RX port (0-port requests bind on start);
        # poll OUTSIDE the lock so other API requests are not stalled
        rx_port = 0
        deadline = time_mod.monotonic() + 5.0
        while time_mod.monotonic() < deadline:
            rx_port = self._device_port(sniffer.rcv_device)
            if rx_port:
                break
            time_mod.sleep(0.05)
        return {"running": sim.is_simulating, "rx_port": rx_port}

    def simulator_stop(self, _q, _body):
        with self._lock:
            self.main.simulator_tab_controller.stop_simulation()
            return {"running": False}

    def simulator_log(self, _q, _body):
        with self._lock:
            sim = self.main.simulator_tab_controller.simulator
            if sim is None:
                return {"running": False, "log": []}
            return {"running": bool(sim.is_simulating),
                    "log": list(sim.log_messages)}

    # -- device operation ----------------------------------------------------
    # The reference's device dialogs: ReceiveDialog.py:22 (record to a
    # new signal), SendDialog.py:14 (TX a signal / the generator table),
    # SpectrumDialogController.py:60 (live FFT view with retune) and
    # ProtocolSniffDialog.py:19 (live sniffing into the analysis table).
    # Hardware-free operation uses the Network SDR TCP loopback exactly
    # like tests/test_device_layer.py.

    def _make_device(self, mode, body: dict, samples_to_send=None,
                     sending_repeats=1):
        from urh_tpu_torch.dev.backend_handler import BackendHandler
        from urh_tpu_torch.dev.virtual_device import VirtualDevice

        body = body or {}
        name = body.get("device", "Network SDR")
        dev = VirtualDevice(
            BackendHandler(), name, mode,
            freq=body.get("frequency"),
            sample_rate=body.get("sample_rate"),
            bandwidth=body.get("bandwidth"),
            gain=body.get("gain"), if_gain=body.get("if_gain"),
            baseband_gain=body.get("baseband_gain"),
            device_ip=body.get("device_ip"),
            samples_to_send=samples_to_send,
            sending_repeats=sending_repeats,
            resume_on_full_receive_buffer=bool(
                body.get("resume_on_full_receive_buffer", False)),
            raw_mode=True)
        if "server_port" in body:
            dev.set_server_port(int(body["server_port"]))
        if "client_port" in body:
            dev.set_client_port(int(body["client_port"]))
        return dev

    def _device_port(self, dev) -> int:
        under = dev.underlying_device
        return int(getattr(under, "server_port", 0) or 0)

    @staticmethod
    def _device_freq(dev) -> float:
        try:
            return float(dev.frequency or 0)
        except ValueError:  # network backend has no tuner
            return 0.0

    def _device_status(self, kind: str) -> dict:
        dev = self._devices.get(kind)
        if dev is None:
            return {"kind": kind, "running": False}
        total = 0
        if dev.mode.name == "send" and dev.data is not None:
            total = int(len(dev.data))
        elif dev.mode.name != "send":
            buf = dev.data
            total = int(len(buf)) if buf is not None else 0
        return {"kind": kind, "running": True, "device": dev.name,
                "mode": dev.mode.name,
                "current_index": int(dev.current_index),
                "total": total, "port": self._device_port(dev),
                "frequency": self._device_freq(dev),
                "sample_rate": float(dev.sample_rate or 0),
                "messages": dev.read_messages()}

    def device_list(self, _q, _body):
        from urh_tpu_torch.dev.backend_handler import BackendHandler
        from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin

        handler = BackendHandler()
        out = []
        for name in handler.DEVICE_NAMES:
            entry = handler.device_backends.get(name.lower())
            out.append({"name": name,
                        "available": bool(entry and entry.is_enabled
                                          and entry.selected_backend.name
                                          != "none")})
        out.append({"name": NetworkSDRInterfacePlugin.NETWORK_SDR_NAME,
                    "available": True})
        return {"devices": out}

    def device_backend(self, _q, body):
        """Per-device backend selection + enable toggle (the reference
        OptionsDialog's device table, BackendHandler settings keys)."""
        display_name = str(body["device"])
        with self._lock:
            return self._device_backend_locked(display_name, body)

    def _device_backend_locked(self, display_name: str, body):
        from urh_tpu_torch.dev.backend_handler import BackendHandler, Backends

        handler = BackendHandler()
        entry = handler.device_backends.get(display_name.lower())
        if entry is None:
            raise ValueError(f"unknown device {display_name!r}")
        if "backend" in body:
            try:
                backend = Backends[str(body["backend"])]
            except KeyError:
                raise ValueError(f"unknown backend {body['backend']!r}")
            if backend not in entry.avail_backends:
                raise ValueError(
                    f"{body['device']} has no {backend.name} backend "
                    f"(available: "
                    f"{sorted(b.name for b in entry.avail_backends)})")
            entry.selected_backend = backend
            entry.write_settings()
        if "enabled" in body:
            entry.set_enabled(bool(body["enabled"]))
        return {"device": display_name,
                "selected_backend": entry.selected_backend.name,
                "available_backends":
                    sorted(b.name for b in entry.avail_backends),
                "enabled": bool(entry.is_enabled),
                "supports_rx": bool(entry.supports_rx),
                "supports_tx": bool(entry.supports_tx)}

    def device_status(self, _q, _body):
        with self._lock:
            status = {kind: self._device_status(kind)
                      for kind in ("record", "send", "spectrum")}
            rfcat = getattr(self, "_rfcat", None)
            status["rfcat"] = {"kind": "rfcat",
                              "running": bool(rfcat is not None
                                              and rfcat.is_sending)}
            return status

    def _start_device(self, kind: str, mode_name: str, body):
        from urh_tpu_torch.dev.virtual_device import Mode

        if self._devices.get(kind) is not None:
            raise ValueError(f"{kind} already running (stop it first)")
        dev = self._make_device(Mode[mode_name], body)
        self._devices[kind] = dev
        dev.start()
        return dev

    def _stop_device(self, kind: str, free_data=False):
        dev = self._devices.pop(kind, None)
        if dev is None:
            return None
        dev.stop(f"{kind} stopped via web API")
        if free_data:
            dev.free_data()
        return dev

    def device_record_start(self, _q, body):
        with self._lock:
            dev = self._start_device("record", "receive", body)
            self._recorded = None
            return {"running": True, "port": self._device_port(dev)}

    def device_record_stop(self, _q, _body):
        """Stop recording, keeping the captured samples for save
        (ReceiveDialog keeps device data until Clear/Save)."""
        with self._lock:
            dev = self._stop_device("record")
            if dev is None:
                return {"running": False, "num_samples": 0}
            n = int(dev.current_index)
            buf = dev.data
            arr = np.asarray(buf.data if hasattr(buf, "data") else buf)[:n]
            self._recorded = (np.array(arr, dtype=np.float32),
                              float(dev.sample_rate or 1e6))
            dev.free_data()
            return {"running": False, "num_samples": n}

    def device_record_save(self, _q, body):
        """Recorded samples -> a new signal in the interpretation tab
        (the ReceiveDialog 'save' path, minus the file dialog — an
        optional ``path`` also writes the capture to disk)."""
        from urh_tpu_torch.core.signal import Signal

        body = body or {}
        with self._lock:
            if getattr(self, "_recorded", None) is None:
                raise ValueError("nothing recorded (record then stop first)")
            data, sample_rate = self._recorded
            if not len(data):
                raise ValueError("recording is empty")
            name = body.get("name", "recorded")
            if body.get("path"):
                from urh_tpu_torch.util.file_operator import save_data

                save_data(data, body["path"], sample_rate=sample_rate)
            signal = Signal.from_samples(data, name, sample_rate,
                                         device=self.device)
            frame = self.main.add_signal(signal)
            return self._signal_summary(
                self.main.signal_frames.index(frame), frame)

    def device_send_start(self, _q, body):
        """TX a signal's samples or the modulated generator table
        (SendDialog semantics; the generator path is the reference's
        GeneratorTabController 'send' button).  ``continuous: true``
        streams the generator table through a ContinuousModulator
        worker + shared ring buffer instead of pre-modulating
        everything (ContinuousSendDialog semantics; repeats <= 0 =
        forever)."""
        from urh_tpu_torch.dev.virtual_device import Mode

        body = body or {}
        with self._lock:
            if self._devices.get("send") is not None:
                raise ValueError("send already running (stop it first)")
            repeats = int(body.get("repeats", 1))

            if body.get("continuous"):
                from urh_tpu_torch.dsp.continuous_modulator import ContinuousModulator

                messages = self.generator.protocol.messages
                if not messages:
                    raise ValueError("generator table is empty")
                total = (None if repeats <= 0 else
                         repeats * int(
                             self.generator.total_modulated_samples))
                dev = self._make_device(Mode.send, body, sending_repeats=1)
                # synthesis dtype = the TX device's wire format (the
                # Network SDR streams float32 regardless of the
                # configured modulation dtype)
                cm = ContinuousModulator(messages,
                                         self.generator.modulators,
                                         num_repeats=repeats,
                                         dtype=dev.data_type,
                                         device=self.device)
                dev.continuous_send_ring_buffer = cm.ring_buffer
                dev.is_send_continuous = True
                dev.num_samples_to_send = total
                self._devices["send"] = dev
                self._continuous_mod = cm
                cm.start()
                dev.start()
                return {"running": True, "continuous": True,
                        "total": total}

            if "signal_id" in body:
                samples = self._frame(
                    int(body["signal_id"])).signal.iq_array.data
            elif body.get("source") == "generator":
                samples = self.generator.generate_iq().data
            else:
                raise ValueError("need signal_id or source='generator'")
            samples = np.ascontiguousarray(samples, dtype=np.float32)
            dev = self._make_device(Mode.send, body,
                                    samples_to_send=samples,
                                    sending_repeats=repeats)
            self._devices["send"] = dev
            dev.start()
            return {"running": True, "total": int(len(samples))}

    def device_send_status(self, _q, _body):
        with self._lock:
            dev = self._devices.get("send")
            if dev is None:
                return {"running": False}
            status = self._device_status("send")
            status["finished"] = bool(dev.sending_finished)
            if getattr(self, "_continuous_mod", None) is not None:
                status["continuous"] = True
                total = dev.num_samples_to_send
                status["total"] = int(total) if total else 0
            return status

    def device_send_stop(self, _q, _body):
        with self._lock:
            self._stop_device("send", free_data=True)
            cm = getattr(self, "_continuous_mod", None)
            if cm is not None:
                cm.stop()
                self._continuous_mod = None
            return {"running": False}

    def device_spectrum_start(self, _q, body):
        with self._lock:
            dev = self._start_device("spectrum", "spectrum", body)
            return {"running": True, "port": self._device_port(dev)}

    def device_spectrum_frame(self, q, _body):
        """One live FFT frame (freqs in Hz relative to the tune
        frequency, magnitudes), decimated to ``points`` bins — the
        reference's live spectrum view data."""
        with self._lock:
            dev = self._devices.get("spectrum")
            if dev is None:
                raise ValueError("spectrum analyzer not running")
            freqs, mags = dev.spectrum
            points = int(q.get("points", [512])[0])
            if len(mags) > points:
                # max-decimate into the requested number of bins
                usable = (len(mags) // points) * points
                mags_b = mags[:usable].reshape(points, -1).max(axis=1)
                freqs_b = freqs[:usable].reshape(points, -1).mean(axis=1)
            else:
                freqs_b, mags_b = freqs, mags
            return {"freqs": np.round(freqs_b, 1).tolist(),
                    "magnitudes": np.round(mags_b, 4).tolist(),
                    "frequency": self._device_freq(dev)}

    def device_spectrum_waterfall(self, q, _body):
        """Waterfall PNG of the spectrum analyzer's recent samples
        (the reference SpectrumDialog's scrolling spectrogram view),
        colormapped like the signal spectrogram endpoint."""
        from urh_tpu_torch.util import colormaps

        with self._lock:
            dev = self._devices.get("spectrum")
            if dev is None:
                raise ValueError("spectrum analyzer not running")
            window = int(q.get("window", [256])[0])
            buf = dev.data
            arr = np.asarray(buf.data if hasattr(buf, "data") else buf)
            n = int(dev.current_index)
            if 0 < n < len(arr):
                arr = arr[:max(n, window)]
            if len(arr) < window:
                raise ValueError("not enough samples yet")
            name = q.get("colormap", [colormaps.chosen_colormap_name])[0]
            samples = (arr[:, 0] + 1j * arr[:, 1]).astype(np.complex64)
            return self._spectrogram_png(samples, window, name)

    def device_spectrum_retune(self, _q, body):
        """Live retune (SpectrumDialogController's frequency edit /
        click-to-tune while running)."""
        with self._lock:
            dev = self._devices.get("spectrum")
            if dev is None:
                raise ValueError("spectrum analyzer not running")
            dev.frequency = float(body["frequency"])
            return {"frequency": self._device_freq(dev)
                    or float(body["frequency"])}

    def device_spectrum_stop(self, _q, _body):
        with self._lock:
            self._stop_device("spectrum", free_data=True)
            return {"running": False}

    def device_rfcat_send(self, _q, body):
        """TX the generator table through an rfcat dongle's REPL (the
        RfCat plugin; ``executable`` overrides the configured rfcat
        binary, e.g. for loopback fakes)."""
        from urh_tpu_torch.util import settings as settings_mod

        body = body or {}
        with self._lock:
            prev = getattr(self, "_rfcat", None)
            if prev is not None:
                if prev.is_sending:
                    raise ValueError("rfcat send already running")
                self._rfcat = None  # finished on its own: replace
            from urh_tpu_torch.plugins.rfcat import RfCatPlugin

            plugin = RfCatPlugin()
            if body.get("executable"):
                # per-request override on the INSTANCE — a failed
                # request must not clobber the configured binary
                plugin.rfcat_executable = str(body["executable"])
            if not plugin.rfcat_is_found:
                raise ValueError(
                    f"rfcat executable {plugin.rfcat_executable!r} "
                    "not found")
            # snapshot: concurrent generator edits must not touch the
            # list the TX thread iterates
            messages = list(self.generator.protocol.messages)
            if not messages:
                raise ValueError("generator table is empty")
            plugin.modulators = list(self.generator.modulators)
            plugin.project_manager = self.main.project_manager
            sample_rates = [
                self.generator.modulator_of_message(m).sample_rate
                for m in messages]
            plugin.start_message_sending_thread(messages, sample_rates)
            self._rfcat = plugin
            return {"sending": True, "messages": len(messages)}

    def device_rfcat_stop(self, _q, _body):
        with self._lock:
            plugin = getattr(self, "_rfcat", None)
            if plugin is not None:
                plugin.stop_sending_thread()
                self._rfcat = None
            return {"sending": False}

    # -- live sniffing -------------------------------------------------------
    def sniffer_start(self, _q, body):
        from urh_tpu_torch.dev.backend_handler import BackendHandler
        from urh_tpu_torch.protocol.sniffer import ProtocolSniffer

        body = body or {}
        with self._lock:
            if self._sniffer is not None:
                if self._sniffer.is_running:
                    raise ValueError("sniffer already running "
                                     "(stop it first)")
                self._sniffer = None  # stale stopped session: replace
            sniffer = ProtocolSniffer(
                samples_per_symbol=int(body.get("samples_per_symbol", 100)),
                center=float(body.get("center", 0.0)),
                center_spacing=float(body.get("center_spacing", 0.1)),
                noise=float(body.get("noise", 0.01)),
                tolerance=int(body.get("tolerance", 5)),
                modulation_type=body.get("modulation_type", "FSK"),
                bits_per_symbol=int(body.get("bits_per_symbol", 1)),
                device=body.get("device", "Network SDR"),
                backend_handler=BackendHandler(),
                network_raw_mode=True,
                device_ip=body.get("device_ip"),
                compute_device=self.device)
            sniffer.adaptive_noise = bool(body.get("adaptive_noise", False))
            sniffer.automatic_center = bool(body.get("automatic_center",
                                                     False))
            if "server_port" in body:
                sniffer.rcv_device.set_server_port(int(body["server_port"]))
            sniffer.sniff()
            self._sniffer = sniffer
            return {"running": True,
                    "port": self._device_port(sniffer.rcv_device)}

    def sniffer_messages(self, q, _body):
        """Messages sniffed so far, rendered in the requested view (the
        ProtocolSniffDialog's live text view)."""
        view = int(q.get("view", [0])[0])
        with self._lock:
            if self._sniffer is None:
                return {"running": False, "messages": []}
            msgs = [self._sniffer.message_to_string(m, view,
                                                    include_timestamps=False)
                    for m in list(self._sniffer.messages)]
            return {"running": bool(self._sniffer.is_running),
                    "messages": msgs}

    def sniffer_stop(self, _q, _body):
        with self._lock:
            if self._sniffer is None:
                return {"running": False, "messages": 0}
            self._sniffer.stop()
            n = len(self._sniffer.messages)
            return {"running": False, "messages": n}

    def sniffer_to_analysis(self, _q, _body):
        """Adopt the sniffed protocol into the analysis table (the
        reference's sniff dialog hands its protocol to the compare
        frame on accept)."""
        with self._lock:
            if self._sniffer is None:
                raise ValueError("no sniffer session")
            if self._sniffer.is_running:
                self._sniffer.stop()
            proto = self._sniffer
            if not proto.messages:
                raise ValueError("no sniffed messages")
            if proto not in self.analysis.protocol_list:
                self.analysis.add_protocol(proto)
            self.analysis.set_shown_protocols()
            self._sniffer = None
            return {"rows": len(self._analysis_messages())}


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

# (method, path regex) -> handler name; {id} groups become int arguments
ROUTES = [
    ("GET", r"/api/state", "state"),
    ("POST", r"/api/project/open", "project_open"),
    ("POST", r"/api/project/save", "project_save"),
    ("POST", r"/api/signal/open", "open_signal"),
    ("POST", r"/api/signal/import_csv", "import_csv"),
    ("GET", r"/api/signal/(\d+)/plot", "signal_plot"),
    ("POST", r"/api/signal/(\d+)/params", "signal_set_params"),
    ("POST", r"/api/signal/(\d+)/autodetect", "signal_autodetect"),
    ("GET", r"/api/signal/(\d+)/messages", "signal_messages"),
    ("GET", r"/api/signal/(\d+)/spectrogram", "signal_spectrogram"),
    ("POST", r"/api/signal/(\d+)/edit", "signal_edit"),
    ("GET", r"/api/signal/(\d+)/selection", "signal_selection"),
    ("POST", r"/api/signal/(\d+)/bandpass", "signal_bandpass"),
    ("POST", r"/api/signal/(\d+)/save", "signal_save"),
    ("POST", r"/api/signal/(\d+)/insert_sine", "signal_insert_sine"),
    ("POST", r"/api/analysis/message_break", "analysis_message_break"),
    ("POST", r"/api/analysis/zero_hide", "analysis_zero_hide"),
    ("POST", r"/api/analysis/export", "analysis_export"),
    ("GET", r"/api/colormaps", "colormaps_list"),
    ("POST", r"/api/signal/(\d+)/undo", "undo"),
    ("POST", r"/api/analysis/add", "analysis_add"),
    ("GET", r"/api/analysis/rows", "analysis_rows"),
    ("POST", r"/api/analysis/awre", "analysis_awre"),
    ("GET", r"/api/analysis/decodings", "analysis_decodings"),
    ("GET", r"/api/decoding/primitives", "decoding_primitives"),
    ("GET", r"/api/decoding/get", "decoding_get"),
    ("POST", r"/api/decoding/preview", "decoding_preview"),
    ("POST", r"/api/decoding/save", "decoding_save"),
    ("POST", r"/api/decoding/delete", "decoding_delete"),
    ("POST", r"/api/analysis/decoding", "analysis_set_decoding"),
    ("POST", r"/api/analysis/label", "analysis_label"),
    ("POST", r"/api/analysis/checksum_label", "analysis_checksum_label"),
    ("GET", r"/api/analysis/message_types", "analysis_message_types"),
    ("POST", r"/api/analysis/message_type", "analysis_message_type"),
    ("POST", r"/api/analysis/cell", "analysis_cell"),
    ("POST", r"/api/analysis/undo", "analysis_undo"),
    ("POST", r"/api/analysis/delete_range", "analysis_delete_range"),
    ("POST", r"/api/generator/undo", "generator_undo"),
    ("POST", r"/api/generator/insert_column", "generator_insert_column"),
    ("POST", r"/api/generator/clear", "generator_clear"),
    ("POST", r"/api/generator/cell", "generator_cell"),
    ("POST", r"/api/generator/add", "generator_add"),
    ("GET", r"/api/generator/table", "generator_table"),
    ("POST", r"/api/generator/fuzz", "generator_fuzz"),
    ("POST", r"/api/generator/fuzz_label", "generator_fuzz_label"),
    ("POST", r"/api/generator/fuzz_values", "generator_fuzz_values"),
    ("GET", r"/api/generator/modulators", "generator_modulators"),
    ("POST", r"/api/generator/modulator", "generator_modulator_edit"),
    ("GET", r"/api/generator/modulator_preview", "generator_modulator_preview"),
    ("POST", r"/api/generator/message_modulator", "generator_message_modulator"),
    ("POST", r"/api/generator/pause", "generator_set_pause"),
    ("POST", r"/api/generator/profile", "generator_profile"),
    ("POST", r"/api/generator/generate", "generator_generate"),
    ("GET", r"/api/device/list", "device_list"),
    ("GET", r"/api/device/status", "device_status"),
    ("POST", r"/api/device/backend", "device_backend"),
    ("POST", r"/api/device/rfcat/send", "device_rfcat_send"),
    ("POST", r"/api/device/rfcat/stop", "device_rfcat_stop"),
    ("POST", r"/api/device/record/start", "device_record_start"),
    ("POST", r"/api/device/record/stop", "device_record_stop"),
    ("POST", r"/api/device/record/save", "device_record_save"),
    ("POST", r"/api/device/send/start", "device_send_start"),
    ("GET", r"/api/device/send/status", "device_send_status"),
    ("POST", r"/api/device/send/stop", "device_send_stop"),
    ("POST", r"/api/device/spectrum/start", "device_spectrum_start"),
    ("GET", r"/api/device/spectrum/frame", "device_spectrum_frame"),
    ("GET", r"/api/device/spectrum/waterfall", "device_spectrum_waterfall"),
    ("POST", r"/api/device/spectrum/retune", "device_spectrum_retune"),
    ("POST", r"/api/device/spectrum/stop", "device_spectrum_stop"),
    ("POST", r"/api/sniffer/start", "sniffer_start"),
    ("GET", r"/api/sniffer/messages", "sniffer_messages"),
    ("POST", r"/api/sniffer/stop", "sniffer_stop"),
    ("POST", r"/api/sniffer/to_analysis", "sniffer_to_analysis"),
    ("POST", r"/api/simulator/load", "simulator_load"),
    ("GET", r"/api/simulator/items", "simulator_items"),
    ("POST", r"/api/simulator/item", "simulator_item"),
    ("POST", r"/api/simulator/validate", "simulator_validate"),
    ("POST", r"/api/simulator/save", "simulator_save"),
    ("GET", r"/api/simulator/transcript", "simulator_transcript"),
    ("GET", r"/api/project/participants", "project_participants"),
    ("POST", r"/api/project/participants", "project_participants_edit"),
    ("GET", r"/api/project/settings", "project_settings"),
    ("POST", r"/api/project/settings", "project_settings_edit"),
    ("POST", r"/api/simulator/start", "simulator_start"),
    ("POST", r"/api/simulator/stop", "simulator_stop"),
    ("GET", r"/api/simulator/log", "simulator_log"),
]


class _Handler(BaseHTTPRequestHandler):
    ui: WebUI = None  # set by make_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, status: int, payload: bytes, content_type: str):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _reply_json(self, obj, status=200):
        self._reply(status, json.dumps(obj).encode(), "application/json")

    def _dispatch(self, method: str):
        parsed = urlparse(self.path)
        if method == "GET" and parsed.path in ("/", "/index.html"):
            return self._reply(200, PAGE.encode(), "text/html; charset=utf-8")

        for route_method, pattern, name in ROUTES:
            if route_method != method:
                continue
            match = re.fullmatch(pattern, parsed.path)
            if not match:
                continue
            body = None
            if method == "POST":
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            args = [int(g) for g in match.groups()]
            query = parse_qs(parsed.query)
            try:
                result = getattr(self.ui, name)(*args, query, body)
            except (KeyError, ValueError) as e:
                return self._reply_json({"error": str(e)}, status=400)
            except Exception as e:  # surface, don't kill the server
                return self._reply_json(
                    {"error": f"{type(e).__name__}: {e}"}, status=500)
            if (isinstance(result, tuple) and len(result) == 2
                    and isinstance(result[0], (bytes, bytearray))):
                return self._reply(200, result[0], result[1])
            return self._reply_json(result)
        self._reply_json({"error": f"no route {method} {parsed.path}"}, 404)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def make_server(ui: WebUI = None, host="127.0.0.1", port=0) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"ui": ui or WebUI()})
    return ThreadingHTTPServer((host, port), handler)


def serve(host="127.0.0.1", port=8087, project_path="", device=None):
    server = make_server(WebUI(project_path, device=device), host, port)
    print(f"urh_tpu_torch web UI on http://{host}:{server.server_address[1]}/")
    server.serve_forever()


# ---------------------------------------------------------------------------
# The page
# ---------------------------------------------------------------------------

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>urh_tpu_torch</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#14151a;color:#e8e8ea}
 header{display:flex;gap:0;border-bottom:1px solid #33353d;background:#1c1d24}
 header b{padding:10px 16px;color:#7aa2ff}
 .tab{padding:10px 16px;cursor:pointer;border:none;background:none;color:#aaa;font-size:14px}
 .tab.active{color:#fff;border-bottom:2px solid #7aa2ff}
 main{padding:14px;max-width:1100px;margin:auto}
 section{display:none} section.active{display:block}
 input,select,button{background:#23242c;color:#e8e8ea;border:1px solid #3a3c46;
   border-radius:4px;padding:6px 8px;margin:2px;font-size:13px}
 button{cursor:pointer} button:hover{border-color:#7aa2ff}
 canvas{width:100%;height:180px;background:#0d0e12;border:1px solid #33353d;border-radius:4px}
 table{border-collapse:collapse;width:100%;font-family:ui-monospace,monospace;font-size:12px}
 td,th{border:1px solid #2c2e36;padding:3px 6px;text-align:left;word-break:break-all}
 .msg{color:#9ece6a}.lbl{color:#e0af68}.muted{color:#777;font-size:12px}
 .row{display:flex;gap:8px;flex-wrap:wrap;align-items:center;margin:8px 0}
</style></head><body>
<header><b>urh_tpu_torch</b>
<button class="tab active" data-t="interp">Interpretation</button>
<button class="tab" data-t="analysis">Analysis</button>
<button class="tab" data-t="generator">Generator</button>
<button class="tab" data-t="simulator">Simulator</button>
<button class="tab" data-t="device">Device</button>
</header><main>
<section id="interp" class="active">
 <div class="row"><input id="path" size="50" placeholder="/path/to/capture.complex">
  <button onclick="openSignal()">Open</button>
  <select id="signals" onchange="loadSignal()"></select>
  <button onclick="autodetect()">Auto detect</button>
  <button onclick="api('POST','/api/signal/'+sid()+'/undo').then(refreshSignal)">Undo</button></div>
 <canvas id="plot" width="1100" height="180"></canvas>
 <div class="row"><label><input type="checkbox" id="specshow" onchange="drawSpec()"> spectrogram</label>
  <select id="speccmap" onchange="drawSpec()"></select></div>
 <img id="spec" style="display:none;width:100%;border:1px solid #33353d;border-radius:4px">
 <div class="row" id="params"></div>
 <div class="row"><button onclick="demod()">Demodulate</button>
  <select id="iview"><option value="0">bits</option><option value="1">hex</option>
  <option value="2">ascii</option></select>
  <button onclick="api('POST','/api/analysis/add',{signal_id:sid()}).then(()=>say('sent to analysis'))">→ Analysis</button>
  <button onclick="api('POST','/api/generator/add',{signal_id:sid()}).then(()=>say('sent to generator'))">→ Generator</button></div>
 <table id="messages"></table>
</section>
<section id="analysis">
 <div class="row"><button onclick="loadRows()">Refresh</button>
  <select id="aview"><option value="0">bits</option><option value="1" selected>hex</option>
  <option value="2">ascii</option></select>
  <label><input type="checkbox" id="adec" checked> decoded</label>
  <select id="decodings"></select>
  <button onclick="setDecoding()">Apply decoding</button>
  <button onclick="runAwre()">Run AWRE</button></div>
 <div class="row"><span class="muted">Label:</span>
  <input id="lmsg" size="4" placeholder="msg#"><input id="lname" size="12" placeholder="name">
  <input id="lstart" size="5" placeholder="start"><input id="lend" size="5" placeholder="end">
  <button onclick="labelAct('create')">Create</button>
  <input id="lidx" size="4" placeholder="lbl#">
  <button onclick="labelAct('edit')">Edit</button>
  <button onclick="labelAct('delete')">Delete</button>
  <span class="muted">Cell:</span><input id="acrow" size="4" placeholder="row">
  <input id="accol" size="4" placeholder="col"><input id="acval" size="3" placeholder="val">
  <button onclick="cellEdit('analysis','ac',loadRows,'aview')">Set</button>
  <button onclick="api('POST','/api/analysis/undo',{action:'undo'}).then(r=>{say('undid: '+(r.redo_text||''));loadRows()})">Undo</button>
  <button onclick="api('POST','/api/analysis/undo',{action:'redo'}).then(()=>loadRows())">Redo</button></div>
 <div class="row"><span class="muted">Decoder editor:</span>
  <input id="dename" size="10" placeholder="name">
  <select id="deprims"></select>
  <button onclick="deAdd()">+ primitive</button>
  <input id="dechain" size="42" placeholder="chain (comma separated ops/params)">
  <input id="debits" size="18" placeholder="preview input bits">
  <button onclick="dePreview()">Preview</button>
  <button onclick="deSave()">Save</button></div>
 <div id="depreview" class="muted"></div>
 <div class="row"><span class="muted">Message type:</span>
  <input id="mtname" size="12" placeholder="name">
  <input id="mtrows" size="8" placeholder="rows 0,2">
  <button onclick="mtAct('create')">Create</button>
  <input id="mtidx" size="3" placeholder="#">
  <input id="mtrules" size="30" placeholder='rules [{"start":0,"end":7,"operator":"=","target_value":"10101010"}]'>
  <button onclick="mtAct('edit')">Apply rules</button>
  <button onclick="mtAct('delete')">Delete</button>
  <span class="muted">Checksum lbl:</span>
  <input id="ckmsg" size="3" placeholder="msg"><input id="cklbl" size="3" placeholder="lbl">
  <select id="ckfn"></select>
  <input id="ckranges" size="12" placeholder="[[64,96]]">
  <button onclick="ckApply()">Set CRC</button></div>
 <div id="mtypes" class="muted"></div>
 <table id="arows"></table>
</section>
<section id="generator">
 <div class="row"><button onclick="genTable()">Refresh</button>
  <button onclick="api('POST','/api/generator/fuzz',{mode:'successive'}).then(genTable)">Fuzz successive</button>
  <button onclick="api('POST','/api/generator/fuzz',{mode:'concurrent'}).then(genTable)">Fuzz concurrent</button>
  <input id="gpause" size="8" placeholder="pause">
  <button onclick="api('POST','/api/generator/pause',{pause:+gpause.value||0}).then(genTable)">Set pauses</button>
  <input id="gfile" size="30" placeholder="/tmp/out.complex">
  <button onclick="api('POST','/api/generator/generate',{filename:gfile.value}).then(r=>say('saved '+(r.saved||'')+' ('+r.samples+' samples)'))">Modulate &amp; save</button>
  <span class="muted">Cell:</span><input id="gcrow" size="4" placeholder="row">
  <input id="gccol" size="4" placeholder="col"><input id="gcval" size="3" placeholder="val">
  <button onclick="cellEdit('generator','gc',genTable,null)">Set</button>
  <button onclick="api('POST','/api/generator/undo',{action:'undo'}).then(()=>genTable())">Undo</button>
  <button onclick="api('POST','/api/generator/undo',{action:'redo'}).then(()=>genTable())">Redo</button>
  <button onclick="api('POST','/api/generator/clear').then(()=>genTable())">Clear</button></div>
 <div class="row"><span class="muted">Modulator:</span>
  <select id="modsel" onchange="modLoad()"></select>
  <button onclick="api('POST','/api/generator/modulator',{action:'create'}).then(modRefresh)">New</button>
  <select id="modtype"><option>ASK</option><option>FSK</option><option>PSK</option>
   <option>GFSK</option><option>OQPSK</option></select>
  <label class="muted">carrier <input id="modcar" size="8"></label>
  <label class="muted">sps <input id="modsps" size="5"></label>
  <label class="muted">bps <input id="modbps" size="2"></label>
  <label class="muted">params <input id="modpar" size="14"></label>
  <button onclick="modApply()">Apply</button>
  <span class="muted">assign row</span><input id="modrow" size="3">
  <button onclick="api('POST','/api/generator/message_modulator',
   {modulator_index:+$('#modsel').value,rows:$('#modrow').value?[+$('#modrow').value]:null})
   .then(r=>say('assigned '+r.modulator+' to rows '+r.rows))">Assign</button></div>
 <img id="modprev" style="display:none;border:1px solid #33353d;border-radius:4px">
 <div id="gstats" class="muted"></div>
 <table id="grows"></table>
</section>
<section id="simulator">
 <div class="row"><input id="simpath" size="50" placeholder="/path/to/profile.sim.xml">
  <button onclick="api('POST','/api/simulator/load',{path:simpath.value}).then(simItems)">Load profile</button>
  <button onclick="api('GET','/api/simulator/items').then(simItems)">Refresh</button>
  <button onclick="api('POST','/api/simulator/start',{}).then(r=>say('simulation running: '+r.running))">Start</button>
  <button onclick="api('POST','/api/simulator/stop').then(()=>say('simulation stopped'))">Stop</button>
  <button onclick="api('GET','/api/simulator/log').then(r=>{$('#simlog').textContent=(r.running?'[running]\n':'')+r.log.join('\n')})">Log</button></div>
 <div class="row"><span class="muted">New item:</span>
  <select id="sitype"><option>message</option><option>rule</option><option>condition</option>
   <option>goto</option><option>counter</option><option>sleep</option>
   <option>trigger</option><option>label</option></select>
  <input id="siparent" size="5" placeholder="parent">
  <input id="sibody" size="44" placeholder='fields JSON, e.g. {"bits":"1010","pause":1000}'>
  <button onclick="simItemAct('create')">Create</button>
  <span class="muted">Item:</span><input id="siidx" size="5" placeholder="index">
  <button onclick="simItemAct('edit')">Edit</button>
  <button onclick="simItemAct('delete')">Delete</button></div>
 <div class="row"><span class="muted">Participants:</span>
  <input id="spname" size="9" placeholder="name"><input id="spshort" size="3" placeholder="AB">
  <label class="muted"><input type="checkbox" id="spsim"> simulate</label>
  <button onclick="api('POST','/api/project/participants',{action:'create',name:$('#spname').value,
   shortname:$('#spshort').value,simulate:$('#spsim').checked})
   .then(r=>say('participants: '+r.participants.map(p=>p.name).join(', ')))">Add</button>
  <span class="muted">Formula:</span><input id="siformula" size="22" placeholder="item1.counter_value + 1">
  <button onclick="api('POST','/api/simulator/validate',{expression:$('#siformula').value})
   .then(r=>say(r.valid?'formula OK':'invalid formula'))">Validate</button>
  <input id="sisave" size="22" placeholder="/tmp/profile.sim.xml">
  <button onclick="api('POST','/api/simulator/save',{path:$('#sisave').value}).then(r=>say('saved '+r.saved))">Save</button>
  <button onclick="api('GET','/api/simulator/transcript').then(r=>{$('#simlog').textContent=r.transcript.join('\\n')})">Transcript</button></div>
 <table id="sitems"></table>
 <pre id="simlog" class="muted"></pre>
</section>
<section id="device">
 <div class="row"><select id="devsel"></select>
  <label class="muted">freq <input id="devfreq" size="10" value="433920000"></label>
  <label class="muted">rate <input id="devrate" size="9" value="1000000"></label>
  <label class="muted">gain <input id="devgain" size="4" value="20"></label>
  <select id="devbackend"><option>native</option><option>grc</option></select>
  <button onclick="api('POST','/api/device/backend',{device:$('#devsel').value,
   backend:$('#devbackend').value}).then(r=>say(r.device+' backend: '+r.selected_backend))">Set backend</button>
  <label class="muted"><input type="checkbox" id="devenabled" checked
   onchange="api('POST','/api/device/backend',{device:$('#devsel').value,enabled:$('#devenabled').checked})
   .then(r=>say(r.device+(r.enabled?' enabled':' disabled')))"> enabled</label></div>
 <div class="row"><span class="muted">Record:</span>
  <button onclick="devApi('record/start')">Start</button>
  <button onclick="devApi('record/stop',{},r=>say('recorded '+r.num_samples+' samples'))">Stop</button>
  <input id="recname" size="12" placeholder="signal name">
  <button onclick="api('POST','/api/device/record/save',{name:$('#recname').value||'recorded'})
   .then(s=>{say('saved as signal '+s.id);refreshList()})">→ Signal</button></div>
 <div class="row"><span class="muted">Send:</span>
  <select id="sendsig"></select>
  <label class="muted">repeats <input id="sendrep" size="3" value="1"></label>
  <label class="muted">port <input id="sendport" size="5" value="2222"></label>
  <button onclick="devApi('send/start',{signal_id:+$('#sendsig').value,repeats:+$('#sendrep').value,client_port:+$('#sendport').value})">TX signal</button>
  <button onclick="devApi('send/start',{source:'generator',repeats:+$('#sendrep').value,client_port:+$('#sendport').value})">TX generator</button>
  <button onclick="devApi('send/start',{continuous:true,repeats:+$('#sendrep').value,client_port:+$('#sendport').value})">TX continuous</button>
  <button onclick="api('GET','/api/device/send/status').then(r=>say(r.running?('sent '+r.current_index+'/'+r.total+(r.finished?' (finished)':'')):'sender idle'))">Status</button>
  <button onclick="devApi('send/stop')">Stop</button></div>
 <div class="row"><span class="muted">Spectrum:</span>
  <button onclick="devApi('spectrum/start',{},startSpectrum)">Start</button>
  <button onclick="stopSpectrum()">Stop</button>
  <input id="retune" size="10" placeholder="new freq Hz">
  <button onclick="api('POST','/api/device/spectrum/retune',{frequency:+$('#retune').value}).then(r=>say('tuned to '+r.frequency+' Hz'))">Retune</button></div>
 <canvas id="specan" width="1100" height="180"></canvas>
 <img id="waterfall" style="display:none;width:100%;border:1px solid #33353d;border-radius:4px">
 <div class="row"><span class="muted">Live sniff:</span>
  <label class="muted">sps <input id="snsps" size="5" value="100"></label>
  <label class="muted">center <input id="sncenter" size="6" value="0"></label>
  <label class="muted">noise <input id="snnoise" size="6" value="0.01"></label>
  <select id="snmod"><option>FSK</option><option>ASK</option><option>PSK</option></select>
  <button onclick="devApi('../sniffer/start',{samples_per_symbol:+$('#snsps').value,center:+$('#sncenter').value,noise:+$('#snnoise').value,modulation_type:$('#snmod').value},r=>{say('sniffing on port '+r.port);snPoll()})">Start</button>
  <button onclick="api('POST','/api/sniffer/stop').then(r=>say('sniffer stopped, '+r.messages+' messages'))">Stop</button>
  <button onclick="api('POST','/api/sniffer/to_analysis').then(r=>say(r.rows+' rows in analysis'))">→ Analysis</button></div>
 <table id="snrows"></table>
 <div class="row"><span class="muted">Options:</span>
  <label class="muted">sim timeout ms <input id="optto" size="6"></label>
  <label class="muted">retries <input id="optretry" size="3"></label>
  <label class="muted">broadcast <input id="optbc" size="5"></label>
  <select id="optdtype"><option>float32</option><option>int8</option><option>int16</option></select>
  <button onclick="optSave()">Apply</button></div>
</section>
<div id="status" class="muted" style="margin-top:12px"></div>
</main><script>
const $=q=>document.querySelector(q);
const say=t=>{$('#status').textContent=t};
function api(method,url,body){return fetch(url,{method,headers:{'Content-Type':'application/json'},
 body:body?JSON.stringify(body):undefined}).then(async r=>{const j=await r.json();
 if(j.error){say('error: '+j.error);throw j.error}return j})}
document.querySelectorAll('.tab').forEach(b=>b.onclick=()=>{
 document.querySelectorAll('.tab,section').forEach(e=>e.classList.remove('active'));
 b.classList.add('active');$('#'+b.dataset.t).classList.add('active')});
const sid=()=>+($('#signals').value||0);
function openSignal(){api('POST','/api/signal/open',{path:$('#path').value}).then(s=>{
 refreshList().then(()=>{$('#signals').value=s.id;loadSignal()})})}
function refreshList(){return api('GET','/api/state').then(st=>{
 $('#signals').innerHTML=st.signals.map(s=>`<option value="${s.id}">${s.name}</option>`).join('')})}
function loadSignal(){drawPlot();drawSpec();refreshSignal()}
function drawSpec(){const img=$('#spec');if(!$('#specshow').checked){img.style.display='none';return}
 img.style.display='block';
 img.src='/api/signal/'+sid()+'/spectrogram?colormap='+($('#speccmap').value||'magma')+'&t='+Date.now()}
api('GET','/api/colormaps').then(r=>{$('#speccmap').innerHTML=
 r.colormaps.map(c=>`<option${c==r.chosen?' selected':''}>${c}</option>`).join('')});
function labelAct(action){const body={action,message:+$('#lmsg').value||0,view:+$('#aview').value};
 if(action=='create'){body.start=+$('#lstart').value;body.end=+$('#lend').value;body.name=$('#lname').value}
 else{body.label=+$('#lidx').value;if($('#lname').value)body.name=$('#lname').value;
  if($('#lstart').value)body.start=+$('#lstart').value;if($('#lend').value)body.end=+$('#lend').value}
 api('POST','/api/analysis/label',body).then(r=>{say('labels on '+r.type+': '+
  r.labels.map(l=>l.name+'['+l.start+','+l.end+')').join(' '));loadRows()})}
function cellEdit(tab,prefix,refresh,viewSel){
 const body={row:+$('#'+prefix+'row').value||0,col:+$('#'+prefix+'col').value||0,
  value:$('#'+prefix+'val').value,view:viewSel?+$('#'+viewSel).value:0};
 api('POST','/api/'+tab+'/cell',body).then(r=>{say('row '+r.row+' -> '+r.data.slice(0,32)+'…');refresh()})}
function refreshSignal(){api('GET','/api/state').then(st=>{
 const s=st.signals[sid()];if(!s)return;
 $('#params').innerHTML=Object.entries(s.params).map(([k,v])=>
  `<label class="muted">${k} <input size="8" id="p_${k}" value="${v??''}"></label>`).join('')
  +'<button onclick="setParams()">Apply</button>'})}
function setParams(){const body={};document.querySelectorAll('[id^=p_]').forEach(i=>{
 const k=i.id.slice(2);body[k]=k=='modulation_type'?i.value:+i.value});
 api('POST','/api/signal/'+sid()+'/params',body).then(()=>{say('parameters set');demod()})}
function autodetect(){api('POST','/api/signal/'+sid()+'/autodetect').then(r=>{
 say('auto-detected');refreshSignal();demod()})}
function drawPlot(){api('GET','/api/signal/'+sid()+'/plot').then(p=>{
 const c=$('#plot'),ctx=c.getContext('2d');ctx.clearRect(0,0,c.width,c.height);
 if(!p.y.length)return;const ymin=Math.min(...p.y),ymax=Math.max(...p.y),pad=10;
 ctx.strokeStyle='#7aa2ff';ctx.beginPath();
 p.y.forEach((v,i)=>{const x=i/(p.y.length-1)*c.width;
  const y=c.height-pad-((v-ymin)/(ymax-ymin||1))*(c.height-2*pad);
  i?ctx.lineTo(x,y):ctx.moveTo(x,y)});ctx.stroke()})}
function demod(){api('GET','/api/signal/'+sid()+'/messages?view='+$('#iview').value)
 .then(r=>{$('#messages').innerHTML=r.messages.map((m,i)=>
  `<tr><td class="muted">${i}</td><td class="msg">${m}</td></tr>`).join('');
  say(r.messages.length+' message(s)')})}
function loadRows(){api('GET','/api/analysis/rows?view='+$('#aview').value+
 '&decoded='+($('#adec').checked?1:0)).then(r=>{
 $('#arows').innerHTML=r.rows.map((row,i)=>`<tr><td class="muted">${i}</td>
  <td class="lbl">${row.type}</td><td class="msg">${row.data}</td>
  <td class="muted">${row.labels.map(l=>l.name+'['+l.start+','+l.end+')').join(' ')}</td></tr>`).join('')});
 api('GET','/api/analysis/decodings').then(r=>{
 $('#decodings').innerHTML=r.decodings.map((d,i)=>`<option value="${i}">${d}</option>`).join('')})}
function setDecoding(){api('POST','/api/analysis/decoding',
 {decoding_index:+$('#decodings').value}).then(r=>{say('decoding: '+r.decoding);loadRows()})}
function runAwre(){say('running AWRE…');api('POST','/api/analysis/awre').then(r=>{
 $('#mtypes').textContent=r.message_types.map(t=>t.name+': '+
  t.labels.map(l=>l.name).join(', ')).join(' | ')||'no fields found';loadRows()})}
function genTable(){api('GET','/api/generator/table').then(r=>{
 $('#gstats').textContent=r.rows.length+' messages, '+r.total_samples+
  ' samples, ~'+r.estimated_time_s.toFixed(3)+' s on air';
 $('#grows').innerHTML=r.rows.map((row,i)=>`<tr><td class="muted">${i}</td>
  <td class="msg">${row.data}</td><td class="muted">${row.pause}</td></tr>`).join('')})}
function simItems(r){(r&&r.items?Promise.resolve(r):api('GET','/api/simulator/items'))
 .then(r=>{$('#sitems').innerHTML=r.items.map(it=>`<tr><td class="muted">${it.index}</td>
  <td class="lbl">${it.type}</td><td>${it.label}</td></tr>`).join('')})}
function simItemAct(action){let body={};try{body=$('#sibody').value?JSON.parse($('#sibody').value):{}}
 catch(e){say('bad fields JSON');return}
 body.action=action;
 if(action=='create'){body.type=$('#sitype').value;
  if($('#siparent').value)body.parent=$('#siparent').value}
 else body.item=$('#siidx').value;
 api('POST','/api/simulator/item',body).then(r=>{say(action+' ok'+(r.index?' (item '+r.index+')':''));simItems()})}
let mods=[];
function modRefresh(){return api('GET','/api/generator/modulators').then(r=>{mods=r.modulators;
 $('#modsel').innerHTML=mods.map(m=>`<option value="${m.index}">${m.name}</option>`).join('');modLoad()})}
function modLoad(){const m=mods[+$('#modsel').value];if(!m)return;
 $('#modtype').value=m.modulation_type;$('#modcar').value=m.carrier_freq_hz;
 $('#modsps').value=m.samples_per_symbol;$('#modbps').value=m.bits_per_symbol;
 $('#modpar').value=m.parameters.join(',');modPrev()}
function modPrev(){const img=$('#modprev');img.style.display='block';
 img.src='/api/generator/modulator_preview?index='+(+$('#modsel').value)+'&t='+Date.now()}
function modApply(){api('POST','/api/generator/modulator',
 {action:'edit',index:+$('#modsel').value,modulation_type:$('#modtype').value,
  carrier_freq_hz:+$('#modcar').value,samples_per_symbol:+$('#modsps').value,
  bits_per_symbol:+$('#modbps').value,
  parameters:$('#modpar').value.split(',').map(Number)})
 .then(()=>{say('modulator updated');modRefresh();genTable()})}
document.querySelector('[data-t=generator]').addEventListener('click',modRefresh);
function mtAct(action){const body={action};
 if(action=='create'){body.name=$('#mtname').value;
  if($('#mtrows').value)body.rows=$('#mtrows').value.split(',').map(Number)}
 else{body.index=+$('#mtidx').value;
  if(action=='edit'){if($('#mtname').value)body.name=$('#mtname').value;
   if($('#mtrows').value)body.rows=$('#mtrows').value.split(',').map(Number);
   if($('#mtrules').value){try{body.ruleset={mode:'all_apply',rules:JSON.parse($('#mtrules').value)};
    body.assigned_by_ruleset=true}catch(e){say('bad rules JSON');return}}}}
 api('POST','/api/analysis/message_type',body).then(r=>{
  say(action+' ok'+(r.name?' ('+r.name+')':''));loadRows();
  api('GET','/api/analysis/message_types').then(t=>{$('#mtypes').textContent=
   t.message_types.map(m=>m.index+': '+m.name+' ['+m.messages.join(',')+']').join(' | ')})})}
function ckApply(){let ranges=null;
 try{ranges=$('#ckranges').value?JSON.parse($('#ckranges').value):null}
 catch(e){say('bad ranges JSON');return}
 const body={message:+$('#ckmsg').value||0,label:+$('#cklbl').value||0};
 if($('#ckfn').value)body.crc_function=$('#ckfn').value;
 if(ranges)body.data_ranges=ranges;
 api('POST','/api/analysis/checksum_label',body).then(r=>
  say('checksum '+(r.checksum_ok?'OK':'MISMATCH')+' poly 0x'+r.polynomial_hex))}
$('#ckfn').innerHTML=['','8_standard','16_standard','16_ccitt','16_dnp','8_ccitt','CC1101']
 .map(n=>`<option>${n}</option>`).join('');
const deChain=()=>$('#dechain').value.split(',').map(s=>s.trim()).filter(s=>s);
function deAdd(){const o=$('#deprims').selectedOptions[0];if(!o)return;
 const parts=[o.value];if(o.dataset.param)parts.push(o.dataset.param);
 $('#dechain').value=($('#dechain').value?$('#dechain').value+', ':'')+parts.join(', ')}
function dePreview(){api('POST','/api/decoding/preview',
 {chain:deChain(),input:$('#debits').value}).then(r=>{$('#depreview').textContent=
 'decoded: '+r.decoded+' (hex '+r.decoded_hex+') errors: '+r.errors+' state: '+r.state})}
function deSave(){api('POST','/api/decoding/save',
 {name:$('#dename').value,chain:deChain()}).then(r=>{say('saved; decodings: '+
 r.decodings.join(', '));loadRows()})}
api('GET','/api/decoding/primitives').then(r=>{$('#deprims').innerHTML=
 r.primitives.map(p=>`<option value="${p.name}" data-param="${p.param_default||''}">${p.name}</option>`).join('')});
function devBody(extra){return Object.assign({device:$('#devsel').value||'Network SDR',
 frequency:+$('#devfreq').value,sample_rate:+$('#devrate').value,gain:+$('#devgain').value},extra||{})}
function devApi(op,extra,then){api('POST','/api/device/'+op,devBody(extra))
 .then(r=>{(then||(x=>say(op+': '+JSON.stringify(x))))(r)})}
let specTimer=null;
function startSpectrum(r){say('spectrum running on port '+(r.port||''));
 if(specTimer)clearInterval(specTimer);
 specTimer=setInterval(()=>{api('GET','/api/device/spectrum/frame').then(f=>{
  const c=$('#specan'),ctx=c.getContext('2d');ctx.clearRect(0,0,c.width,c.height);
  const m=f.magnitudes;if(!m.length)return;const mx=Math.max(...m,1e-9);
  ctx.strokeStyle='#9ece6a';ctx.beginPath();
  m.forEach((v,i)=>{const x=i/(m.length-1)*c.width,y=c.height-4-(v/mx)*(c.height-8);
   i?ctx.lineTo(x,y):ctx.moveTo(x,y)});ctx.stroke();
  const w=$('#waterfall');w.style.display='block';
  w.src='/api/device/spectrum/waterfall?t='+Date.now()}).catch(()=>{})},500)}
function stopSpectrum(){if(specTimer){clearInterval(specTimer);specTimer=null}
 api('POST','/api/device/spectrum/stop').then(()=>say('spectrum stopped'))}
let snTimer=null;
function snPoll(){if(snTimer)clearInterval(snTimer);
 snTimer=setInterval(()=>{api('GET','/api/sniffer/messages?view=0').then(r=>{
  $('#snrows').innerHTML=r.messages.map((m,i)=>`<tr><td class="muted">${i}</td>
   <td class="msg">${m}</td></tr>`).join('');
  if(!r.running&&snTimer){clearInterval(snTimer);snTimer=null}}).catch(()=>{})},500)}
function optLoad(){api('GET','/api/project/settings').then(s=>{
 $('#optto').value=s.simulator_timeout_ms;$('#optretry').value=s.simulator_retries;
 $('#optbc').value=s.broadcast_address_hex;$('#optdtype').value=s.modulation_dtype})}
function optSave(){api('POST','/api/project/settings',
 {simulator_timeout_ms:+$('#optto').value,simulator_retries:+$('#optretry').value,
  broadcast_address_hex:$('#optbc').value,modulation_dtype:$('#optdtype').value})
 .then(()=>say('options applied'))}
document.querySelector('[data-t=device]').addEventListener('click',optLoad);
api('GET','/api/device/list').then(r=>{$('#devsel').innerHTML=
 r.devices.map(d=>`<option${d.name=='Network SDR'?' selected':''}>${d.name}</option>`).join('')});
function refreshSendList(){api('GET','/api/state').then(st=>{
 $('#sendsig').innerHTML=st.signals.map(s=>`<option value="${s.id}">${s.name}</option>`).join('')})}
document.querySelector('[data-t=device]').addEventListener('click',refreshSendList);
refreshList();
</script></body></html>
"""


def main(argv=None):
    """``urh_tpu_torch-web``: serve on ``--device``, else on the device
    URH_TPU_TORCH_DEVICE names, else on the CUDA card; an unknown value
    raises ValueError, as the CLI's does."""
    import argparse

    from urh_tpu_torch.cli.main import DEVICE_ENV, compute_device, device_name

    parser = argparse.ArgumentParser(description="urh_tpu_torch interactive web UI")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8087)
    parser.add_argument("--project", default="")
    parser.add_argument("--device", default=None,
                        help="torch device the routes compute on: cpu, cuda, cuda:N or "
                             f"auto (default: {DEVICE_ENV}, else the CUDA card)")
    args = parser.parse_args(argv)
    device = (device_name(args.device, "--device") if args.device is not None
              else compute_device())
    serve(host=args.host, port=args.port, project_path=args.project, device=device)


if __name__ == "__main__":
    main()
