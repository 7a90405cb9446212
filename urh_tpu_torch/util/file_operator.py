"""File save/load helpers (host copy of urh_tpu.util.file_operator, the
headless parts of urh/util/FileOperator.py)."""

from __future__ import annotations

import os
import tarfile
import zipfile

SIGNAL_FILE_EXTENSIONS_BY_TYPE = {
    "complex": (".complex", ".cfile"),
    "complex16u": (".complex16u", ".cu8"),
    "complex16s": (".complex16s", ".cs8"),
    "complex32u": (".complex32u", ".cu16"),
    "complex32s": (".complex32s", ".cs16"),
    "wav": (".wav",),
    "sub": (".sub",),
    "compressed": (".coco",),
}

PROTOCOL_FILE_EXTENSION = ".proto.xml"
FUZZING_FILE_EXTENSION = ".fuzz.xml"
SIMULATOR_FILE_EXTENSION = ".sim.xml"


def get_open_filename_filters() -> list:
    exts = [e for group in SIGNAL_FILE_EXTENSIONS_BY_TYPE.values() for e in group]
    return exts + [PROTOCOL_FILE_EXTENSION, FUZZING_FILE_EXTENSION,
                   SIMULATOR_FILE_EXTENSION, ".txt", ".csv", ".pcap", ".pcapng"]


def save_signal(signal, filename: str = None):
    filename = filename or signal.filename
    signal.save_as(filename)
    return filename


def save_data(data, filename: str, sample_rate=1e6, num_channels=2):
    """Save samples by extension: .wav / .coco / .sub / raw
    (FileOperator.py:185-196)."""
    if isinstance(data, bytes):
        with open(filename, "wb") as f:
            f.write(data)
        return

    from urh_tpu_torch.core.iq import IQData

    if not isinstance(data, IQData):
        data = IQData(data)
    if filename.endswith(".wav"):
        data.export_to_wav(filename, num_channels, sample_rate)
    elif filename.endswith(".coco"):
        data.save_compressed(filename)
    elif filename.endswith(".sub"):
        data.export_to_sub(filename)
    else:
        data.tofile(filename)


def uncompress_archives(file_names, temp_dir: str) -> list:
    """Extract .tar/.zip archives to a temp dir; other files pass through
    (FileOperator.uncompress_archives counterpart)."""
    result = []
    for filename in file_names:
        if filename.endswith((".tar", ".tar.gz", ".tar.bz2")):
            with tarfile.open(filename) as tar:
                tar.extractall(path=temp_dir, filter="data")
                for member in tar.getmembers():
                    result.append(os.path.join(temp_dir, member.name))
        elif filename.endswith(".zip"):
            with zipfile.ZipFile(filename) as zf:
                zf.extractall(path=temp_dir)
                result.extend(os.path.join(temp_dir, name) for name in zf.namelist())
        else:
            result.append(filename)
    return result


def get_name_from_filename(filename: str) -> str:
    if not isinstance(filename, str):
        return "No Name"
    return os.path.splitext(os.path.basename(filename))[0]
