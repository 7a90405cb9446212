"""Spectrogram colormaps (host copy of urh_tpu.util.colormaps).

The chosen map is read from and written to the settings store, urh_tpu's
file, under urh_tpu's key ``spectrogram_colormap``.
The reference ships matplotlib-derived 256-entry tables
(urh/colormaps.py, 1,077 LoC of data).  Here the maps are generated
procedurally from a small set of perceptual anchor colors with linear
interpolation — same API surface (BGRA uint8 tables for image
rendering).
"""

from __future__ import annotations

import numpy as np

# anchor colors (R, G, B) in [0, 1], perceptually spaced dark -> bright
_ANCHORS = {
    "magma": [
        (0.001, 0.000, 0.014), (0.079, 0.054, 0.211), (0.232, 0.060, 0.438),
        (0.390, 0.100, 0.501), (0.550, 0.161, 0.506), (0.716, 0.215, 0.475),
        (0.869, 0.288, 0.409), (0.967, 0.439, 0.359), (0.995, 0.624, 0.427),
        (0.997, 0.796, 0.572), (0.987, 0.991, 0.750),
    ],
    "viridis": [
        (0.267, 0.005, 0.329), (0.283, 0.141, 0.458), (0.254, 0.265, 0.530),
        (0.207, 0.372, 0.553), (0.164, 0.471, 0.558), (0.128, 0.567, 0.551),
        (0.135, 0.659, 0.518), (0.267, 0.749, 0.441), (0.478, 0.821, 0.318),
        (0.741, 0.873, 0.150), (0.993, 0.906, 0.144),
    ],
    "inferno": [
        (0.001, 0.000, 0.014), (0.087, 0.044, 0.224), (0.258, 0.039, 0.406),
        (0.416, 0.090, 0.433), (0.578, 0.148, 0.404), (0.735, 0.215, 0.330),
        (0.866, 0.317, 0.226), (0.954, 0.462, 0.110), (0.988, 0.645, 0.040),
        (0.965, 0.844, 0.273), (0.988, 1.000, 0.645),
    ],
    "plasma": [
        (0.050, 0.030, 0.528), (0.255, 0.014, 0.615), (0.418, 0.001, 0.658),
        (0.563, 0.052, 0.642), (0.693, 0.165, 0.565), (0.798, 0.280, 0.470),
        (0.881, 0.393, 0.383), (0.949, 0.518, 0.296), (0.988, 0.652, 0.211),
        (0.989, 0.810, 0.145), (0.940, 0.975, 0.131),
    ],
    "grayscale": [(0.0, 0.0, 0.0), (1.0, 1.0, 1.0)],
}

# matplotlib (when importable) provides the exact 256-entry tables the
# reference embedded as data; the anchors above are the fallback
_MPL_NAMES = {"magma": "magma", "viridis": "viridis", "inferno": "inferno",
              "plasma": "plasma", "grayscale": "gray"}


def calculate_colormap(name: str, n: int = 256) -> np.ndarray:
    """(n, 3) float RGB table: matplotlib's exact map when available,
    else linear interpolation of the perceptual anchors."""
    try:
        from matplotlib import colormaps as _mpl

        cmap = _mpl[_MPL_NAMES[name]]
        return np.asarray(cmap(np.linspace(0.0, 1.0, n)))[:, :3]
    except Exception:
        pass
    anchors = np.array(_ANCHORS[name])
    x_anchor = np.linspace(0, 1, len(anchors))
    x = np.linspace(0, 1, n)
    return np.stack(
        [np.interp(x, x_anchor, anchors[:, c]) for c in range(3)], axis=1
    )


def calculate_numpy_brga_for(name: str, n: int = 256) -> np.ndarray:
    """(n, 4) uint8 BGRA table."""
    rgb = calculate_colormap(name, n)
    out = np.empty((n, 4), dtype=np.uint8)
    out[:, 0] = (rgb[:, 2] * 255).astype(np.uint8)  # B
    out[:, 1] = (rgb[:, 1] * 255).astype(np.uint8)  # G
    out[:, 2] = (rgb[:, 0] * 255).astype(np.uint8)  # R
    out[:, 3] = 255
    return out


maps = {name: calculate_colormap(name) for name in _ANCHORS}
available_colormaps = list(_ANCHORS.keys())

default_colormap = "plasma"  # reference default (urh/colormaps.py:1041)
chosen_colormap_name = default_colormap
chosen_colormap_numpy_bgra = calculate_numpy_brga_for(chosen_colormap_name)


def choose_colormap(name: str):
    global chosen_colormap_name, chosen_colormap_numpy_bgra
    if name in _ANCHORS:
        chosen_colormap_name = name
        chosen_colormap_numpy_bgra = calculate_numpy_brga_for(name)


def read_selected_colormap_name_from_settings() -> str:
    from urh_tpu_torch.util import settings

    name = settings.read("spectrogram_colormap", default_colormap, str)
    return name if name in _ANCHORS else default_colormap


def write_selected_colormap_to_settings(colormap_name: str):
    from urh_tpu_torch.util import settings

    settings.write("spectrogram_colormap", colormap_name)


def load_colormap_from_settings():
    choose_colormap(read_selected_colormap_name_from_settings())
