"""FFT-domain continuous Haar wavelet transform (PyTorch port of
urh_tpu.ai.wavelet).

Used by modulation classification.  Same math as the reference
(urh/ainterpretation/Wavelet.py:7-43, after Torrence & Compo, "A practical
guide to wavelet analysis"): the CWT is an inverse FFT of the signal
spectrum multiplied with the scaled wavelet spectrum.  The spectrum is
computed in float64 NumPy, as urh_tpu computes it, and cast to the signal's
complex type; the FFTs are ``torch.fft`` on the signal's device.  The
batched form that classification runs is urh_tpu_torch.ai.device.cwt_haar.
"""

from __future__ import annotations

import numpy as np
import torch

_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


def angular_frequencies(n: int) -> np.ndarray:
    """Torrence & Compo's omega_k grid: positive for k < n/2, the NEGATED
    index (not fftfreq's wrapped value) above."""
    k = np.arange(n, dtype=np.float64)
    return (2.0 * np.pi / n) * np.where(k < n // 2, k, -k)


def scaled_haar_spectrum(omega: np.ndarray, scale: int) -> np.ndarray:
    """Fourier transform of the Haar mother wavelet evaluated at
    scale*omega, normalized per T&C eq. 6."""
    arg = scale * omega
    denominator = np.where(omega == 0.0, 1.0, omega)  # omega[0] only
    shape = 1j * np.square(np.exp(0.5j * arg) - 1.0) / denominator
    return np.sqrt(2.0 * np.pi * scale) * shape


def cwt_haar(x: torch.Tensor, scale: int = 10) -> torch.Tensor:
    """Continuous Haar wavelet transform of a 1-D complex tensor (truncated
    to its power-of-two floor); the 2*scale cone-of-influence samples are
    trimmed from both ends."""
    n = 2 ** int(np.log2(len(x)))
    x = x[:n]
    psi = scaled_haar_spectrum(angular_frequencies(n), scale).astype(_COMPLEX[x.dtype])
    spectrum = torch.fft.fft(x) * torch.from_numpy(psi).to(x.device)
    return torch.fft.ifft(spectrum)[2 * scale: -2 * scale]


def normalized_haar_wavelet(omega: np.ndarray, scale: int) -> np.ndarray:
    """Reference-named helper (Wavelet.py:7-14): wavelet shape without the
    sqrt(2*pi*scale) normalization, taking pre-scaled omega."""
    return scaled_haar_spectrum(omega / scale, scale) / np.sqrt(2.0 * np.pi * scale)
