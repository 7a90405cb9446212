"""Native (C++) runtime components: GIL-free IO data plane.

The DSP math runs on the CUDA card; the host-side runtime around it —
sample transport, ring buffering, and the stream's host route — has
native C++ implementations here, the same sources as urh_tpu's
(``urh_tpu/native/src``).  Builds on demand with g++ into
``build/urh_tpu_torch/native/`` and binds through ctypes (no pybind11
dependency).
"""

from urh_tpu_torch.native.build import get_library, is_available
from urh_tpu_torch.native.ringbuffer import NativeRingBuffer
from urh_tpu_torch.native.net_io import NativeSampleReceiver, native_send_samples

__all__ = ["get_library", "is_available", "NativeRingBuffer",
           "NativeSampleReceiver", "native_send_samples"]
