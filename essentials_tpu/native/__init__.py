"""Native (C++) components, loaded via ctypes.

Reference parity: the reference's native IO layer (vendored mmio.c,
/root/reference/include/gunrock/io/detail/mmio.cpp). Build with
`make -C essentials_tpu/native` (built on first use when absent);
if the shared library is absent, callers fall back to the NumPy paths.
"""

from essentials_tpu.native import mmio_native

__all__ = ["mmio_native"]
