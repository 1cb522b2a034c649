"""Native dataset runtime: a C++ PNG decoder with a prefetching worker pool,
bound with ctypes (``runtime/loader.cpp``)."""

from boslam_tpu_torch.runtime.native import NativeLoader, available, decode_frame

__all__ = ["NativeLoader", "available", "decode_frame"]
