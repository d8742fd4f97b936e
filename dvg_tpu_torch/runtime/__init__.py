"""Host-side native code of the port (counterpart of `dvg_tpu/runtime`):
`fastload`, the threaded PNG/JPEG frame decoder behind ctypes, built from
`runtime/native/fastload.cpp` at first use."""
