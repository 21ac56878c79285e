"""Native (C++) host-side helpers of the TaskLoader, loaded with ctypes."""
