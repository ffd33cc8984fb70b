"""The port's device code: the segment decoder and its variants, the probe
kernels, their builds (``build.py``) and the device CRC."""
