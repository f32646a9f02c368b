"""Copy of libhm_tpu.hostdec, the host half of the decoder (parse, control
plane, boundary-strength maps), so that the port imports nothing of the
JAX package.  Each module names its source on its first line.
"""
