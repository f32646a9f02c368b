"""The HEVC encoder: the port's copy of libhm_tpu/encoder, whose in-loop
deblocking and SAO run through the loop-filter kernel (K3 + K4) on the
encoder's device (encoder.py, parallel/device_filters.filter_picture)."""
