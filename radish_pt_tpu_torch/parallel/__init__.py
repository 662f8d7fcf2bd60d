"""Multi-device and multi-process rendering (port of ``radish_pt_tpu.parallel``)."""
