"""Quantization helpers of the port (numpy only): the port's own copy of
``hdrtv_tpu/quant/int8.py``. Calibration (``quant/calibrate.py``), which runs
the natural-layout forward, is still to port (ROADMAP.md Queue 1 item 12)."""
