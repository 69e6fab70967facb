"""Quantization of the port: ``int8.py`` (numpy only, the port's own copy of
``hdrtv_tpu/quant/int8.py``), ``calibrate.py`` (PTQ activation scales from
forwards of the natural-layout program), ``qat.py`` (straight-through fake
quantization and the teacher-distilled fine-tune) and ``mixed.py`` (the
per-layer sensitivity probe that writes a mixed W8A8 layout)."""
