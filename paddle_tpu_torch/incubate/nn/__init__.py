"""``paddle.incubate.nn`` of the port (ports ``paddle_tpu/incubate/nn/``):
so far ``functional.fused_rms_norm``."""
