"""``paddle.incubate`` of the port: ``incubate.nn.functional``'s fused
ops (ports ``paddle_tpu/incubate/``)."""
