"""``paddle.distributed`` of the port (ports ``paddle_tpu/distributed/``):
so far the single-device MoE dispatch, ``distributed.moe``."""
