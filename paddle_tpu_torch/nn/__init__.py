"""Layers and functions of the port's ``paddle.nn`` surface; so far the
weight-only quantization helpers the serving engine needs (``quant``)
and ``flashmask_attention`` (``functional_extra2``)."""
