"""Host runtime helpers of the engine (the port of ``reforge_tpu/runtime/``)."""
