"""The LayerSkip training recipe (port of ``layerskip_tpu/training``)."""
